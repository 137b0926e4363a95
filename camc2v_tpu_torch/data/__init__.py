"""Host-side data path of the port: video decode, the CLIP tokenizer and the
RealEstate10K dataset (copies of `camc2v_tpu/data/`; batches stay numpy)."""
