"""main of the PyTorch port (see camc2v_tpu_torch/__init__.py): the fit loop."""
