"""Evaluation of generated videos (`camc2v_tpu/eval/`): frame metrics on the
device, the I3D feature network and Fréchet distance for FVD, COLMAP/GLOMAP
camera-pose recovery and the RotErr / TransErr / CamMC metrics."""
