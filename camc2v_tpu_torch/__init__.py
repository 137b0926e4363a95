"""PyTorch + CUDA port of camc2v_tpu for NVIDIA Hopper (H100).

The JAX package `camc2v_tpu` stays the reference; this package mirrors its
module names (`core/`, `nn/`, `ops/`, `models/`, `utils/`) and its
channels-last layout: videos are (B, T, H, W, C), tokens (B, L, D).

The port imports `torch` only. Each TPU Pallas kernel on the ported path has
a hand-written CUDA kernel under `csrc/`, built with nvcc at first use
(`ops/_build.py`) and bound with ctypes; every kernel has a plain PyTorch
twin beside it that the CPU runs.
"""


def configure_numerics() -> None:
    """Pin the card's matmul numerics to the JAX bf16 path: no TF32 for f32
    matmuls and convolutions, and f32 accumulation inside bf16 matmuls."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
