"""The tiling of the Hopper GEMM core that K3 and K4 run on
(`csrc/gemm_hopper.cuh`), and the wrappers' plan for its out GEMM (K4's
GEMM 2, K3's out-projection): the columns of a tile and the split of K.

A tile is BLOCK_M rows by the epilogue's columns; the ring streams K in
stages of BLOCK_K. The out GEMM takes 160 columns a tile where 160 divides
the output width (C = 320, 640, 1280), else 128 with the last tile ragged.
Where its tiles fill less than half the SMs and K is long (K4's GEMM 2 over
the 4C hidden layer at the deep levels at batch 1: 16 tiles at the 4 x 4
middle block), the wrapper splits K into 2, 4 or 8 parts: each part writes
f32 partial sums to a workspace the wrapper allocates, and a reduce pass
adds them with the bias and the residual.
"""

from __future__ import annotations

import functools

import torch

BLOCK_M = 128            # rows of an output tile (BM): two consumer warpgroups of 64
BLOCK_K = 64             # k-columns of a ring stage (BK)
OUT_TILES = (160, 128)   # out-GEMM tile columns: OUT_WIDE where it divides n, else OUT_NARROW
OUT_STAGES = 4           # the out GEMM's ring depth (the source's default)
MAX_SPLITS = 8           # the most parts K is split into
MIN_PART_STEPS = 16      # the fewest k-stages a part keeps: shorter parts cost more than the reduce saves


def out_tile(n: int) -> int:
    """Columns of an out-GEMM tile over n output columns."""
    wide, narrow = OUT_TILES
    return wide if n % wide == 0 else narrow


def out_splits(rows: int, n: int, k: int, sms: int) -> int:
    """Parts K is split into for an out GEMM (rows, k) @ (n, k)^T on `sms`
    SMs: doubled while the tiles times the parts fill at most half the SMs
    and each part keeps whole stages, at least MIN_PART_STEPS of them."""
    tiles = -(-rows // BLOCK_M) * -(-n // out_tile(n))
    steps = k // BLOCK_K
    s = 1
    while s < MAX_SPLITS and 2 * tiles * s <= sms and steps % (2 * s) == 0 and steps // (2 * s) >= MIN_PART_STEPS:
        s *= 2
    return s


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def workspace(splits: int, rows: int, n: int, device: torch.device):
    """The split parts' f32 sums (splits, rows, n), or None for one part."""
    return torch.empty(splits, rows, n, device=device, dtype=torch.float32) if splits > 1 else None
