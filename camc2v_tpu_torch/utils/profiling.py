"""Profiling and determinism utilities (`camc2v_tpu/utils/profiling.py`).

`trace(logdir)` records the block with `torch.profiler` (CPU and, where
there is a card, CUDA activity) and writes a Chrome trace into `logdir`;
`annotate(name)` names a region in that trace (`record_function`).
`seed_everything` seeds the host's RNGs (the reference's
`seed_everything(seed + rank)`); torch randomness in the port is drawn from
explicit generators.
"""

from __future__ import annotations

import contextlib
import os
import random
import time
from typing import Iterator, Optional

import numpy as np


def seed_everything(seed: int, rank: int = 0) -> int:
    """Deterministic seeding across python/numpy (+ per-rank offset)."""
    s = seed + rank
    random.seed(s)
    np.random.seed(s % 2**32)
    os.environ["PYTHONHASHSEED"] = str(s)
    return s


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True) -> Iterator[None]:
    """torch.profiler over the block -> `<logdir>/trace_<pid>.json` (Chrome
    trace format)."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


@contextlib.contextmanager
def timed(name: str, sink: Optional[dict] = None) -> Iterator[None]:
    """Wall-time a block; optionally record into a dict."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if sink is not None:
            sink[name] = sink.get(name, 0.0) + dt


def annotate(name: str):
    """A profiler-visible region name (`torch.profiler.record_function`)."""
    import torch

    return torch.profiler.record_function(name)
