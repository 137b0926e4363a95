"""Checkpoints of a training run (`camc2v_tpu/utils/checkpoint.py`, on
`torch.save` / `torch.load` in place of orbax).

One file per saved step, `<ckpt_dir>/step_<step:08d>.pt`, written to a
temporary name and renamed, so a run killed mid-save leaves the previous
checkpoints whole. It holds what a run needs to go on bit for bit:
the trainable parameters' fp32 masters by name, AdamW's state, the EMA, the
running mean `acc_grads` of an open accumulation window, `step` (micro-steps)
and `updates` (optimizer steps). The frozen weights are not saved: a run
makes them again from its seed or the pretrained checkpoint it starts from.
`max_to_keep` keeps the newest files only.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

_NAME = re.compile(r"^step_(\d{8})\.pt$")


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.pt")


def saved_steps(ckpt_dir: str) -> list[int]:
    """The steps saved under `ckpt_dir`, oldest first."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(ckpt_dir)) if m)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = saved_steps(ckpt_dir)
    return steps[-1] if steps else None


def state_dict(state) -> dict:
    """The saved fields of a `parallel.trainer.TrainState`."""
    return {
        "names": list(state.names),
        "params": {n: p.detach() for n, p in zip(state.names, state.params)},
        "optimizer": state.optimizer.state_dict(),
        "acc_grads": {n: a for n, a in zip(state.names, state.acc_grads)},
        "ema_params": state.ema_params,
        "step": int(state.step),
        "updates": int(state.updates),
    }


def save_checkpoint(ckpt_dir: str, state, step: int, max_to_keep: Optional[int] = None) -> str:
    """Write `state` as step `step`; returns the file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, step)
    tmp = path + ".tmp"
    torch.save(state_dict(state), tmp)
    os.replace(tmp, path)
    if max_to_keep:
        for old in saved_steps(ckpt_dir)[:-max_to_keep]:
            os.remove(checkpoint_path(ckpt_dir, old))
    return path


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, state, step: Optional[int] = None):
    """Load step `step` (the latest without one) into `state` in place: the
    masters, optimizer state, accumulated gradients and EMA keep their
    tensors and devices. Returns `state`."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    saved = torch.load(checkpoint_path(ckpt_dir, step), map_location="cpu", weights_only=True)
    if saved["names"] != list(state.names):
        raise ValueError(f"checkpoint step {step}: its trainable parameters differ from the run's "
                         f"({len(saved['names'])} vs {len(state.names)})")
    for name, p, acc in zip(state.names, state.params, state.acc_grads):
        p.copy_(saved["params"][name])
        acc.copy_(saved["acc_grads"][name])
    state.optimizer.load_state_dict(saved["optimizer"])
    if (saved["ema_params"] is None) != (state.ema_params is None):
        raise ValueError(f"checkpoint step {step}: EMA {'absent' if saved['ema_params'] is None else 'present'}, "
                         "the run's the other way")
    if state.ema_params is not None:
        for name, v in saved["ema_params"].items():
            state.ema_params[name].copy_(v)
    state.step, state.updates = int(saved["step"]), int(saved["updates"])
    return state
