"""One-device trainer: train state, optimizer, train step
(`camc2v_tpu/parallel/trainer.py`, without the mesh; reference
CamContextI2V/main/trainer.py:47-194, model/base.py:71-110,
configs/models/camcontexti2v_256.yaml:203-220).

  * AdamW (`torch.optim.AdamW`: lr 1e-4, wd 1e-2, betas 0.9/0.999, eps 1e-8)
    over a regex-selected trainable subset (`param_labels`), fp32 masters;
    frozen Dense/Conv weights stored in `frozen_param_dtype` with
    `requires_grad=False`, so no weight gradient is formed for them;
  * the optax chain's order: each micro-step's gradients join a running mean
    (optax.MultiSteps), and every `accumulate_grad_batches` micro-steps the
    mean is clipped to global norm `grad_clip` (optax.clip_by_global_norm)
    and AdamW takes one step at the schedule's rate for its update count;
  * optional EMA of the trainable parameters, updated every micro-step.

The step counter counts micro-steps, as the JAX `TrainState.step` does. Each
micro-step (`loss_and_grads`) draws from a generator seeded by (seed, step),
the JAX `fold_in(rng, step)`, and seeds the global RNG the same way inside
`torch.random.fork_rng` for the UNet's dropout, so the caller's RNG state is
left as it was.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Optional

import torch
from torch import nn

from camc2v_tpu_torch.core import ema as ema_lib
from camc2v_tpu_torch.nn.layers import Conv, Dense


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX TrainConfig's fields, less `shard_params` (no mesh here)."""

    learning_rate: float = 1e-4
    # JAX scales the rate by the data-parallel world batch; no mesh here, so True raises
    scale_lr: bool = False
    weight_decay: float = 1e-2
    grad_clip: float = 0.5
    accumulate_grad_batches: int = 1
    use_ema: bool = False
    ema_decay: float = 0.9999
    # regex patterns matched against '/'-joined parameter paths; empty => all trainable
    trainable_patterns: tuple[str, ...] = ()
    # dtype of the FROZEN Dense/Conv weights (e.g. "bfloat16"); None keeps fp32
    frozen_param_dtype: Optional[str] = None
    # None | ("lambda_warmup", warmup_steps) | ("cosine", t_max, eta_min)
    lr_schedule: Optional[tuple] = None
    max_steps: int = 50000


@dataclasses.dataclass
class TrainState:
    names: list[str]  # the trainable parameters' names
    params: list[torch.Tensor]  # the trainable parameters (fp32 masters)
    optimizer: torch.optim.Optimizer
    acc_grads: list[torch.Tensor]  # running mean of this accumulation window's gradients
    ema_params: Optional[dict]
    step: int = 0  # micro-steps taken
    updates: int = 0  # optimizer steps applied


def param_labels(model: nn.Module, patterns: tuple[str, ...]) -> dict[str, str]:
    """'train' / 'freeze' per parameter name. The patterns are the JAX
    package's, matched against the name with '/' separators: the port's
    names follow the JAX parameter tree (`utils/weights.py`), so prefixes
    such as `^adaptor/` select the same parameters. Empty => all trainable."""
    return {name: "train" if not patterns or any(re.search(p, name.replace(".", "/")) for p in patterns)
            else "freeze" for name, _ in model.named_parameters()}


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """Learning rate of the n-th optimizer update (n from 0), as optax's
    constant, linear-warmup and cosine-decay schedules give it."""
    if cfg.scale_lr:
        raise NotImplementedError("TrainConfig.scale_lr: the world-batch scale needs the data-parallel mesh, "
                                  "which is not ported")
    base = cfg.learning_rate
    if cfg.lr_schedule is None:
        return lambda n: base
    kind = cfg.lr_schedule[0]
    if kind == "lambda_warmup":
        warmup = int(cfg.lr_schedule[1])
        return lambda n: base * min(n, warmup) / warmup
    if kind == "cosine":
        t_max = int(cfg.lr_schedule[1])
        eta_min = float(cfg.lr_schedule[2]) if len(cfg.lr_schedule) > 2 else 0.0
        alpha = eta_min / base if base else 0.0
        return lambda n: base * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * min(n, t_max) / t_max)) + alpha)
    raise ValueError(f"unknown lr schedule '{kind}'")


@torch.no_grad()
def cast_frozen_params(cfg: TrainConfig, model: nn.Module) -> nn.Module:
    """Store the frozen Dense/Conv weights and biases in
    `cfg.frozen_param_dtype` (no-op when None), the rule `cast_for_inference`
    applies; trainable parameters keep their fp32 masters and norms stay f32."""
    if cfg.frozen_param_dtype is None:
        return model
    dtype = getattr(torch, cfg.frozen_param_dtype)
    labels = param_labels(model, cfg.trainable_patterns)
    for mod_name, m in model.named_modules():
        if isinstance(m, (Dense, Conv)):
            for leaf in ("weight", "bias"):
                p = getattr(m, leaf)
                if p is not None and labels[f"{mod_name}.{leaf}" if mod_name else leaf] == "freeze":
                    p.data = p.data.to(dtype)
    return model


def init_train_state(cfg: TrainConfig, model: nn.Module) -> TrainState:
    """Casts the frozen weights, freezes them (`requires_grad=False`, the JAX
    step's stop_gradient) and builds AdamW over the fp32 trainable masters."""
    cast_frozen_params(cfg, model)
    labels = param_labels(model, cfg.trainable_patterns)
    named = dict(model.named_parameters())
    for name, p in named.items():
        p.requires_grad_(labels[name] == "train")
    names = [n for n, lab in labels.items() if lab == "train"]
    params = [named[n] for n in names]
    if not params or any(p.dtype != torch.float32 for p in params):
        raise ValueError("init_train_state: the trainable subset must be non-empty fp32 masters")
    optimizer = torch.optim.AdamW(params, lr=make_lr_schedule(cfg)(0), betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=cfg.weight_decay)
    return TrainState(
        names=names, params=params, optimizer=optimizer,
        acc_grads=[torch.zeros_like(p) for p in params],
        ema_params=ema_lib.init_ema(dict(zip(names, params))) if cfg.use_ema else None,
    )


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


@torch.no_grad()
def apply_gradients(state: TrainState, cfg: TrainConfig, grads, schedule: Callable[[int], float]) -> None:
    """One micro-step of the optimizer chain: MultiSteps(chain(clip, adamw))."""
    k = cfg.accumulate_grad_batches
    mini = state.step % k
    for acc, g in zip(state.acc_grads, grads):
        acc.add_((g - acc) / (mini + 1))
    if mini == k - 1:
        norm = global_norm(state.acc_grads)
        keep = norm < cfg.grad_clip
        for acc, p in zip(state.acc_grads, state.params):
            acc.copy_(torch.where(keep, acc, acc / norm * cfg.grad_clip))
            p.grad = acc
        for group in state.optimizer.param_groups:
            group["lr"] = schedule(state.updates)
        state.optimizer.step()
        for acc, p in zip(state.acc_grads, state.params):
            p.grad = None
            acc.zero_()
        state.updates += 1
    if state.ema_params is not None:
        ema_lib.update_ema(state.ema_params, dict(zip(state.names, state.params)), state.step, cfg.ema_decay)
    state.step += 1


def loss_and_grads(model, params: list, batch: dict, step_seed: int, loss_kwargs: Optional[dict] = None):
    """One micro-step's (loss, metrics, gradients of `params`): the generator
    and the global RNG (the UNet's dropout) seeded by `step_seed`, inside
    `torch.random.fork_rng`; a parameter the loss does not reach gets zeros."""
    device = params[0].device
    generator = torch.Generator(device=device).manual_seed(step_seed)
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(step_seed)
        loss, metrics = model.training_loss(batch, generator, **(loss_kwargs or {}))
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss, metrics, [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]


def make_train_step(model, cfg: TrainConfig, loss_kwargs: Optional[dict] = None) -> Callable:
    """The train step: (state, batch, seed) -> {"loss", "loss_simple",
    "grad_norm"} as device tensors (no host sync). `loss_kwargs` are the
    phase flags forwarded to `model.training_loss`."""
    schedule = make_lr_schedule(cfg)

    def train_step(state: TrainState, batch: dict, seed: int) -> dict:
        loss, metrics, grads = loss_and_grads(model, state.params, batch, seed * 2 ** 32 + state.step, loss_kwargs)
        grad_norm = global_norm(grads)
        apply_gradients(state, cfg, grads, schedule)
        return dict(metrics, loss=loss.detach(), grad_norm=grad_norm)

    return train_step
