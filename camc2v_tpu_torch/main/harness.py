"""The fit loop (`camc2v_tpu/main/harness.py::Trainer`, one device).

`Trainer.fit` runs the train step over an iterable of batches (dicts of
tensors, moved to the model's device) until `max_steps` micro-steps, with
the `flag_schedule` phases of the JAX harness (the FreezeCallback analogue:
`[(from_step, {loss_kwargs})]`, e.g. CamContextI2V's `adaptor_use_mask`).
Metrics reach the host only every `log_every_n_steps` micro-steps
(`history`). Checkpoints, callbacks, validation and the mesh are not ported:
the JAX versions need orbax, the loggers and a data loader; passing any of
them raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from camc2v_tpu_torch.parallel import trainer as TR


class Trainer:
    def __init__(self, model, train_config: TR.TrainConfig, dataloader, *, val_dataloader=None,
                 callbacks: Optional[list] = None, ckpt_dir: Optional[str] = None, mesh=None, seed: int = 0,
                 flag_schedule: Optional[list] = None, log_every_n_steps: int = 10):
        for name, value in (("val_dataloader", val_dataloader), ("callbacks", callbacks),
                            ("ckpt_dir", ckpt_dir), ("mesh", mesh)):
            if value:
                raise NotImplementedError(f"Trainer: {name} is not ported (checkpoints, callbacks, validation "
                                          "and the mesh stay with the JAX harness)")
        self.model = model
        self.train_config = train_config
        self.dataloader = dataloader
        self.seed = seed
        self.flag_schedule = sorted(flag_schedule or [], key=lambda x: x[0])
        self.log_every_n_steps = max(1, log_every_n_steps)
        self.history: list[dict] = []

    def _flags_for(self, step: int) -> dict:
        flags: dict = {}
        for from_step, kw in self.flag_schedule:
            if step >= from_step:
                flags = kw
        return flags

    def fit(self, state: TR.TrainState, max_steps: Optional[int] = None) -> TR.TrainState:
        max_steps = max_steps or self.train_config.max_steps
        device = state.params[0].device
        flags = self._flags_for(state.step)
        step_fn = TR.make_train_step(self.model, self.train_config, loss_kwargs=flags)
        while state.step < max_steps:
            taken = state.step
            for batch in self.dataloader:
                if state.step >= max_steps:
                    break
                if self._flags_for(state.step) != flags:
                    flags = self._flags_for(state.step)
                    step_fn = TR.make_train_step(self.model, self.train_config, loss_kwargs=flags)
                batch = {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in batch.items()}
                metrics = step_fn(state, batch, self.seed)
                if state.step % self.log_every_n_steps == 0 or state.step >= max_steps:
                    self.history.append(dict(step=state.step, **{k: float(v) for k, v in metrics.items()}))
            if state.step == taken:
                raise ValueError("Trainer.fit: the dataloader gave no batch")
        return state
