"""The fit loop of one device (`camc2v_tpu/main/harness.py::Trainer`), the
helpers of a training run (workspace, logger, batch transfer, sample
logging) and the generation pass over a data set (`generate_videos`).

`Trainer.fit` runs the train step over the data loader's batches until
`max_steps` micro-steps, with the JAX harness's behaviour:
  * the `flag_schedule` phases (`[(from_step, {loss_kwargs})]`, e.g.
    CamContextI2V's `adaptor_use_mask`: the FreezeCallback analogue);
  * `resume=True`: the latest checkpoint under `ckpt_dir` restored first
    (`utils/checkpoint.py`); a checkpoint every `ckpt_every_n_steps`
    micro-steps and at the end; SIGUSR1 / SIGTERM schedule an emergency
    checkpoint at the next step's end (SIGTERM then stops the run);
  * callbacks (`main/callbacks.py`) around every micro-step;
  * metrics reach the host only every `log_every_n_steps` micro-steps
    (`history`), so the card is not synchronised in between;
  * `validate` every `val_every_n_steps` micro-steps.
Each save's step, bytes and seconds are kept in `checkpoints`, the restore's
seconds in `restore_seconds`, each validation's in `val_history`.

Validation runs with dropout off (`deterministic=True`), on the EMA weights
when the run keeps an EMA. This is a deliberate divergence: the JAX eval
step is its training loss, dropout on. The CFG dropout, timestep and noise
of validation batch i come from a generator seeded i, as the JAX eval step
draws from key i. The mesh is not ported: `mesh=` raises.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import sys
import time
from typing import Optional

import numpy as np
import torch

from camc2v_tpu_torch.parallel import trainer as TR
from camc2v_tpu_torch.utils import checkpoint as CK

logger = logging.getLogger("camc2v")


def setup_logger(logdir: Optional[str] = None, rank: int = 0) -> logging.Logger:
    """Rank-aware logger to stdout (rank 0) and `<logdir>/logs/log.txt`."""
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    if rank == 0:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(logging.Formatter(f"[%(asctime)s][rank{rank}][%(levelname)s] %(message)s", "%H:%M:%S"))
        logger.addHandler(sh)
    if logdir:
        os.makedirs(f"{logdir}/logs", exist_ok=True)
        fh = logging.FileHandler(f"{logdir}/logs/log.txt" + ("" if rank == 0 else f".rank{rank}"))
        fh.setFormatter(logging.Formatter("[%(asctime)s][%(levelname)s] %(message)s"))
        logger.addHandler(fh)
    return logger


def init_workspace(name: str, logdir: str, config: dict) -> dict:
    """The run's directories and a snapshot of its configuration
    (`configs/config.json`: the port writes no yaml)."""
    workdir = os.path.join(logdir, name)
    dirs = {"workdir": workdir, "ckptdir": os.path.join(workdir, "checkpoints"),
            "cfgdir": os.path.join(workdir, "configs"), "loginfo": os.path.join(workdir, "logs")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    with open(os.path.join(dirs["cfgdir"], "config.json"), "w") as f:
        json.dump(config, f, indent=1, default=str)
    return dirs


def batch_to_device(batch: dict, device, tokenizer=None) -> dict:
    """A numpy batch dict -> the model's input dict on `device`: arrays and
    tensors moved, captions tokenized when the batch has no
    `caption_tokens` (as int64), other strings dropped."""
    out = {}
    for k, v in batch.items():
        if k == "caption":
            if tokenizer is not None and "caption_tokens" not in batch:
                out["caption_tokens"] = torch.from_numpy(np.asarray(tokenizer(v), np.int64)).to(device)
            continue
        if k in ("video_path", "all_frames") or (isinstance(v, (list, tuple)) and v and isinstance(v[0], str)):
            continue
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        out[k] = t.to(device)
    return out


class _EmaWeights:
    """The run's EMA copied into the trainable parameters for the block, the
    masters restored after (no-op without an EMA)."""

    def __init__(self, state):
        self.state = state

    def __enter__(self):
        ema = self.state.ema_params
        self.saved = None
        if ema is not None:
            self.saved = [p.detach().clone() for p in self.state.params]
            with torch.no_grad():
                for n, p in zip(self.state.names, self.state.params):
                    p.copy_(ema[n])
        return self.saved is not None

    def __exit__(self, *exc):
        if self.saved is not None:
            with torch.no_grad():
                for p, s in zip(self.state.params, self.saved):
                    p.copy_(s)
        return False


class Trainer:
    def __init__(self, model, train_config: TR.TrainConfig, dataloader, *, val_dataloader=None,
                 callbacks: Optional[list] = None, ckpt_dir: Optional[str] = None, ckpt_every_n_steps: int = 5000,
                 val_every_n_steps: Optional[int] = None, val_max_batches: int = 8, tokenizer=None, mesh=None,
                 seed: int = 0, flag_schedule: Optional[list] = None, log_every_n_steps: int = 10,
                 max_to_keep: Optional[int] = None):
        if mesh is not None:
            raise NotImplementedError("Trainer: the mesh is not ported (one device)")
        self.model = model
        self.train_config = train_config
        self.dataloader = dataloader
        self.val_dataloader = val_dataloader
        self.callbacks = list(callbacks or [])
        self.ckpt_dir = ckpt_dir
        self.ckpt_every_n_steps = ckpt_every_n_steps
        self.val_every_n_steps = val_every_n_steps
        self.val_max_batches = val_max_batches
        self.tokenizer = tokenizer
        self.seed = seed
        self.flag_schedule = sorted(flag_schedule or [], key=lambda x: x[0])
        self.log_every_n_steps = max(1, log_every_n_steps)
        self.max_to_keep = max_to_keep
        self.history: list[dict] = []
        self.val_history: list[dict] = []
        self.resumed_from: Optional[int] = None
        self.restore_seconds: Optional[float] = None
        self.checkpoints: list[dict] = []  # per save: step, path, bytes, seconds
        self._stop = False
        self._emergency_save = False

    def _flags_for(self, step: int) -> dict:
        flags: dict = {}
        for from_step, kw in self.flag_schedule:
            if step >= from_step:
                flags = kw
        return flags

    def _install_signal_handlers(self) -> dict:
        """SIGUSR1 / SIGTERM -> a checkpoint at the next step's end; SIGTERM
        then stops the run (the reference's melk, main/trainer.py:159-174).
        Returns the handlers they replace, which `fit` puts back."""

        def melk(signum, frame):
            logger.info(f"signal {signum}: scheduling an emergency checkpoint")
            self._emergency_save = True
            if signum == signal.SIGTERM:
                self._stop = True

        replaced = {}
        for sig in (signal.SIGUSR1, signal.SIGTERM):
            try:
                replaced[sig] = signal.signal(sig, melk)
            except ValueError:
                pass  # not the main thread
        return replaced

    def save(self, state) -> str:
        t0 = time.perf_counter()
        path = CK.save_checkpoint(self.ckpt_dir, state, state.step, self.max_to_keep)
        rec = dict(step=state.step, path=path, bytes=os.path.getsize(path), seconds=time.perf_counter() - t0)
        self.checkpoints.append(rec)
        logger.info(f"checkpoint saved at step {state.step}: {path} ({rec['bytes']} bytes, {rec['seconds']:.2f} s)")
        self._emergency_save = False
        return path

    def fit(self, state: TR.TrainState, max_steps: Optional[int] = None, resume: bool = True) -> TR.TrainState:
        replaced = self._install_signal_handlers()
        try:
            return self._fit(state, max_steps or self.train_config.max_steps, resume)
        finally:
            for sig, handler in replaced.items():
                signal.signal(sig, handler)

    def _fit(self, state: TR.TrainState, max_steps: int, resume: bool) -> TR.TrainState:
        device = state.params[0].device
        if resume and self.ckpt_dir and CK.latest_step(self.ckpt_dir) is not None:
            t0 = time.perf_counter()
            CK.restore_checkpoint(self.ckpt_dir, state)
            self.resumed_from, self.restore_seconds = state.step, time.perf_counter() - t0
            logger.info(f"resumed from step {state.step} ({self.restore_seconds:.2f} s)")
        for cb in self.callbacks:
            cb.on_fit_start(state.step, state)
        flags = self._flags_for(state.step)
        step_fn = TR.make_train_step(self.model, self.train_config, loss_kwargs=flags)
        while state.step < max_steps and not self._stop:
            taken = state.step
            batches = iter(self.dataloader)
            while state.step < max_steps and not self._stop:
                for cb in self.callbacks:
                    cb.on_train_batch_start(state.step)
                batch = next(batches, None)
                if batch is None:
                    break
                batch = batch_to_device(batch, device, self.tokenizer)
                for cb in self.callbacks:
                    cb.on_data_loaded(state.step)
                if self._flags_for(state.step) != flags:
                    flags = self._flags_for(state.step)
                    logger.info(f"[phase] step {state.step}: flags -> {flags}")
                    step_fn = TR.make_train_step(self.model, self.train_config, loss_kwargs=flags)
                metrics = step_fn(state, batch, self.seed)
                host = {}
                if state.step % self.log_every_n_steps == 0 or state.step >= max_steps or self._stop:
                    host = {k: float(v) for k, v in metrics.items()}
                    self.history.append(dict(step=state.step, **host))
                for cb in self.callbacks:
                    cb.on_train_batch_end(state.step, state, host)
                if self.ckpt_dir and (state.step % self.ckpt_every_n_steps == 0 or self._emergency_save):
                    self.save(state)
                if self.val_dataloader is not None and self.val_every_n_steps and \
                        state.step % self.val_every_n_steps == 0:
                    self.validate(state)
            if state.step == taken:
                raise ValueError("Trainer.fit: the dataloader gave no batch")
        if self.ckpt_dir and CK.latest_step(self.ckpt_dir) != state.step:
            self.save(state)
        return state

    @torch.no_grad()
    def validate(self, state: TR.TrainState, max_batches: Optional[int] = None) -> Optional[float]:
        """The mean loss over the validation loader's first `max_batches`
        batches (`val_max_batches`): `training_loss(deterministic=True)` at
        the current phase's flags, on the EMA weights when there are any."""
        max_batches = self.val_max_batches if max_batches is None else max_batches
        device = state.params[0].device
        flags = self._flags_for(state.step)
        losses = []
        t0 = time.perf_counter()
        with _EmaWeights(state) as on_ema:
            for i, batch in enumerate(self.val_dataloader):
                if i >= max_batches:
                    break
                batch = batch_to_device(batch, device, self.tokenizer)
                generator = torch.Generator(device=device).manual_seed(i)
                loss, _ = self.model.training_loss(batch, generator, deterministic=True, **flags)
                losses.append(float(loss))
        if not losses:
            return None
        mean = float(np.mean(losses))
        self.val_history.append(dict(step=state.step, loss=mean, batches=len(losses), ema=on_ema,
                                     seconds=time.perf_counter() - t0))
        logger.info(f"[val{' (EMA)' if on_ema else ''}] step={state.step} loss={mean:.4f} over {len(losses)} batches")
        return mean


def make_sample_logger(model, dataloader, out_dir: str, *, tokenizer=None, sample_kwargs: Optional[dict] = None,
                       num_batches: int = 1, sinks=None):
    """The ImageLogger's `sample_fn`: `model.sample` on the loader's first
    `num_batches` batches (taken once, so every log shows the same
    examples), written by `utils.save_video.save_grid` and sent to the sinks."""
    from camc2v_tpu_torch.utils.save_video import save_grid

    sample_kwargs = dict(sample_kwargs or {})
    os.makedirs(out_dir, exist_ok=True)
    fixed: list = []

    def sample_fn(step: int):
        if not fixed:
            it = iter(dataloader)
            for _ in range(num_batches):
                batch = next(it, None)
                if batch is None:
                    break
                fixed.append(batch)
        device = next(model.parameters()).device
        for i, batch in enumerate(fixed):
            batch = batch_to_device(batch, device, tokenizer)
            generator = torch.Generator(device=device).manual_seed(step + i)
            videos = model.sample(batch, generator=generator, **sample_kwargs).float().cpu().numpy()
            path = save_grid(os.path.join(out_dir, f"step{step:07d}_b{i}"), videos)
            for sink in sinks or ():
                sink.log_video(step, f"samples/batch{i}", videos[0])
            logger.info(f"[media] samples at step {step}: {path}")

    return sample_fn


def generate_videos(model, dataloader, out_dir: str, *, tokenizer=None, sample_kwargs: Optional[dict] = None,
                    max_batches: Optional[int] = None, skip_existing: bool = True, seed: int = 0,
                    mesh=None) -> list[str]:
    """The generation ("test") pass: one evaluation directory per video
    (`utils/save_video.py::log_evaluation`), as `camc2v_tpu/main/harness.py::
    generate_videos` writes it. Videos are named by their `video_path`, else
    `sample_{i:05d}_{j}`; `skip_existing` skips a batch whose videos all
    exist (the reference's `--continue`); batch i samples from a generator
    seeded `seed + i`. Each generated batch logs its host seconds of
    loading, `sample` (ended by the copy to the host) and writing, also as
    the record's `timing` attribute (a dict). The sharded sampler over a
    mesh is not ported: `mesh=` raises."""
    if mesh is not None:
        raise NotImplementedError("generate_videos: sharded generation over a mesh is not ported "
                                  "(ROADMAP queue 1, item 6)")
    from camc2v_tpu_torch.utils.save_video import generated_exists, log_evaluation

    sample_kwargs = dict(sample_kwargs or {})
    device = next(model.parameters()).device
    os.makedirs(out_dir, exist_ok=True)
    written = []
    t0 = time.perf_counter()
    for i, batch in enumerate(dataloader):
        if max_batches is not None and i >= max_batches:
            break
        names = [os.path.splitext(os.path.basename(p))[0] for p in batch.get("video_path", [])]
        if not names:
            names = [f"sample_{i:05d}_{j}" for j in range(len(batch["video"]))]
        if skip_existing and all(generated_exists(os.path.join(out_dir, n)) for n in names):
            t0 = time.perf_counter()
            continue
        device_batch = batch_to_device(batch, device, tokenizer)
        t1 = time.perf_counter()
        generator = torch.Generator(device=device).manual_seed(seed + i)
        videos = model.sample(device_batch, generator=generator, **sample_kwargs).float().cpu().numpy()
        t2 = time.perf_counter()
        ctx = batch.get("cond_frames")
        for j, name in enumerate(names):
            written.append(log_evaluation(
                out_dir, name, videos[j], ground_truth=np.asarray(batch["video"][j]),
                camera_data=np.asarray(batch["camera_data"][j]) if "camera_data" in batch else None,
                caption=batch["caption"][j] if "caption" in batch else None,
                context_frames=np.asarray(ctx[j]) if ctx is not None else None,
                fps=float(np.asarray(batch["fps"][j])) if "fps" in batch else 8.0))
            logger.info(f"[generate] wrote {written[-1]}")
        rec = dict(batch=i, videos=len(names), load_s=t1 - t0, sample_s=t2 - t1, write_s=time.perf_counter() - t2)
        logger.info(f"[generate] batch {i}: {len(names)} videos; load {rec['load_s']:.3f} s, sample "
                    f"{rec['sample_s']:.3f} s, write {rec['write_s']:.3f} s", extra={"timing": rec})
        t0 = time.perf_counter()
    return written
