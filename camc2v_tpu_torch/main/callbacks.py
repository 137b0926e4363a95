"""Training callbacks (`camc2v_tpu/main/callbacks.py`; reference
CamContextI2V/main/callbacks.py):
  * `ProgressPrinter` — smoothed rate and ETA (PrintProgressCallback);
  * `MetricsLogger` — scalars through the sinks of `main/loggers.py`;
  * `LiveProfiler` — the data wait and the step's device time (LiveProfiler),
    from CUDA events read only at the log interval;
  * `DeviceMonitor` — step time and device memory (CUDACallback);
  * `ModelWatcher` — non-finite loss, gradient norm or parameters
    (ModelWatcherCallback, without the JAX package's per-layer capture);
  * `ImageLogger` — periodic samples through an injected `sample_fn`.

`Trainer.fit` calls, per micro-step: `on_train_batch_start(step)` before it
asks the data loader for the batch, `on_data_loaded(step)` once the batch is
on the model's device, `on_train_batch_end(step, state, metrics)` after the
train step (metrics hold host floats only at the log interval, else {}),
and `on_fit_start(step, state)` once, after a resume and before the first
micro-step.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger("camc2v")


class Callback:
    def on_fit_start(self, step: int, state): ...

    def on_train_batch_start(self, step: int): ...

    def on_train_batch_end(self, step: int, state, metrics: dict): ...

    def on_data_loaded(self, step: int): ...


def _cuda_event(device):
    if device is None or torch.device(device).type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class LiveProfiler(Callback):
    """EMA-smoothed times of the data wait (host clock: from asking the loader
    for a batch until it is on the device) and of the step (CUDA events from
    the batch on the device to the step's end, the host clock on the CPU).
    The events are read, with one synchronisation, only every `interval`
    steps; `history` keeps (step, data s, step s) per micro-step."""

    def __init__(self, interval: int = 10, smooth_coeff: float = 0.9, max_steps: Optional[int] = None,
                 device=None):
        self.interval = interval
        self.alpha = smooth_coeff
        self.max_steps = max_steps
        self.device = device
        self.data_time = None
        self.step_time = None
        self.history: list[tuple[int, float, float]] = []
        self._t_start = self._t_data = None
        self._pending: list = []  # (step, data s, start event or host time, end event or host time)

    def _smooth(self, old, new):
        return new if old is None else self.alpha * old + (1 - self.alpha) * new

    def on_train_batch_start(self, step):
        self._t_start = time.perf_counter()

    def on_data_loaded(self, step):
        if self._t_start is None:
            return
        self._t_data = time.perf_counter()
        self._data_s = self._t_data - self._t_start
        self._ev_data = _cuda_event(self.device)

    def on_train_batch_end(self, step, state, metrics):
        if self._t_data is None:
            return
        ev_end = _cuda_event(self.device)
        self._pending.append((step, self._data_s, self._ev_data or self._t_data, ev_end or time.perf_counter()))
        if step % self.interval and not (self.max_steps and step >= self.max_steps):
            return
        if ev_end is not None:
            ev_end.synchronize()
        for s, data_s, a, b in self._pending:
            step_s = a.elapsed_time(b) / 1e3 if isinstance(a, torch.cuda.Event) else b - a
            self.history.append((s, data_s, step_s))
            self.data_time = self._smooth(self.data_time, data_s)
            self.step_time = self._smooth(self.step_time, step_s)
        self._pending.clear()
        logger.info(f"[profiler] step={step} data={self.data_time:.3f}s step={self.step_time:.3f}s")


class DeviceMonitor(Callback):
    """Every `interval` steps: the step's host time (its enqueue, no
    synchronisation) and the device's peak and free memory."""

    def __init__(self, interval: int = 100, device=None):
        self.interval = interval
        self.device = device
        self._t = None
        self.records: list[dict] = []

    def on_train_batch_start(self, step):
        self._t = time.perf_counter()

    def on_train_batch_end(self, step, state, metrics):
        if step % self.interval != 0 or self._t is None:
            return
        rec = dict(step=step, step_time_s=time.perf_counter() - self._t)
        if self.device is not None and torch.device(self.device).type == "cuda":
            free, total = torch.cuda.mem_get_info(self.device)
            rec.update(peak_gib=torch.cuda.max_memory_allocated(self.device) / 2 ** 30, free_gib=free / 2 ** 30,
                       total_gib=total / 2 ** 30)
        self.records.append(rec)
        mem = f" peak={rec['peak_gib']:.2f}GiB free={rec['free_gib']:.2f}GiB" if "peak_gib" in rec else ""
        logger.info(f"[device] step={step} step_time={rec['step_time_s']:.3f}s{mem}")


class ModelWatcher(Callback):
    """Non-finite loss or gradient norm at any logged step, and non-finite or
    out-of-bound trainable parameters every `check_params_every` steps."""

    def __init__(self, check_params_every: int = 100, param_bound: float = 1e4, raise_on_error: bool = True):
        self.check_params_every = check_params_every
        self.param_bound = param_bound
        self.raise_on_error = raise_on_error
        self.alerts: list[str] = []

    def _alert(self, msg: str):
        self.alerts.append(msg)
        logger.error(f"[watcher] {msg}")
        if self.raise_on_error:
            raise FloatingPointError(msg)

    def on_train_batch_end(self, step, state, metrics):
        loss = float(metrics.get("loss", 0.0))
        if not np.isfinite(loss):
            self._alert(f"non-finite loss at step {step}: {loss}")
        gn = metrics.get("grad_norm")
        if gn is not None and not np.isfinite(float(gn)):
            self._alert(f"non-finite grad norm at step {step}")
        if state is not None and step % self.check_params_every == 0:
            worst = max(float(p.detach().abs().max()) for p in state.params)
            if not np.isfinite(worst) or worst > self.param_bound:
                self._alert(f"trainable parameters non-finite or above {self.param_bound} at step {step}: {worst}")


class ProgressPrinter(Callback):
    """Smoothed ETA logging."""

    def __init__(self, interval: int = 20, max_steps: int = 50000):
        self.interval = interval
        self.max_steps = max_steps
        self._t0 = time.perf_counter()
        self._step0 = None

    def on_train_batch_end(self, step, state, metrics):
        if self._step0 is None:
            self._step0 = step
            self._t0 = time.perf_counter()
            return
        if step % self.interval != 0 or step == self._step0:
            return
        rate = (step - self._step0) / (time.perf_counter() - self._t0)
        eta_s = (self.max_steps - step) / max(rate, 1e-9)
        logger.info(f"[progress] step={step}/{self.max_steps} loss={float(metrics.get('loss', 0)):.4f} "
                    f"({rate:.2f} it/s, ETA {eta_s / 3600:.1f}h)")


class MetricsLogger(Callback):
    """Scalars through pluggable sinks (CSV / TensorBoard / wandb); with no
    sinks given, CSV + TensorBoard (`loggers.build_sinks(None, ...)`)."""

    def __init__(self, logdir: str, interval: int = 50, sinks=None):
        from camc2v_tpu_torch.main.loggers import build_sinks

        self.sinks = sinks if sinks is not None else build_sinks(None, logdir)
        self.interval = interval

    def on_train_batch_end(self, step, state, metrics):
        if step % self.interval != 0 or not metrics:
            return
        scalars = {k: float(v) for k, v in metrics.items() if np.isscalar(v) or getattr(v, "ndim", 1) == 0}
        for sink in self.sinks:
            sink.log_scalars(step, scalars)

    def close(self):
        for sink in self.sinks:
            sink.close()


class ImageLogger(Callback):
    """Periodic sample generation during training; `sample_fn(step)` does the
    work (`main.harness.make_sample_logger`)."""

    def __init__(self, every_n_steps: int = 2500, sample_fn=None, log_first_iteration: bool = False):
        self.every_n_steps = every_n_steps
        self.sample_fn = sample_fn
        self.log_first_iteration = log_first_iteration

    def on_train_batch_end(self, step, state, metrics):
        if self.sample_fn is None:
            return
        if (step % self.every_n_steps == 0 and step > 0) or (step == 1 and self.log_first_iteration):
            self.sample_fn(step)
