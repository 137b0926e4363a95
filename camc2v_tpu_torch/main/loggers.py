"""Metric/media logging sinks: CSV, TensorBoard, wandb (offline); a copy of
`camc2v_tpu/main/loggers.py`.

`CSVSink` needs nothing. `TensorBoardSink` (`torch.utils.tensorboard`, which
needs the `tensorboard` package) and `WandbSink` import their package when
built and raise an ImportError that names it when it is absent;
`build_sinks` logs that as a warning and goes on without the sink. A
`CSVSink` on an existing file (a resumed run) appends rows under its header.

The JAX package's sinks replace the reference's Lightning logger assembly
(reference: CamContextI2V/main/utils_train.py:111-150 — wandb default,
tensorboard/CSV alternatives; 01_train.py:281-291 wandb project wiring).

Build from the config's `lightning.logger` section with `build_sinks`;
every sink implements log_scalars / log_video / close. wandb runs in offline
mode by default (runs have no network); it degrades to a warning when the
package is absent.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger("camc2v")


class Sink:
    def log_scalars(self, step: int, scalars: dict) -> None:  # pragma: no cover
        raise NotImplementedError

    def log_video(self, step: int, tag: str, video: np.ndarray, fps: float = 8.0) -> None:
        pass  # optional

    def close(self) -> None:
        pass


class CSVSink(Sink):
    """reference: CSVLogger branch of get_trainer_logger."""

    def __init__(self, logdir: str, filename: str = "metrics.csv"):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, filename)
        self._keys: Optional[list] = None
        if os.path.exists(self.path) and os.path.getsize(self.path):  # a resumed run appends under the header
            with open(self.path) as f:
                self._keys = f.readline().strip().split(",")[1:]

    def log_scalars(self, step: int, scalars: dict) -> None:
        keys = sorted(scalars)
        with open(self.path, "a") as f:
            if self._keys is None:
                self._keys = keys
                f.write("step," + ",".join(keys) + "\n")
            f.write(f"{step}," + ",".join(f"{float(scalars.get(k, np.nan)):.6g}" for k in self._keys) + "\n")


class TensorBoardSink(Sink):
    """torch.utils.tensorboard writer."""

    def __init__(self, logdir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise ImportError("the tensorboard sink needs the `tensorboard` package, which is not installed; "
                              "use the csv sink") from e

        self.writer = SummaryWriter(log_dir=os.path.join(logdir, "tensorboard"))

    def log_scalars(self, step: int, scalars: dict) -> None:
        for k, v in scalars.items():
            self.writer.add_scalar(k, float(v), step)

    def log_video(self, step: int, tag: str, video: np.ndarray, fps: float = 8.0) -> None:
        # video: (T, H, W, 3) float in [-1, 1] -> frame strip image (video
        # summaries need moviepy)
        frames = np.clip((video + 1.0) / 2.0, 0.0, 1.0)
        idx = np.linspace(0, len(frames) - 1, min(8, len(frames))).astype(int)
        strip = np.concatenate([frames[i] for i in idx], axis=1)  # (H, 8W, 3)
        self.writer.add_image(tag, strip, step, dataformats="HWC")

    def close(self) -> None:
        self.writer.close()


class WandbSink(Sink):
    """wandb in offline mode (no network); syncs later with
    `wandb sync`. reference default logger: utils_train.py:111-128."""

    def __init__(self, logdir: str, project: str = "camcontexti2v", name: Optional[str] = None,
                 mode: str = "offline", **kwargs):
        try:
            import wandb
        except ImportError as e:
            raise ImportError("the wandb sink needs the `wandb` package, which is not installed; "
                              "use the csv sink") from e
        self.run = wandb.init(project=project, name=name, dir=logdir, mode=mode, **kwargs)
        self._wandb = wandb

    def log_scalars(self, step: int, scalars: dict) -> None:
        self.run.log(dict(scalars), step=step)

    def log_video(self, step: int, tag: str, video: np.ndarray, fps: float = 8.0) -> None:
        frames = np.clip((video + 1.0) / 2.0, 0.0, 1.0)
        arr = (frames * 255).astype(np.uint8).transpose(0, 3, 1, 2)  # (T, C, H, W)
        self.run.log({tag: self._wandb.Video(arr, fps=int(fps))}, step=step)

    def close(self) -> None:
        self.run.finish()


def build_sinks(logger_cfg, logdir: str, run_name: Optional[str] = None) -> list[Sink]:
    """`lightning.logger` config -> sink list.

    Accepts the reference's target-style node ({target: ...WandbLogger, ...}),
    a plain string ("csv" | "tensorboard" | "wandb"), or a list of either.
    Defaults to CSV + TensorBoard (the zero-egress analogue of the reference's
    wandb default); unavailable sinks degrade to a logged warning.
    """
    if logger_cfg is None:
        specs: Sequence = ("csv", "tensorboard")
    elif isinstance(logger_cfg, (list, tuple)):
        specs = logger_cfg
    else:
        specs = (logger_cfg,)

    sinks: list[Sink] = []
    for spec in specs:
        kwargs = {}
        if isinstance(spec, dict):
            target = str(spec.get("target", "")).lower()
            kwargs = dict(spec.get("params", {}))
            if "wandb" in target:
                kind = "wandb"
            elif "tensorboard" in target or "tb" in target:
                kind = "tensorboard"
            else:
                kind = "csv"
        else:
            kind = str(spec).lower()
        try:
            if kind == "wandb":
                kwargs.setdefault("name", run_name)
                sinks.append(WandbSink(logdir, **kwargs))
            elif kind == "tensorboard":
                sinks.append(TensorBoardSink(logdir))
            else:
                sinks.append(CSVSink(logdir))
        except Exception as e:  # missing package etc.
            logger.warning(f"logging sink '{kind}' unavailable: {e}")
    return sinks
