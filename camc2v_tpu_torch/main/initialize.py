"""Experiment initialisation, the port's `00_initialize.py`.

    python -m camc2v_tpu_torch.main.initialize --config <yaml> --name <run> [--logdir ./results]

Creates `<logdir>/<name>/{configs,checkpoints,logs}`, copies the config
into `configs/`, and records the run in `<logdir>/.exp_meta.yaml` under this
host's name: config and workdir (absolute) and the creation time. The
registry is read and written with the port's own yaml reader and emitter
(`config_yaml.parse_yaml`, `dump_yaml`: no PyYAML needed); a registry
written by `00_initialize.py` reads the same. No device is touched.
"""

from __future__ import annotations

import argparse
import datetime
import os
import shutil
import socket
from typing import Optional


def main(argv: Optional[list] = None) -> str:
    """Initialise the run; returns its workdir."""
    ap = argparse.ArgumentParser(prog="python -m camc2v_tpu_torch.main.initialize")
    ap.add_argument("--config", required=True)
    ap.add_argument("--name", required=True)
    ap.add_argument("--logdir", default="./results")
    args = ap.parse_args(argv)

    from camc2v_tpu_torch.config_yaml import dump_yaml, load_yaml
    from camc2v_tpu_torch.utils.meta import DEFAULT_META_FILE

    workdir = os.path.join(args.logdir, args.name)
    for sub in ("configs", "checkpoints", "logs"):
        os.makedirs(os.path.join(workdir, sub), exist_ok=True)
    shutil.copy(args.config, os.path.join(workdir, "configs", os.path.basename(args.config)))

    meta_path = os.path.join(args.logdir, DEFAULT_META_FILE)
    meta = (load_yaml(meta_path) or {}) if os.path.exists(meta_path) else {}
    meta.setdefault(socket.gethostname(), {})[args.name] = {
        "config": os.path.abspath(args.config),
        "workdir": os.path.abspath(workdir),
        "created": datetime.datetime.now().isoformat(timespec="seconds"),
    }
    with open(meta_path, "w") as f:
        f.write(dump_yaml(meta))
    print(f"initialized experiment '{args.name}' at {workdir}")
    return workdir


if __name__ == "__main__":
    main()
