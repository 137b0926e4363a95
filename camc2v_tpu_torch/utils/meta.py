"""Per-machine registry: data roots, multi-card setups, env setup
(`camc2v_tpu/utils/meta.py`, with torchrun in place of `jax.distributed`).

reference: CamContextI2V/utils/meta.py (DEFAULT_MACHINE, DATA_DIRECTORIES,
PARTITION_SETUPS, ENVIRONMENT_SETUP, SOURCE_PATH), consumed by
02_generate_videos.py for per-host config rewriting and launcher generation.

An entry of `SETUPS` describes hosts x cards (`chips_per_host`: cards a
host, None = every local card); the launcher emits one `torchrun`
command per host. (The JAX registry's per-host batch sizing and run time
are left out: nothing in the port reads them.) The port's generation
needs no collective: each process takes a rank-strided shard of the data
(`process_from_env`), so no process group is created.

Edit the dicts below for your fleet; entries are examples, like the
reference's. `DEFAULT_MACHINE = "local"` always exists and means "this
host, all local cards, no substitution of data paths unless listed".
"""

from __future__ import annotations

import os
from typing import Optional

DEFAULT_MACHINE = "local"
DEFAULT_META_FILE = ".exp_meta.yaml"

# ---- per-machine data roots (substituted into the config's data params) ----
DATA_DIRECTORIES: dict[str, dict[str, dict[str, str]]] = {
    # "my-h100-node": {
    #     "train": {
    #         "data_dir": "/mnt/data/realestate10k/train/clips",
    #         "meta_path": "/mnt/data/realestate10k/train/meta",
    #         "meta_list": "/mnt/data/realestate10k/train/list.txt",
    #         "caption_file": "/mnt/data/realestate10k/train/captions.json",
    #     },
    #     "val": {...}, "test": {...},
    # },
}

# ---- multi-card presets (the PARTITION_SETUPS analogue) ----
SETUPS: dict[str, dict[str, dict]] = {
    "local": {
        "default": {
            "num_hosts": 1,
            "chips_per_host": None,  # None = all local cards
        }
    },
    # "my-h100-cluster": {
    #     "2x8": {"num_hosts": 2, "chips_per_host": 8},
    # },
}

# ---- per-machine environment setup commands (prefix of the launcher) ----
ENVIRONMENT_SETUP: dict[str, str] = {
    "local": "",
    # "my-h100-node": textwrap.dedent("""\
    #     source "$HOME/venvs/camc2v/bin/activate"
    # """),
}

# ---- per-machine repo checkout paths ----
SOURCE_PATH: dict[str, str] = {
    "local": ".",
}


def setups_for(machine: str) -> dict[str, dict]:
    return SETUPS.get(machine, SETUPS[DEFAULT_MACHINE])


def apply_machine_config(cfg: dict, machine: Optional[str]) -> dict:
    """Substitute the machine's data roots into a loaded config dict
    (reference 02_generate_videos.py:255-275 rewrites train/val/test
    data_dir/meta_path/meta_list/caption_file per machine)."""
    if not machine or machine not in DATA_DIRECTORIES:
        return cfg
    dirs = DATA_DIRECTORIES[machine]
    data = cfg.setdefault("data", {}).setdefault("params", {})
    for split, paths in dirs.items():
        node = data.setdefault(split, {}).setdefault("params", {})
        node.update(paths)
    return cfg


def launcher_script(machine: str, setup: str, module: str, script_args: list[str], master_port: int = 29500) -> str:
    """A bash launcher running `python -m module script_args` under torchrun
    on every host of the setup: one process per card, `RANK` / `WORLD_SIZE`
    / `LOCAL_RANK` set for `process_from_env` (reference
    02_generate_videos.py:165-195 emits torchrun/sbatch lines)."""
    cfg = setups_for(machine).get(setup) or next(iter(setups_for(machine).values()))
    n_hosts = int(cfg.get("num_hosts", 1))
    per_host = cfg.get("chips_per_host") or "gpu"  # torchrun: "gpu" = one process per local card
    env = ENVIRONMENT_SETUP.get(machine, "")
    src = SOURCE_PATH.get(machine, ".")
    args = " ".join(script_args)
    if n_hosts <= 1:
        header, rank = "", "--node_rank 0 --master_addr localhost"
    else:
        header = "# run this block on EVERY host (NODE_RANK = host index, MASTER_ADDR = host 0's address)\n"
        rank = '--node_rank "${NODE_RANK:?set to this host index}" --master_addr "${MASTER_ADDR:?set to host 0}"'
    body = (f"{header}cd {src}\n"
            f"torchrun --nnodes {n_hosts} --nproc_per_node {per_host} {rank} --master_port {master_port} \\\n"
            f"    -m {module} {args}\n")
    return f"#!/bin/bash\nset -euo pipefail\n{env}\n{body}"


def process_from_env() -> tuple[int, int, int]:
    """(rank, world_size, local_rank) from torchrun's RANK / WORLD_SIZE /
    LOCAL_RANK, or (0, 1, 0) outside torchrun."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return 0, 1, 0
    return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), int(os.environ.get("LOCAL_RANK", 0))
