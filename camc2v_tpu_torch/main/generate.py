"""Evaluation-set generation, the port's `02_generate_videos.py`.

    python -m camc2v_tpu_torch.main.generate --config configs/models/camcontexti2v_256.yaml \\
        [--ckpt <checkpoint dir or reference .pt>] --out results/generation \\
        [--cfg-scale 7.5] [--camera-cfg 1.0] [--sampling-strategy random_back] \\
        [--num-videos N] [--continue] [--device cuda|cpu] [key.path=value ...]

It runs the model over the yaml's `test` split (else `validation`) and
writes one directory per video (`utils/save_video.py::log_evaluation`:
generated and ground-truth video, camera_data.npy, captions.txt,
context_<j>.png), which `03_evaluation.py` reads. The videos are `.mp4`
where OpenCV is installed and `.npz` (frames, fps) without it.
`--continue` skips batches whose videos exist (either file).

`--num-videos` counts BATCHES, not videos: it is passed on as
`max_batches`, as `02_generate_videos.py` does.

The model is built on `--device` (the card by default; without CUDA it
raises unless `--device cpu` is given), then:
  * `--ckpt` a directory: a checkpoint directory of `main/train.py`, read at
    its latest step. Such a checkpoint holds the trainable parameters only,
    so the model is first made as the training run made it, from the seed
    and the reference `.pt` that the directory's `base.json` records (not
    `--seed`, not the yaml's `pretrained_checkpoint`); the digest recorded
    there must match, else it raises. The saved `params` are then laid over
    it by name (not the EMA copy, as the JAX CLI restores `params`);
  * `--ckpt` a file: the reference's `.pt`, imported into weights seeded by
    `--seed`;
  * no `--ckpt`: the yaml's `pretrained_checkpoint` where it exists, else
    the weights seeded by `--seed` stay.
Batch i samples from a generator seeded `--seed` + i.
Under torchrun each process takes the rank-strided shard of the data
(`RANK` / `WORLD_SIZE`) on `cuda:LOCAL_RANK`; no process group is needed.
`--shard-data` (one data-parallel program over the local cards) waits for
the port's mesh (ROADMAP queue 1, item 6) and raises.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

MODULE = "camc2v_tpu_torch.main.generate"


def parse_args(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(prog=f"python -m {MODULE}")
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default=None, help="checkpoint dir of main/train.py, or a reference .pt")
    ap.add_argument("--out", default="results/generation")
    ap.add_argument("--cfg-scale", type=float, default=7.5)
    ap.add_argument("--camera-cfg", type=float, default=1.0)
    ap.add_argument("--camera-cfg-scheduler", default="constant")
    ap.add_argument("--guidance-rescale", type=float, default=0.7)
    ap.add_argument("--ddim-steps", type=int, default=25)
    ap.add_argument("--timestep-spacing", default="uniform_trailing")
    ap.add_argument("--ddim-eta", type=float, default=1.0)
    ap.add_argument("--sampler", default="ddim", choices=["ddim", "dpmpp_2m"],
                    help="dpmpp_2m: deterministic 2nd-order solver, ~2x fewer steps than ddim")
    ap.add_argument("--sampling-strategy", default=None, help="context strategy override (e.g. random_back)")
    ap.add_argument("--num-videos", type=int, default=None, help="number of BATCHES to generate")
    ap.add_argument("--continue", dest="resume", action="store_true")
    ap.add_argument("--seed", type=int, default=20240101)
    ap.add_argument("--shard-data", action="store_true", help="not ported (needs the mesh): raises")
    ap.add_argument("--bpe_path", default=None)
    ap.add_argument("--machine", default=None,
                    help="machine-registry entry (camc2v_tpu_torch/utils/meta.py): substitutes "
                         "that machine's data roots into the config")
    ap.add_argument("--setup", default="default", help="multi-card preset within --machine")
    ap.add_argument("--emit-launcher", default=None, help="write a torchrun launcher script and exit")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*")
    return ap.parse_intermixed_args(argv)


def resolve_device(device: str, local_rank: int = 0):
    """`device` as a torch device (`cuda` -> `cuda:local_rank`), made the
    current CUDA device (the kernels launch on the current device's
    stream); raises when CUDA is asked for and missing."""
    import torch

    dev = torch.device(f"cuda:{local_rank}" if device == "cuda" else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
        torch.cuda.set_device(dev)
    return dev


def _import_reference(model, path: str, log) -> None:
    from camc2v_tpu_torch.utils.torch_import import load_reference_checkpoint

    report = load_reference_checkpoint(model, path)
    log.info(f"imported {len(report['mapped'])} tensors from {path}")


def load_model(cfg: dict, ckpt: Optional[str], device, seed: int, log):
    """The model to generate with (see the module docstring), in eval mode
    with its Dense/Conv weights in bf16."""
    import torch

    from camc2v_tpu_torch.config_yaml import build_model_from_config
    from camc2v_tpu_torch.utils import checkpoint as CK
    from camc2v_tpu_torch.utils.weights import cast_for_inference

    path = ckpt or cfg["model"].get("pretrained_checkpoint")
    if not (path and os.path.isdir(path)):
        model, _ = build_model_from_config(cfg, device=device, seed=seed)
        if path and os.path.exists(path):
            _import_reference(model, path, log)
        elif path:
            log.info(f"checkpoint {path} not found: seeded weights (seed {seed})")
        return cast_for_inference(model.eval(), torch.bfloat16)
    base = CK.read_base(path)
    model, _ = build_model_from_config(cfg, device=device, seed=base["seed"])
    if base["pretrained"]:
        if not os.path.exists(base["pretrained"]):
            raise FileNotFoundError(f"{path} was trained from {base['pretrained']}, which is missing")
        _import_reference(model, base["pretrained"], log)
    CK.check_base(path, dict(base, digest=CK.base_digest(model)))
    step, saved = CK.load_saved(path)
    params = dict(model.named_parameters())
    unknown = sorted(set(saved["params"]) - set(params))
    if unknown:
        raise ValueError(f"checkpoint {path} step {step}: {len(unknown)} parameters the model lacks: {unknown[:8]}")
    with torch.no_grad():
        for name, value in saved["params"].items():
            params[name].copy_(value.to(params[name].dtype))
    log.info(f"restored {len(saved['params'])} trained parameters from {path} step {step} over the base of "
             f"seed {base['seed']}" + (f" and {base['pretrained']}" if base["pretrained"] else ""))
    return cast_for_inference(model.eval(), torch.bfloat16)


def main(argv: Optional[list] = None) -> list[str]:
    """Run the generation; returns the directories written."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.emit_launcher:
        from camc2v_tpu_torch.utils.meta import launcher_script

        fwd = [a for a in argv if not a.startswith("--emit-launcher")]
        if args.emit_launcher in fwd:
            fwd.remove(args.emit_launcher)
        with open(args.emit_launcher, "w") as f:
            f.write(launcher_script(args.machine or "local", args.setup, MODULE, fwd))
        os.chmod(args.emit_launcher, 0o755)
        print(f"launcher written to {args.emit_launcher}")
        return []
    if args.shard_data:
        raise NotImplementedError("--shard-data: one data-parallel program over the local cards needs the "
                                  "port's mesh, which is not ported (ROADMAP queue 1, item 6)")
    from camc2v_tpu_torch.config_yaml import apply_dotlist, load_yaml
    from camc2v_tpu_torch.data.realestate10k import DataLoader, RealEstate10K
    from camc2v_tpu_torch.data.tokenizer import default_tokenizer
    from camc2v_tpu_torch.main.harness import generate_videos, setup_logger
    from camc2v_tpu_torch.utils.meta import apply_machine_config, process_from_env

    rank, world, local_rank = process_from_env()
    device = resolve_device(args.device, local_rank)
    cfg = apply_machine_config(apply_dotlist(load_yaml(args.config), args.overrides), args.machine)
    log = setup_logger(None, rank)
    model = load_model(cfg, args.ckpt, device, args.seed, log)

    tokenizer = default_tokenizer(args.bpe_path, model.config.clip_text.context_length)
    data_cfg = cfg.get("data", {}).get("params", {})
    split = data_cfg.get("test", data_cfg.get("validation", {}))
    ds_params = dict(split.get("params", {}))
    if args.sampling_strategy:
        ds_params["additional_cond_frames"] = args.sampling_strategy
    ds = RealEstate10K(tokenizer=tokenizer, **ds_params)
    dl = DataLoader(ds, batch_size=data_cfg.get("batch_size", 1), shuffle=False, drop_last=False,
                    num_workers=data_cfg.get("num_workers", 2), num_shards=world, shard_index=rank)
    if world > 1:
        log.info(f"generation: process {rank}/{world} over a rank-strided data shard on {device}")
    sample_kwargs = dict(ddim_steps=args.ddim_steps, ddim_eta=args.ddim_eta, sampler=args.sampler,
                         guidance_scale=args.cfg_scale, guidance_rescale=args.guidance_rescale,
                         timestep_spacing=args.timestep_spacing, camera_cfg=args.camera_cfg,
                         camera_cfg_scheduler=args.camera_cfg_scheduler)
    written = generate_videos(model, dl, args.out, tokenizer=tokenizer, sample_kwargs=sample_kwargs,
                              max_batches=args.num_videos, skip_existing=args.resume, seed=args.seed)
    log.info(f"wrote {len(written)} videos to {args.out}")
    return written


if __name__ == "__main__":
    main()
