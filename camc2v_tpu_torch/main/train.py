"""Training entry point of the port (`01_train.py` without the multi-host
launch).

    python -m camc2v_tpu_torch.main.train --config configs/models/camcontexti2v_256.yaml \\
        [--name NAME] [--logdir ./results] [--continue] [--max_steps N] [--bpe_path P] \\
        [--machine NAME] [--device cuda|cpu] [--seed S] [--debug] [key.path=value ...]

It reads the yaml and the dotlist overrides (`config_yaml`), then substitutes
the `--machine` registry entry's data roots (`utils/meta.py::
apply_machine_config`, as `01_train.py` does), builds the model
with seeded weights on `--device` (the card by default; without CUDA it
raises unless `--device cpu` is given), builds the RealEstate10K loaders from
the `data` section (1-4 context frames padded to 4 in the flagship yaml) and
the callbacks from `lightning`, and runs `main.harness.Trainer.fit`;
`--continue` resumes from the run's latest checkpoint. A `pretrained_checkpoint`
(or `--pretrained`) that exists is the reference's `.pt`: it is imported into
the seeded model (`utils/torch_import.py::load_reference_checkpoint`, keys
that match loaded, the rest reported in the log); one that does not exist
leaves the seeded weights. The checkpoint directory records that base
(`base.json`: seed, imported `.pt`, digest); `--continue` raises if the
weights made now differ from it.

The `lightning` keys read here: `trainer.{max_steps, accumulate_grad_batches,
gradient_clip_val, precision, val_check_interval, limit_val_batches,
log_every_n_steps}`, `callbacks.metrics_over_trainsteps_checkpoint.params.
{every_n_train_steps, max_to_keep}`, `callbacks.batch_logger.params.{
train_batch_frequency, log_images_kwargs, num_batches}` and `logger` (the
sinks of `main/loggers.py`).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional


def parse_args(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(prog="python -m camc2v_tpu_torch.main.train")
    ap.add_argument("--config", required=True, help="three-section yaml (model / data / lightning)")
    ap.add_argument("--name", default=None, help="experiment name (default: the config's stem)")
    ap.add_argument("--logdir", default="./results")
    ap.add_argument("--seed", type=int, default=20240101)
    ap.add_argument("--continue", dest="resume", action="store_true", help="resume from the latest checkpoint")
    ap.add_argument("--debug", action="store_true", help="numeric watcher and profiler, short logging intervals")
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--bpe_path", default=None, help="CLIP BPE merges file")
    ap.add_argument("--pretrained", default=None, help="reference .pt checkpoint to import")
    ap.add_argument("--machine", default=None,
                    help="machine-registry entry (camc2v_tpu_torch/utils/meta.py): substitutes "
                         "that machine's data roots into the config")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*", help="dotlist config overrides a.b.c=value")
    return ap.parse_intermixed_args(argv)


def _sample_kwargs(li: dict) -> dict:
    return dict(ddim_steps=li.get("ddim_steps", 25), ddim_eta=li.get("ddim_eta", 1.0),
                guidance_scale=li.get("unconditional_guidance_scale", 7.5),
                timestep_spacing=li.get("timestep_spacing", "uniform"),
                guidance_rescale=li.get("guidance_rescale", 0.0),
                enable_camera_condition=li.get("enable_camera_condition", True))


def main(argv: Optional[list] = None, callbacks: Optional[list] = None):
    """Run the training; returns (trainer, state). `callbacks` are added to
    the ones the yaml asks for."""
    args = parse_args(argv)
    import dataclasses

    import numpy as np

    from camc2v_tpu_torch.config_yaml import apply_dotlist, build_model_from_config, build_train_config, load_yaml
    from camc2v_tpu_torch.data.realestate10k import DataLoader, RealEstate10K
    from camc2v_tpu_torch.data.tokenizer import default_tokenizer
    from camc2v_tpu_torch.main import callbacks as CB
    from camc2v_tpu_torch.main.harness import Trainer, init_workspace, make_sample_logger, setup_logger
    from camc2v_tpu_torch.main.loggers import build_sinks
    from camc2v_tpu_torch.parallel import trainer as TR
    from camc2v_tpu_torch.utils import checkpoint as CK
    from camc2v_tpu_torch.utils.meta import apply_machine_config

    cfg = apply_machine_config(apply_dotlist(load_yaml(args.config), args.overrides), args.machine)
    name = args.name or os.path.splitext(os.path.basename(args.config))[0]
    dirs = init_workspace(name, args.logdir, cfg)
    log = setup_logger(dirs["workdir"])
    np.random.seed(args.seed)

    model, pretrained = build_model_from_config(cfg, device=args.device, seed=args.seed)
    device = next(model.parameters()).device
    log.info(f"model: {type(model).__name__} on {device}, {sum(p.numel() for p in model.parameters()):,} parameters")
    ckpt_path = args.pretrained or pretrained
    if ckpt_path and os.path.exists(ckpt_path):
        from camc2v_tpu_torch.utils.torch_import import load_reference_checkpoint

        report = load_reference_checkpoint(model, ckpt_path)
        log.info(f"imported {len(report['mapped'])} tensors from {ckpt_path} "
                 f"({len(report['unmatched_ckpt'])} unmatched, {len(report['missing_params'])} ours missing, "
                 f"{len(report['shape_mismatch'])} shape mismatches)")
    elif ckpt_path:
        log.info(f"pretrained checkpoint {ckpt_path} not found: seeded weights (seed {args.seed})")
        ckpt_path = None
    # what the checkpoints' masters are laid over again (utils/checkpoint.py)
    base = dict(seed=args.seed, pretrained=os.path.abspath(ckpt_path) if ckpt_path else None,
                digest=CK.base_digest(model))
    if args.resume and os.path.exists(os.path.join(dirs["ckptdir"], CK.BASE_FILE)):
        CK.check_base(dirs["ckptdir"], base)
    else:
        CK.write_base(dirs["ckptdir"], base)

    tokenizer = default_tokenizer(args.bpe_path, model.config.clip_text.context_length)
    data_cfg = cfg.get("data", {}).get("params", {})
    bs = data_cfg.get("batch_size", 1)
    train_ds = RealEstate10K(tokenizer=tokenizer, **{"seed": args.seed, **data_cfg.get("train", {}).get("params", {})})
    train_dl = DataLoader(train_ds, batch_size=bs, shuffle=True, seed=args.seed,
                          num_workers=data_cfg.get("num_workers", 2))
    val_dl = None
    if "validation" in data_cfg:
        val_ds = RealEstate10K(tokenizer=tokenizer, max_samples=data_cfg.get("validation_max_n_samples"),
                               **{"seed": args.seed, **data_cfg["validation"].get("params", {})})
        val_dl = DataLoader(val_ds, batch_size=bs, shuffle=False)

    tr_cfg = build_train_config(cfg)
    if args.max_steps:
        tr_cfg = dataclasses.replace(tr_cfg, max_steps=args.max_steps)
    state = TR.init_train_state(tr_cfg, model)
    log.info(f"trainable: {sum(p.numel() for p in state.params):,} fp32 parameters in {len(state.params)} tensors")

    lightning = cfg.get("lightning", {})
    trainer_cfg = lightning.get("trainer", {})
    cb_cfg = lightning.get("callbacks", {})
    log_every = 1 if args.debug else trainer_cfg.get("log_every_n_steps", 50)
    sinks = build_sinks(lightning.get("logger"), dirs["loginfo"], run_name=name)
    cbs = [CB.ProgressPrinter(interval=5 if args.debug else 20, max_steps=tr_cfg.max_steps),
           CB.MetricsLogger(dirs["loginfo"], interval=log_every, sinks=sinks),
           CB.DeviceMonitor(interval=10 if args.debug else 100, device=device)]
    if args.debug:
        cbs += [CB.LiveProfiler(interval=5, device=device), CB.ModelWatcher(raise_on_error=False)]
    logger_cfg = cb_cfg.get("batch_logger", {}).get("params", {})
    if val_dl is not None and logger_cfg:
        sample_fn = make_sample_logger(model, val_dl, os.path.join(dirs["workdir"], "images"), tokenizer=tokenizer,
                                       sample_kwargs=_sample_kwargs(logger_cfg.get("log_images_kwargs", {})),
                                       num_batches=logger_cfg.get("num_batches", 1), sinks=sinks)
        cbs.append(CB.ImageLogger(every_n_steps=logger_cfg.get("train_batch_frequency", 2500), sample_fn=sample_fn,
                                  log_first_iteration=logger_cfg.get("log_first_iteration", False)))
    cbs += list(callbacks or [])

    # the epipolar-mask freeze schedule (reference camcontexti2v.py:771-776)
    flag_schedule = None
    freeze_steps = getattr(model.config, "epipolar_mask_freeze_steps", None)
    if freeze_steps:
        flag_schedule = [(0, {"adaptor_use_mask": False}), (freeze_steps, {"adaptor_use_mask": True})]
    ckpt_cfg = cb_cfg.get("metrics_over_trainsteps_checkpoint", {}).get("params", {})
    trainer = Trainer(model, tr_cfg, train_dl, val_dataloader=val_dl, callbacks=cbs, ckpt_dir=dirs["ckptdir"],
                      ckpt_every_n_steps=ckpt_cfg.get("every_n_train_steps", 5000),
                      max_to_keep=ckpt_cfg.get("max_to_keep"),
                      val_every_n_steps=trainer_cfg.get("val_check_interval"),
                      val_max_batches=trainer_cfg.get("limit_val_batches", 8), tokenizer=tokenizer,
                      seed=args.seed, flag_schedule=flag_schedule, log_every_n_steps=log_every)
    state = trainer.fit(state, resume=args.resume)
    for cb in cbs:
        if hasattr(cb, "close"):
            cb.close()
    log.info(f"training finished at step {state.step}")
    return trainer, state


if __name__ == "__main__":
    main()
