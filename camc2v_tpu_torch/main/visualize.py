"""Single-image demo, the port's `04_visualize.py`: headless generation, or
the gradio UI where gradio is installed.

    python -m camc2v_tpu_torch.main.visualize --models-json configs/demo/models.json \\
        --image img.png --prompt "a room" --trajectory-name "zoom in" [--chunks 2] [--loop] \\
        [--bezier-a 0.3 --bezier-b 0.7] [--device cuda|cpu] [--out results/demo]

`--models name=config.yaml ...` or `--models-json` name the models
(`--model` picks one, default the first); `--image` is read by
`data/image_io.py` (8-bit PNGs without OpenCV); `--trajectory` is a pose txt,
`--trajectory-name` a name in `--poses-json`. The engine is
`main/runtime.py::Image2Video` on `--device` (the card by default; without
CUDA it raises unless `--device cpu` is given). The video is `.mp4` where
OpenCV is installed, else `.npz`. `--gradio` falls back to headless when
gradio is not installed.
"""

from __future__ import annotations

import argparse
import json
import pathlib
from typing import Optional

import numpy as np


def parse_args(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(prog="python -m camc2v_tpu_torch.main.visualize")
    ap.add_argument("--models", nargs="+", default=None, help="name=config.yaml pairs")
    ap.add_argument("--image", default=None)
    ap.add_argument("--prompt", default="")
    ap.add_argument("--trajectory", default=None, help="pose txt (w2c rows)")
    ap.add_argument("--trajectory-name", default=None,
                    help="named pose from --poses-json (e.g. 'zoom in', 'orbit left')")
    ap.add_argument("--poses-json", default="configs/demo/camera_poses.json",
                    help="name -> pose txt registry (reference configs/demo/camera_poses.json)")
    ap.add_argument("--models-json", default=None,
                    help="load model name=config pairs from a models.json "
                         "(reference configs/demo/models.json) instead of --models")
    ap.add_argument("--model", default=None, help="model name to run (default: first)")
    ap.add_argument("--chunks", type=int, default=1, help="auto-regressive 16-frame chunks")
    ap.add_argument("--loop", action="store_true")
    ap.add_argument("--bezier-a", type=float, default=None)
    ap.add_argument("--bezier-b", type=float, default=None)
    ap.add_argument("--trace-extract-ratio", type=float, default=1.0)
    ap.add_argument("--trace-scale-factor", type=float, default=1.0)
    ap.add_argument("--cfg-scale", type=float, default=7.5)
    ap.add_argument("--camera-cfg", type=float, default=1.0)
    ap.add_argument("--ddim-steps", type=int, default=25)
    ap.add_argument("--out", default="results/demo")
    ap.add_argument("--video-length", type=int, default=16)
    ap.add_argument("--resolution", type=int, nargs=2, default=(256, 256), metavar=("H", "W"))
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16", help="compute dtype")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--gradio", action="store_true")
    return ap.parse_args(argv)


def build_engine(args):
    import torch

    from camc2v_tpu_torch.main.generate import resolve_device
    from camc2v_tpu_torch.main.harness import setup_logger
    from camc2v_tpu_torch.main.runtime import Image2Video

    device = resolve_device(args.device)
    setup_logger(None)
    if args.models_json:
        with open(args.models_json) as f:
            configs = {name: spec["config_file"] for name, spec in json.load(f).items()}
    elif args.models:
        configs = dict(m.split("=", 1) for m in args.models)
    else:
        raise ValueError("--models or --models-json required")
    engine = Image2Video(configs, result_dir=args.out, video_length=args.video_length,
                         resolution=tuple(args.resolution), dtype=getattr(torch, args.dtype), device=device)
    return engine, configs


def resolve_trajectory(args) -> Optional[str]:
    """--trajectory wins; --trajectory-name resolves through the
    camera_poses.json registry (reference demo contract)."""
    if args.trajectory:
        return args.trajectory
    if not args.trajectory_name:
        return None
    with open(args.poses_json) as f:
        registry = json.load(f)
    p = pathlib.Path(registry[args.trajectory_name])
    if not p.is_absolute() and not p.exists():
        p = pathlib.Path(args.poses_json).parent.parent.parent / p
    return str(p)


def run_headless(args) -> str:
    from camc2v_tpu_torch.data.image_io import read_image
    from camc2v_tpu_torch.main.runtime import load_trajectory_txt

    engine, configs = build_engine(args)
    if not args.image:
        raise ValueError("--image required in headless mode")
    img = read_image(args.image)
    traj_path = resolve_trajectory(args)
    traj = load_trajectory_txt(traj_path) if traj_path else None
    path = engine.get_image(
        args.model or next(iter(configs)),
        img,
        args.prompt,
        trajectory=traj,
        num_chunks=args.chunks,
        loop=args.loop,
        bezier_coef_a=args.bezier_a,
        bezier_coef_b=args.bezier_b,
        trace_extract_ratio=args.trace_extract_ratio,
        trace_scale_factor=args.trace_scale_factor,
        ddim_steps=args.ddim_steps,
        guidance_scale=args.cfg_scale,
        camera_cfg=args.camera_cfg,
    )
    print(path)
    return path


def run_gradio(args) -> None:
    import gradio as gr

    from camc2v_tpu_torch.main.runtime import load_trajectory_txt

    engine, configs = build_engine(args)
    pose_names = ["(none)"]
    pose_registry = {}
    try:
        with open(args.poses_json) as f:
            pose_registry = json.load(f)
        pose_names += list(pose_registry)
    except OSError:
        pass

    def generate(model_name, image, prompt, pose_name, traj_file, chunks, loop, cfg_scale, camera_cfg):
        if traj_file:
            traj = load_trajectory_txt(traj_file.name)
        elif pose_name and pose_name != "(none)":
            traj = load_trajectory_txt(pose_registry[pose_name])
        else:
            traj = None
        return engine.get_image(
            model_name, np.asarray(image), prompt, trajectory=traj,
            num_chunks=int(chunks), loop=bool(loop),
            guidance_scale=float(cfg_scale), camera_cfg=float(camera_cfg),
        )

    with gr.Blocks(title="CamC2V") as demo:
        gr.Markdown("# CamContextI2V — camera-controlled image-to-video")
        with gr.Row():
            model_name = gr.Dropdown(list(configs), value=next(iter(configs)), label="model")
            chunks = gr.Slider(1, 8, 1, step=1, label="auto-regressive chunks")
            loop = gr.Checkbox(label="loop trajectory")
        with gr.Row():
            image = gr.Image(label="reference frame")
            with gr.Column():
                prompt = gr.Textbox(label="prompt")
                pose_name = gr.Dropdown(pose_names, value="(none)", label="camera pose")
                traj_file = gr.File(label="camera pose txt (overrides)")
                cfg_scale = gr.Slider(1.0, 15.0, 7.5, label="CFG scale")
                camera_cfg = gr.Slider(1.0, 3.0, 1.0, label="camera CFG")
                btn = gr.Button("Generate")
        out = gr.Video(label="generated")
        btn.click(generate, [model_name, image, prompt, pose_name, traj_file, chunks, loop, cfg_scale, camera_cfg], out)
    demo.launch()


def main(argv: Optional[list] = None) -> Optional[str]:
    """Run the demo; returns the headless run's video path."""
    args = parse_args(argv)
    if args.gradio:
        try:
            run_gradio(args)
            return None
        except ImportError:
            print("gradio not installed — falling back to headless mode")
    return run_headless(args)


if __name__ == "__main__":
    main()
