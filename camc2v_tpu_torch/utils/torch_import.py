"""Import of the reference PyTorch checkpoint (a copy of
`camc2v_tpu/utils/torch_import.py`'s import side).

The reference's state-dict names (Lightning `state_dict`, DeepSpeed
`module.`-wrapped or plain; reference main/utils_train.py:165-214,
main/runtime.py:85-128) map onto the JAX package's parameter names, with the
`framestride_embed -> fps_embedding` migration (utils_train.py:189-196). The
port's parameters carry those same names (`utils/weights.py`), so the JAX
package's key map and layout transforms are copied (names aside, unchanged), and
`import_state_dict` ends where the JAX import's tree would go into the port:
`load_jax_params`'s name and layout map. The two layout transforms
(torch -> JAX -> torch) are transposes, so the import is exact.

Weight-layout transforms (torch -> JAX, channels-last):
  Linear   (out, in)            -> kernel (in, out)
  Conv2d   (out, in, kh, kw)    -> kernel (kh, kw, in, out)
  Conv3d   (out, in, kt, kh, kw)-> kernel (kt, kh, kw, in, out)
  Norms    weight/bias          -> scale/bias
  CLIP MHA in_proj_weight (3D, D) -> in_proj kernel (D, 3D)

Unmapped reference keys (schedule buffers, EMA copies, the dead penultimate
CLIP block, ln_post/proj of the vision tower) are reported, not silently
dropped. Export back to the reference format (`export_state_dict`,
`save_torch_checkpoint`) is not ported.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch
from torch import nn

from camc2v_tpu_torch.utils.weights import _to_torch_layout, jax_to_torch_name

# reference keys that are intentionally not imported
_SKIP_PATTERNS = [
    r"^betas$", r"alphas_cumprod", r"^sqrt_", r"^log_one_minus", r"^posterior_",
    r"^lvlb_weights$", r"^logvar$", r"^scale_arr$", r"^ddim_", r"^model_ema\.",
    r"^cond_stage_model\.model\.attn_mask$",
    r"^cond_stage_model\.model\.text_projection$",
    r"^cond_stage_model\.model\.logit_scale$",
    r"^cond_stage_model\.model\.token_embedding\.weight$",  # handled explicitly
    r"^embedder\.model\.visual\.ln_post\.", r"^embedder\.model\.visual\.proj$",
    r"^embedder\.mean$", r"^embedder\.std$",
    r"pos_encoder\.pe$",  # fixed sinusoidal buffer, regenerated
    r"\.mask$",  # causal-mask buffers
]


def _unet_block_map(cfg) -> dict[str, str]:
    """reference 'input_blocks.N.M' style prefixes -> our module names.

    Mirrors the construction loop of both UNets (reference:
    openaimodel3d.py:383-565; ours: nn/unet3d.py setup).
    """
    m = {"input_blocks.0.0": "conv_in"}
    if cfg.addition_attention:
        m["init_attn.0"] = "init_attn"
    blk, ds = 0, 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            tid = blk + 1
            m[f"input_blocks.{tid}.0"] = f"in_{blk}_res"
            li = 1
            if ds in cfg.attention_resolutions:
                m[f"input_blocks.{tid}.{li}"] = f"in_{blk}_spatial"
                li += 1
                if cfg.temporal_attention:
                    m[f"input_blocks.{tid}.{li}"] = f"in_{blk}_temporal"
                    li += 1
            blk += 1
        if level != len(cfg.channel_mult) - 1:
            tid = blk + 1
            # Downsample module: torch child is 'op'; resblock_updown uses ResBlock
            m[f"input_blocks.{tid}.0"] = f"in_{blk}_down"
            blk += 1
            ds *= 2
    mid = ["mid_res1", "mid_spatial"] + (["mid_temporal"] if cfg.temporal_attention else []) + ["mid_res2"]
    for i, name in enumerate(mid):
        m[f"middle_block.{i}"] = name
    blk = 0
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            m[f"output_blocks.{blk}.0"] = f"out_{blk}_res"
            li = 1
            if ds in cfg.attention_resolutions:
                m[f"output_blocks.{blk}.{li}"] = f"out_{blk}_spatial"
                li += 1
                if cfg.temporal_attention:
                    m[f"output_blocks.{blk}.{li}"] = f"out_{blk}_temporal"
                    li += 1
            if level and i == cfg.num_res_blocks:
                m[f"output_blocks.{blk}.{li}"] = f"out_{blk}_up"
                ds //= 2
            blk += 1
    m["out.0"] = "out_norm"
    m["out.2"] = "out_conv"
    return m


# (regex, replacement) applied to the key AFTER block-prefix resolution.
_SUBMODULE_RULES = [
    # ResBlock internals (reference ResBlock Sequential indices)
    (r"in_layers\.0\.(weight|bias)$", r"in_norm/GroupNorm_0/\1"),
    (r"in_layers\.2\.(weight|bias)$", r"in_conv/\1"),
    (r"emb_layers\.1\.(weight|bias)$", r"emb_proj/\1"),
    (r"out_layers\.0\.(weight|bias)$", r"out_norm/GroupNorm_0/\1"),
    (r"out_layers\.3\.(weight|bias)$", r"out_conv/\1"),
    (r"skip_connection\.(weight|bias)$", r"skip/\1"),
    (r"temopral_conv\.conv1\.0\.(weight|bias)$", r"temporal_conv/conv1_norm/GroupNorm_0/\1"),
    (r"temopral_conv\.conv1\.2\.(weight|bias)$", r"temporal_conv/conv1_conv/\1"),
    (r"temopral_conv\.conv([234])\.0\.(weight|bias)$", r"temporal_conv/conv\1_norm/GroupNorm_0/\2"),
    (r"temopral_conv\.conv([234])\.3\.(weight|bias)$", r"temporal_conv/conv\1_conv/\2"),
    # Up/Downsample keep their child names (op / conv) — default '.'->'/' applies
    # final out GroupNorm ('out.0' in the reference Sequential)
    (r"^out_norm\.(weight|bias)$", r"out_norm/GroupNorm_0/\1"),
    # transformer containers
    (r"transformer_blocks\.(\d+)\.", r"block_\1/"),
    (r"\bnorm\.(weight|bias)$", r"norm/GroupNorm_0/\1"),
    (r"norm([123])\.(weight|bias)$", r"norm\1/LayerNorm_0/\2"),
    (r"proj_in\.(weight|bias)$", r"proj_in/\1"),
    (r"proj_out\.(weight|bias)$", r"proj_out/\1"),
    (r"attn(\d)\.to_(q|k|v)\.weight$", r"attn\1/to_\2/weight"),
    (r"attn(\d)\.to_(k|v)_ip\.weight$", r"attn\1/to_\2_ip/weight"),
    (r"attn(\d)\.to_out\.0\.(weight|bias)$", r"attn\1/to_out/\2"),
    (r"attn(\d)\.relative_position_(k|v)\.embeddings_table$", r"attn\1/relative_position_\2/embeddings_table"),
    (r"\balpha$", r"alpha"),
    (r"ff\.net\.0\.proj\.(weight|bias)$", r"ff/geglu/proj/\1"),
    (r"ff\.net\.2\.(weight|bias)$", r"ff/fc2/\1"),
    # camera extras on temporal blocks
    (r"pluker_projection\.(weight|bias)$", r"pluker_projection/\1"),
    (r"cc_projection\.(weight|bias)$", r"cc_projection/\1"),
    (r"epipolar\.epipolar_attn\.to_(q|k|v)\.weight$", r"epipolar/epipolar_attn/to_\1/weight"),
    (r"epipolar\.epipolar_attn\.to_out\.0\.(weight|bias)$", r"epipolar/epipolar_attn/to_out/\1"),
    (r"epipolar\.epipolar_attn\.register_tokens$", r"epipolar/epipolar_attn/register_tokens"),
    # time embeddings
    (r"^time_embed\.0\.(weight|bias)$", r"time_embed/fc1/\1"),
    (r"^time_embed\.2\.(weight|bias)$", r"time_embed/fc2/\1"),
    (r"^fps_embedding\.0\.(weight|bias)$", r"fps_embedding/fc1/\1"),
    (r"^fps_embedding\.2\.(weight|bias)$", r"fps_embedding/fc2/\1"),
]

_VAE_RULES = [
    (r"^(encoder|decoder)\.conv_in\.(weight|bias)$", r"\1/conv_in/\2"),
    (r"^(encoder|decoder)\.conv_out\.(weight|bias)$", r"\1/conv_out/\2"),
    (r"^(encoder|decoder)\.norm_out\.(weight|bias)$", r"\1/norm_out/GroupNorm_0/\2"),
    (r"^encoder\.down\.(\d+)\.block\.(\d+)\.", r"encoder/down_\1_block_\2."),
    (r"^encoder\.down\.(\d+)\.downsample\.conv\.(weight|bias)$", r"encoder/down_\1_downsample/\2"),
    (r"^encoder\.down\.(\d+)\.attn\.(\d+)\.", r"encoder/down_\1_attn_\2."),
    (r"^decoder\.up\.(\d+)\.block\.(\d+)\.", r"decoder/up_\1_block_\2."),
    (r"^decoder\.up\.(\d+)\.upsample\.conv\.(weight|bias)$", r"decoder/up_\1_upsample/\2"),
    (r"^decoder\.up\.(\d+)\.attn\.(\d+)\.", r"decoder/up_\1_attn_\2."),
    (r"^(encoder|decoder)\.mid\.block_([12])\.", r"\1/mid_block_\2."),
    (r"^(encoder|decoder)\.mid\.attn_1\.", r"\1/mid_attn_1."),
    (r"^quant_conv\.(weight|bias)$", r"quant_conv/\1"),
    (r"^post_quant_conv\.(weight|bias)$", r"post_quant_conv/\1"),
    # inside AE blocks (after the block prefix above; '.' kept until here)
    (r"\.norm([12])\.(weight|bias)$", r"/norm\1/GroupNorm_0/\2"),
    (r"\.conv([12])\.(weight|bias)$", r"/conv\1/\2"),
    (r"\.nin_shortcut\.(weight|bias)$", r"/nin_shortcut/\1"),
    (r"\.norm\.(weight|bias)$", r"/norm/GroupNorm_0/\1"),
    (r"\.(q|k|v|proj_out)\.(weight|bias)$", r"/\1/\2"),
]

_CLIP_RULES = [
    (r"^positional_embedding$", r"positional_embedding"),
    (r"^class_embedding$", r"class_embedding"),
    (r"^conv1\.weight$", r"conv1/weight"),
    (r"^ln_pre\.(weight|bias)$", r"ln_pre/LayerNorm_0/\1"),
    (r"^ln_final\.(weight|bias)$", r"ln_final/LayerNorm_0/\1"),
    (r"^transformer\.resblocks\.(\d+)\.ln_([12])\.(weight|bias)$", r"resblock_\1/ln_\2/LayerNorm_0/\3"),
    (r"^transformer\.resblocks\.(\d+)\.attn\.in_proj_(weight|bias)$", r"resblock_\1/attn/in_proj/\2"),
    (r"^transformer\.resblocks\.(\d+)\.attn\.out_proj\.(weight|bias)$", r"resblock_\1/attn/out_proj/\2"),
    (r"^transformer\.resblocks\.(\d+)\.mlp\.c_(fc|proj)\.(weight|bias)$", r"resblock_\1/mlp/c_\2/\3"),
]

_RESAMPLER_RULES = [
    (r"^latents$", r"latents"),
    (r"^proj_(in|out)\.(weight|bias)$", r"proj_\1/\2"),
    (r"^norm_out\.(weight|bias)$", r"norm_out/LayerNorm_0/\1"),
    (r"^layers\.(\d+)\.0\.norm([12])\.(weight|bias)$", r"attn_\1/norm\2/LayerNorm_0/\3"),
    (r"^layers\.(\d+)\.0\.to_(q|kv|k|v)\.weight$", r"attn_\1/to_\2/weight"),
    (r"^layers\.(\d+)\.0\.to_out\.weight$", r"attn_\1/to_out/weight"),
    (r"^layers\.(\d+)\.0\.to_out\.0\.(weight|bias)$", r"attn_\1/to_out/\2"),
    (r"^layers\.(\d+)\.0\.register_tokens$", r"attn_\1/register_tokens"),
    (r"^layers\.(\d+)\.1\.0\.(weight|bias)$", r"ff_\1/norm/LayerNorm_0/\2"),
    (r"^layers\.(\d+)\.1\.1\.weight$", r"ff_\1/fc1/weight"),
    (r"^layers\.(\d+)\.1\.3\.weight$", r"ff_\1/fc2/weight"),
    (r"^timestep_embedding_func\.0\.(weight|bias)$", r"temb_fc1/\1"),
    (r"^timestep_embedding_func\.2\.(weight|bias)$", r"temb_fc2/\1"),
    (r"^plucker_in\.(weight|bias)$", r"plucker_in/\1"),
]

_POSE_ENCODER_RULES = [
    (r"^encoder_conv_in\.(weight|bias)$", r"conv_in/\1"),
    (r"^encoder_down_conv_blocks\.(\d+)\.(\d+)\.in_conv\.(weight|bias)$", r"level\1_res\2/in_conv/\3"),
    (r"^encoder_down_conv_blocks\.(\d+)\.(\d+)\.block([12])\.(weight|bias)$", r"level\1_res\2/block\3/\4"),
    (r"^encoder_down_conv_blocks\.(\d+)\.(\d+)\.skep\.(weight|bias)$", r"level\1_res\2/skep/\3"),
    (r"^encoder_down_conv_blocks\.(\d+)\.(\d+)\.down_opt\.op\.(weight|bias)$", r"level\1_res\2/down_conv/\3"),
    (r"^encoder_down_attention_blocks\.(\d+)\.(\d+)\.attention_blocks\.0\.to_(q|k|v)\.weight$", r"level\1_attn\2/to_\3/weight"),
    (r"^encoder_down_attention_blocks\.(\d+)\.(\d+)\.attention_blocks\.0\.to_out\.0\.(weight|bias)$", r"level\1_attn\2/to_out/\3"),
    (r"^encoder_down_attention_blocks\.(\d+)\.(\d+)\.norms\.0\.(weight|bias)$", r"level\1_attn\2/norm/LayerNorm_0/\3"),
    (r"^encoder_down_attention_blocks\.(\d+)\.(\d+)\.ff\.net\.0\.proj\.(weight|bias)$", r"level\1_attn\2/ff_proj/\3"),
    (r"^encoder_down_attention_blocks\.(\d+)\.(\d+)\.ff\.net\.2\.(weight|bias)$", r"level\1_attn\2/ff_out/\3"),
    (r"^encoder_down_attention_blocks\.(\d+)\.(\d+)\.ff_norm\.(weight|bias)$", r"level\1_attn\2/ff_norm/LayerNorm_0/\3"),
]


def _apply_rules(key: str, rules) -> Optional[str]:
    for pat, repl in rules:
        new, n = re.subn(pat, repl, key)
        if n:
            key = new
    return key


def _leaf_name(jax_key: str, torch_rank: int) -> tuple[str, bool]:
    """Map the trailing torch leaf to the JAX leaf + need-transform flag."""
    if jax_key.endswith("/weight"):
        base = jax_key[: -len("/weight")]
        if "Norm_0" in base.rsplit("/", 1)[-1] or base.endswith("GroupNorm_0") or base.endswith("LayerNorm_0"):
            return base + "/scale", False
        return base + "/kernel", True
    if jax_key.endswith("/bias"):
        return jax_key, False
    return jax_key, False


def _transform(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 3 and arr.shape[-1] == 1:
        # Conv1d(k=1) == Linear. The reference's init_attn TemporalTransformer
        # is built without use_linear (openaimodel3d.py:389-402), so its
        # proj_in/proj_out are (out, in, 1) conv kernels.
        return arr[:, :, 0].T
    if arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)
    if arr.ndim == 5:
        return arr.transpose(2, 3, 4, 1, 0)
    return arr


def map_reference_key(key: str, unet_cfg=None, _unet_map_cache={}) -> Optional[str]:
    """One reference state-dict key -> 'component/jax/path' (or None to skip)."""
    for pat in _SKIP_PATTERNS:
        if re.search(pat, key):
            if key == "cond_stage_model.model.token_embedding.weight":
                return "clip_text/token_embedding"
            return None
    # DeepSpeed 'module.' unwrap + framestride migration
    if key.startswith("module."):
        key = key[len("module.") :]
    key = key.replace("framestride_embed", "fps_embedding")

    if key.startswith("model.diffusion_model."):
        rest = key[len("model.diffusion_model.") :]
        assert unet_cfg is not None
        cache_key = id(unet_cfg)
        if cache_key not in _unet_map_cache:
            _unet_map_cache[cache_key] = _unet_block_map(unet_cfg)
        block_map = _unet_map_cache[cache_key]
        # longest-prefix block resolution
        for tprefix in sorted(block_map, key=len, reverse=True):
            if rest.startswith(tprefix + "."):
                rest = block_map[tprefix] + "." + rest[len(tprefix) + 1 :]
                break
        mapped = _apply_rules(rest, _SUBMODULE_RULES)
        return "unet/" + mapped.replace(".", "/")
    if key.startswith("first_stage_model."):
        mapped = _apply_rules(key[len("first_stage_model.") :], _VAE_RULES)
        return "vae/" + mapped.replace(".", "/")
    if key.startswith("cond_stage_model.model."):
        mapped = _apply_rules(key[len("cond_stage_model.model.") :], _CLIP_RULES)
        return "clip_text/" + mapped.replace(".", "/")
    if key.startswith("embedder.model.visual."):
        mapped = _apply_rules(key[len("embedder.model.visual.") :], _CLIP_RULES)
        return "clip_vision/" + mapped.replace(".", "/")
    if key.startswith("image_proj_model."):
        mapped = _apply_rules(key[len("image_proj_model.") :], _RESAMPLER_RULES)
        return "image_proj/" + mapped.replace(".", "/")
    if key.startswith("pose_encoder."):
        mapped = _apply_rules(key[len("pose_encoder.") :], _POSE_ENCODER_RULES)
        return "pose_encoder/" + mapped.replace(".", "/")
    if key.startswith("multi_cond_latent_adaptor."):
        mapped = _apply_rules(key[len("multi_cond_latent_adaptor.") :], _RESAMPLER_RULES)
        return "adaptor/" + mapped.replace(".", "/")
    if key.startswith("multi_cond_in_projection."):
        return "zero_conv/" + key[len("multi_cond_in_projection.") :]
    return None


def import_state_dict(module: nn.Module, state_dict: dict, unet_cfg, strict: bool = False) -> dict:
    """Load a reference state dict into the port model `module` in place.

    Each reference key maps to its JAX name (`map_reference_key`, the leaf
    named by `_leaf_name`, the kernel transformed by `_transform`), then to
    the port parameter of that name in the port's layout. Returns the report
    of the JAX `import_state_dict`: "mapped" (reference key, JAX name),
    "unmatched_ckpt" (reference keys that name no parameter),
    "missing_params" (the port's names of the parameters no key filled) and
    "shape_mismatch" (key, JAX name, shape given, shape wanted). The
    reference's strict -> lax fallback (utils_train.py:197-205): with strict,
    an unmatched key or a shape mismatch raises before anything is copied;
    without it, what matches is loaded and the rest reported."""
    params = dict(module.named_parameters())
    report = {"mapped": [], "unmatched_ckpt": [], "missing_params": [], "shape_mismatch": []}
    staged = []
    for key, arr in state_dict.items():
        arr = arr.detach().cpu().numpy() if torch.is_tensor(arr) else np.asarray(arr)
        jax_key = map_reference_key(key, unet_cfg)
        if jax_key is None:
            continue
        jax_key, needs_transform = _leaf_name(jax_key, arr.ndim)
        name = jax_to_torch_name(jax_key)
        if name not in params:
            report["unmatched_ckpt"].append(key)
            continue
        value = _transform(arr) if (needs_transform and jax_key.endswith("kernel")) else arr
        p = params[name]
        if jax_key.endswith("/kernel") and value.ndim not in (2, 4, 5):
            report["shape_mismatch"].append((key, jax_key, tuple(value.shape), tuple(p.shape)))
            continue
        value = _to_torch_layout(jax_key, value)
        if tuple(value.shape) != tuple(p.shape):
            report["shape_mismatch"].append((key, jax_key, tuple(value.shape), tuple(p.shape)))
            continue
        staged.append((p, value))
        report["mapped"].append((key, jax_key))
    filled = {jax_to_torch_name(t) for _, t in report["mapped"]}
    report["missing_params"] = [n for n in params if n not in filled]
    if strict and (report["unmatched_ckpt"] or report["shape_mismatch"]):
        raise ValueError(
            f"strict import failed: {len(report['unmatched_ckpt'])} unmatched, "
            f"{len(report['shape_mismatch'])} shape mismatches; first: "
            f"{(report['unmatched_ckpt'] or report['shape_mismatch'])[:5]}"
        )
    with torch.no_grad():
        for p, value in staged:
            p.copy_(torch.from_numpy(np.array(value, order="C", copy=True)).to(p.dtype))
    return report


def load_torch_checkpoint(path: str) -> dict[str, np.ndarray]:
    """Read a .pt/.ckpt file into numpy (handles Lightning/DeepSpeed wrapping)."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd, dict) and "module" in sd and isinstance(sd["module"], dict):
        sd = sd["module"]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in sd.items()}




def load_reference_checkpoint(model: nn.Module, path: str, strict: bool = False) -> dict:
    """Import the reference `.pt`/`.ckpt` at `path` into the port model
    `model` in place (`import_state_dict` on the model's UNet config);
    returns the import's report."""
    return import_state_dict(model, load_torch_checkpoint(path), model.config.unet, strict=strict)
