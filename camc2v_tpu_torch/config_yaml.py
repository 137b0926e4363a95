"""The reference's three-section yaml (model / data / lightning) onto the
port's configurations and models (`camc2v_tpu/config_yaml.py`).

    cfg = apply_dotlist(load_yaml("configs/models/camcontexti2v_256.yaml"), ["data.params.batch_size=1"])
    model, pretrained = build_model_from_config(cfg, device="cuda")
    train_config = build_train_config(cfg)

The yaml files are read by a small reader of the subset `configs/**/*.yaml`
use (`parse_yaml`): block maps by indentation, one-line flow lists and
flow maps, plain and quoted scalars resolved as PyYAML's `safe_load`
resolves them (YAML 1.1: `1e-4` without a dot stays a string, `yes`/`on`
are booleans), comments, and anchors that are defined but never aliased. It
raises on anything else (block lists, aliases, merge keys, tags, block
scalars), so a file it reads gives what `safe_load` gives. The port has its own reader
because the machines with the card need not have PyYAML.

The `target:` dotted paths and `params:` keys are the JAX bridge's;
MotionCtrl and CameraCtrl get their configurations, and their models raise
at construction (the UNet's `camera_mode` is not ported). CLI dotlist
overrides merge last, values read by the same scalar rules.
"""

from __future__ import annotations

import re
from typing import Any, Optional

import torch

from camc2v_tpu_torch.config import (
    AdaptorConfig,
    CameraControlConfig,
    CamContextI2VConfig,
    CamI2VConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
    DynamiCrafterConfig,
    EpipolarConfig,
    MotionCtrlConfig,
    PoseEncoderConfig,
    ResamplerConfig,
    UNetConfig,
    VAEConfig,
)
from camc2v_tpu_torch.parallel.trainer import TrainConfig

# ------------------------------------------------------------------ reader

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")}}
_INT = re.compile(r"^[-+]?(?:0b[01_]+|0x[0-9a-fA-F_]+|0[0-7_]+|0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


class YamlSubsetError(ValueError):
    """The text uses YAML outside the subset this reader takes."""


def resolve_scalar(text: str) -> Any:
    """A plain scalar as PyYAML's safe_load resolves it (YAML 1.1 rules;
    sexagesimal numbers are outside the subset)."""
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        sign = -1 if text[0] == "-" else 1
        body = text.lstrip("+-").replace("_", "")
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if len(body) > 1 and body[0] == "0":
            return sign * int(body, 8)
        return sign * int(body)
    if _FLOAT.match(text):
        low = text.replace("_", "").lower()
        if low.endswith("nan"):
            return float("nan")
        if low.endswith("inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        return float(low)
    if re.match(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$", text):
        raise YamlSubsetError(f"sexagesimal number {text!r}")
    return text


def _quoted(s: str, i: int) -> tuple[str, int]:
    """The quoted scalar starting at s[i] and the index after it."""
    q = s[i]
    out, j = [], i + 1
    while j < len(s):
        ch = s[j]
        if q == "'" and ch == "'":
            if s[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and ch == "\\":
            nxt = s[j + 1:j + 2]
            out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/", "0": "\0"}.get(nxt, None) or
                       _bad(f"escape \\{nxt}"))
            j += 2
            continue
        if q == '"' and ch == '"':
            return "".join(out), j + 1
        out.append(ch)
        j += 1
    raise YamlSubsetError(f"unterminated quoted scalar in {s!r}")


def _bad(what: str):
    raise YamlSubsetError(f"unsupported yaml: {what}")


def _check_plain(text: str) -> str:
    if text[:1] in ("*", "!", "|", ">", "@", "`") or text.startswith("<<"):
        _bad(text)
    return text


def _flow(s: str, i: int) -> tuple[Any, int]:
    """A flow value at s[i]: [list], {map}, quoted or plain scalar."""
    while i < len(s) and s[i] == " ":
        i += 1
    if i >= len(s):
        raise YamlSubsetError(f"flow value expected in {s!r}")
    ch = s[i]
    if ch in "[{":
        close, items, is_map = "]" if ch == "[" else "}", [], ch == "{"
        i += 1
        while True:
            while i < len(s) and s[i] == " ":
                i += 1
            if i < len(s) and s[i] == close:
                return (dict(items) if is_map else items), i + 1
            if is_map:
                key, i = _flow_scalar(s, i, ":,}")
                while i < len(s) and s[i] == " ":
                    i += 1
                if s[i:i + 1] != ":":
                    _bad(f"flow map entry without ':' in {s!r}")
                value, i = _flow(s, i + 1)
                items.append((key, value))
            else:
                value, i = _flow(s, i)
                items.append(value)
            while i < len(s) and s[i] == " ":
                i += 1
            if s[i:i + 1] == ",":
                i += 1
            elif s[i:i + 1] != close:
                _bad(f"flow collection {s!r}")
    return _flow_scalar(s, i, ",]}")


def _flow_scalar(s: str, i: int, stops: str) -> tuple[Any, int]:
    if s[i] in "'\"":
        return _quoted(s, i)
    j = i
    while j < len(s) and s[j] not in stops:
        if s[j] == ":" and (j + 1 == len(s) or s[j + 1] in " ,]}") and ":" in stops:
            break
        j += 1
    return resolve_scalar(_check_plain(s[i:j].strip())), j


def _value(text: str) -> Any:
    """An inline value: a flow collection, a quoted or a plain scalar."""
    text = text.strip()
    if text[:1] in "[{'\"":
        value, end = _flow(text, 0)
        if text[end:].strip():
            _bad(f"text after a value: {text!r}")
        return value
    return resolve_scalar(_check_plain(text))


def _strip_comment(line: str) -> str:
    """The line without its comment (a '#' at the start or after a space,
    outside quotes) and trailing spaces."""
    quote = None
    for j, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (j == 0 or line[j - 1] in " [{,:"):
            quote = ch
        elif ch == "#" and (j == 0 or line[j - 1] in " \t"):
            return line[:j].rstrip()
    return line.rstrip()


def _split_key(content: str) -> Optional[tuple[Any, str]]:
    """(key, rest) of a block map entry 'key: rest' / 'key:', or None."""
    if content[:1] in "'\"":
        key, j = _quoted(content, 0)
    else:
        m = re.match(r"^([^:#\[\]{},]+?)\s*:(?=\s|$)", content)
        if not m:
            return None
        key, j = resolve_scalar(_check_plain(m.group(1).strip())), m.end() - 1
    rest = content[j:]
    if not rest.startswith(":") or (len(rest) > 1 and rest[1] != " "):
        return None
    return key, rest[1:].strip()


def _lines(text: str) -> list[tuple[int, str]]:
    out = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            _bad("tab indentation")
        line = _strip_comment(raw)
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        if line.lstrip().startswith("%"):
            _bad(f"directive {line!r}")
        out.append((len(line) - len(line.lstrip(" ")), line.strip()))
    return out


def _inline(lines, i: int, rest: str, indent: int) -> tuple[Any, int]:
    """The value after 'key:': inline, or the nested block below."""
    if rest.startswith("&"):  # an anchor, never aliased in the subset
        parts = rest.split(None, 1)
        rest = parts[1] if len(parts) > 1 else ""
    if rest:
        return _value(rest), i
    if i < len(lines) and lines[i][0] > indent:
        return _block(lines, i, lines[i][0])
    return None, i


def _block(lines, i: int, indent: int) -> tuple[dict, int]:
    """The block map whose keys sit at `indent`, from line i."""
    out: dict = {}
    while i < len(lines) and lines[i][0] == indent:
        kv = _split_key(lines[i][1])
        if kv is None:
            _bad(f"expected 'key: value', got {lines[i][1]!r}")
        key, rest = kv
        if key in out:
            _bad(f"duplicate key {key!r}")
        out[key], i = _inline(lines, i + 1, rest, indent)
    if i < len(lines) and lines[i][0] > indent:
        _bad(f"indentation of {lines[i][1]!r}")
    return out, i


def parse_yaml(text: str) -> Any:
    """`yaml.safe_load(text)` for the subset the repo's configs use."""
    lines = _lines(text)
    if not lines:
        return None
    if len(lines) == 1 and _split_key(lines[0][1]) is None:
        return _value(lines[0][1])
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        _bad(f"indentation of {lines[i][1]!r}")
    return value


def load_yaml(path: str) -> dict:
    with open(path) as f:
        return parse_yaml(f.read())


def apply_dotlist(cfg: dict, overrides: list[str]) -> dict:
    """'a.b.c=value' CLI overrides (OmegaConf style), each value read as a
    one-line yaml value."""
    for item in overrides:
        key, _, raw = item.partition("=")
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = parse_yaml(raw) if raw.strip() else None
    return cfg


# ---------------------------------------------------------- configurations

def _unet_config(p: dict) -> UNetConfig:
    return UNetConfig(
        in_channels=p.get("in_channels", 8),
        out_channels=p.get("out_channels", 4),
        model_channels=p.get("model_channels", 320),
        num_res_blocks=p.get("num_res_blocks", 2),
        attention_resolutions=tuple(p.get("attention_resolutions", (4, 2, 1))),
        dropout=p.get("dropout", 0.0),
        channel_mult=tuple(p.get("channel_mult", (1, 2, 4, 4))),
        num_heads=p.get("num_heads", -1),
        num_head_channels=p.get("num_head_channels", 64),
        transformer_depth=p.get("transformer_depth", 1),
        context_dim=p.get("context_dim", 1024),
        temporal_conv=p.get("temporal_conv", True),
        tempspatial_aware=p.get("tempspatial_aware", False),
        temporal_attention=p.get("temporal_attention", True),
        temporal_selfatt_only=p.get("temporal_selfatt_only", True),
        use_relative_position=p.get("use_relative_position", False),
        use_causal_attention=p.get("use_causal_attention", False),
        temporal_length=p.get("temporal_length", 16),
        addition_attention=p.get("addition_attention", False),
        image_cross_attention=p.get("image_cross_attention", False),
        image_cross_attention_scale_learnable=p.get("image_cross_attention_scale_learnable", False),
        default_fs=p.get("default_fs", 4),
        fs_condition=p.get("fs_condition", False),
        use_scale_shift_norm=p.get("use_scale_shift_norm", False),
        resblock_updown=p.get("resblock_updown", False),
    )


def _vae_config(p: dict) -> VAEConfig:
    dd = p.get("ddconfig", {})
    return VAEConfig(
        double_z=dd.get("double_z", True), z_channels=dd.get("z_channels", 4), resolution=dd.get("resolution", 256),
        in_channels=dd.get("in_channels", 3), out_ch=dd.get("out_ch", 3), ch=dd.get("ch", 128),
        ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))), num_res_blocks=dd.get("num_res_blocks", 2),
        attn_resolutions=tuple(dd.get("attn_resolutions", ())), dropout=dd.get("dropout", 0.0),
        embed_dim=p.get("embed_dim", 4),
    )


def _epipolar_config(p: Optional[dict]) -> Optional[EpipolarConfig]:
    if p is None:
        return None
    return EpipolarConfig(
        origin_h=p.get("origin_h", 256),
        origin_w=p.get("origin_w", 256),
        is_3d_full_attn=p.get("is_3d_full_attn", False),
        num_register_tokens=p.get("num_register_tokens", 0),
        attention_resolution=tuple(p.get("attention_resolution", (8, 4, 2, 1))),
        compression_factor=p.get("compression_factor", 1),
        only_on_cond_frame=p.get("only_on_cond_frame", False),
        apply_epipolar_soft_mask=p.get("apply_epipolar_soft_mask", False),
        epipolar_hybrid_attention=p.get("epipolar_hybrid_attention", False),
        epipolar_hybrid_attention_v2=p.get("epipolar_hybrid_attention_v2", False),
        only_self_pixel_on_current_frame=p.get("only_self_pixel_on_current_frame", False),
        current_frame_as_register_token=p.get("current_frame_as_register_token", False),
        add_small_perturbation_on_zero_T=p.get("add_small_perturbation_on_zero_T", False),
        pluker_add_type=p.get("pluker_add_type", "add_to_pre_x_only"),
    )


def _pose_encoder_config(node: Optional[dict]) -> Optional[PoseEncoderConfig]:
    if node is None:
        return None
    p = node.get("params", node)
    return PoseEncoderConfig(
        downscale_factor=p.get("downscale_factor", 8),
        channels=tuple(p.get("channels", (320, 640, 1280, 1280))),
        nums_rb=p.get("nums_rb", 2),
        cin=p.get("cin", 384),
        ksize=p.get("ksize", 3),
        sk=p.get("sk", False),
        use_conv=p.get("use_conv", True),
        compression_factor=p.get("compression_factor", 1),
        temporal_attention_nhead=p.get("temporal_attention_nhead", 8),
        temporal_position_encoding=p.get("temporal_position_encoding", False),
        temporal_position_encoding_max_len=p.get("temporal_position_encoding_max_len", 16),
    )


def _resampler_config(node: Optional[dict]) -> ResamplerConfig:
    if node is None:
        return ResamplerConfig()
    p = node.get("params", node)
    return ResamplerConfig(
        dim=p.get("dim", 1024), depth=p.get("depth", 4), dim_head=p.get("dim_head", 64), heads=p.get("heads", 12),
        num_queries=p.get("num_queries", 16), embedding_dim=p.get("embedding_dim", 1280),
        output_dim=p.get("output_dim", 1024), ff_mult=p.get("ff_mult", 4), video_length=p.get("video_length", 16),
        use_timestep_emb=p.get("use_timestep_emb", False),
    )


def _adaptor_config(node: Optional[dict]) -> AdaptorConfig:
    if node is None:
        return AdaptorConfig()
    p = node.get("params", node)
    return AdaptorConfig(
        query_dim=p.get("query_dim", 512),
        num_queries=p.get("num_queries", 1024),
        video_length=p.get("video_length", 16),
        embedding_dim=p.get("embedding_dim", 4),
        output_dim=p.get("output_dim", 4),
        depth=p.get("depth", 12),
        dim_head=p.get("dim_head", 64),
        heads=p.get("heads", 8),
        ff_mult=p.get("ff_mult", 4),
        num_register_tokens=p.get("num_register_tokens", 2),
        use_mask=p.get("use_mask", True),
        timestep_embedding_type=p.get("timestep_embedding_type", "none"),
        timestep_embedding_dim=p.get("timestep_embedding_dim", 32),
        use_plucker_embedding=p.get("use_plucker_embedding", False),
    )


# target -> (model class name in the port, its configuration class)
MODEL_CLASSES = {
    "model.camcontexti2v.CamContextI2V": ("CamContextI2V", CamContextI2VConfig),
    "model.dynamicrafter.DynamiCrafter": ("DynamiCrafter", DynamiCrafterConfig),
    "baseline.motionctrl.motionctrl.MotionCtrl": ("MotionCtrl", MotionCtrlConfig),
    "baseline.cameractrl.cameractrl.CameraCtrl": ("CameraCtrl", CameraControlConfig),
    "baseline.cami2v.cami2v.CamI2V": ("CamI2V", CamI2VConfig),
    # short names
    "CamContextI2V": ("CamContextI2V", CamContextI2VConfig),
    "DynamiCrafter": ("DynamiCrafter", DynamiCrafterConfig),
    "MotionCtrl": ("MotionCtrl", MotionCtrlConfig),
    "CameraCtrl": ("CameraCtrl", CameraControlConfig),
    "CamI2V": ("CamI2V", CamI2VConfig),
}


def model_config_from_yaml(cfg: dict) -> tuple[str, DynamiCrafterConfig]:
    """(model class name, configuration) of the `model:` section."""
    mnode = cfg["model"]
    target = mnode.get("target", "model.camcontexti2v.CamContextI2V")
    if target not in MODEL_CLASSES:
        raise KeyError(f"unknown model target '{target}'")
    cls_name, cfg_cls = MODEL_CLASSES[target]
    p = mnode.get("params", {})
    # tiny/test tower overrides (the reference configs always use the full towers)
    ct, cv = p.get("clip_text_config", {}), p.get("clip_vision_config", {})
    kw: dict[str, Any] = dict(
        unet=_unet_config(p.get("unet_config", {}).get("params", {})),
        vae=_vae_config(p.get("first_stage_config", {}).get("params", {})),
        clip_text=CLIPTextConfig(**ct) if ct else CLIPTextConfig(),
        clip_vision=CLIPVisionConfig(**cv) if cv else CLIPVisionConfig(),
        resampler=_resampler_config(p.get("image_proj_stage_config")),
        timesteps=p.get("timesteps", 1000),
        beta_schedule=p.get("beta_schedule", "linear"),
        linear_start=p.get("linear_start", 1e-4),
        linear_end=p.get("linear_end", 2e-2),
        rescale_betas_zero_snr=p.get("rescale_betas_zero_snr", False),
        parameterization=p.get("parameterization", "eps"),
        scale_factor=p.get("scale_factor", 0.18215),
        loss_type=p.get("loss_type", "l2"),
        uncond_prob=p.get("uncond_prob", 0.05),
        uncond_type=p.get("uncond_type", "empty_seq"),
        rand_cond_frame=p.get("rand_cond_frame", False),
        fps_condition_type=p.get("fps_condition_type", "fs"),
        use_dynamic_rescale=p.get("use_dynamic_rescale", False),
        base_scale=p.get("base_scale", 0.7),
        turning_step=p.get("turning_step", 400),
        perframe_ae=p.get("perframe_ae", False),
        interp_mode=p.get("interp_mode", False),
    )
    if issubclass(cfg_cls, CameraControlConfig):
        kw["pose_encoder"] = _pose_encoder_config(p.get("pose_encoder_config"))
        kw["normalize_T0"] = p.get("normalize_T0", False)
        kw["camera_embedding"] = p.get("camera_embedding", "plucker")
    epipolar = _epipolar_config(p.get("epipolar_config"))
    if issubclass(cfg_cls, CamI2VConfig):
        kw["epipolar"] = epipolar
        kw["add_type"] = p.get("add_type", "add_into_temporal_attn")
    if cfg_cls is CamContextI2VConfig:
        kw["multi_cond_strategy"] = p.get("multi_cond_strategy")
        kw["adaptor"] = _adaptor_config(p.get("multi_latent_adaptor"))
        kw["use_cross_normalization"] = p.get("use_cross_normalization", False)
        kw["cross_normalization_mode"] = p.get("cross_normalization_mode", "spatio_temporal")
        kw["use_zero_conv_latent_input"] = p.get("use_zero_conv_latent_input", False)
        kw["use_semantic_branch"] = p.get("use_semantic_branch", True)
        kw["epipolar_mask_freeze_steps"] = p.get("epipolar_mask_freeze_steps")
    # the camera composition wired into the UNet
    unet = kw["unet"]
    if cfg_cls is MotionCtrlConfig:
        unet = UNetConfig(**{**unet.__dict__, "camera_mode": "motionctrl", "pose_dim": p.get("pose_dim", 12)})
    elif cfg_cls is CameraControlConfig and cls_name == "CameraCtrl":
        unet = UNetConfig(**{**unet.__dict__, "camera_mode": "cameractrl"})
    elif issubclass(cfg_cls, CamI2VConfig):
        unet = UNetConfig(**{**unet.__dict__, "use_camera": p.get("pose_encoder_config") is not None,
                             "epipolar": epipolar, "add_type": kw.get("add_type", "add_into_temporal_attn")})
    kw["unet"] = unet
    return cls_name, cfg_cls(**kw)


def model_class(cls_name: str):
    """The port's model class for a class name of MODEL_CLASSES. MotionCtrl
    and CameraCtrl get the camera base, whose UNet raises on their
    `camera_mode`."""
    from camc2v_tpu_torch.models.camcontexti2v import CamContextI2V
    from camc2v_tpu_torch.models.camera_base import CameraControlLVDM, CamI2V
    from camc2v_tpu_torch.models.dynamicrafter import DynamiCrafter

    return {"CamContextI2V": CamContextI2V, "CamI2V": CamI2V, "DynamiCrafter": DynamiCrafter,
            "MotionCtrl": CameraControlLVDM, "CameraCtrl": CameraControlLVDM}[cls_name]


def build_model_from_config(cfg: dict, *, device="cuda", seed: int = 0, dtype=torch.bfloat16):
    """(model, pretrained_checkpoint path or None) of the `model:` section:
    seeded random fp32 weights on `device`, compute in `dtype`, train mode
    (`presets.build_for_training`'s rule; raises without CUDA unless the
    caller asks for the CPU)."""
    from camc2v_tpu_torch.presets import seeded_model

    cls_name, config = model_config_from_yaml(cfg)
    model = seeded_model(config, model_class(cls_name), device, seed, dtype)
    return model.train(), cfg["model"].get("pretrained_checkpoint")


def _number(v):
    """A yaml number that YAML 1.1 read as a string ('1e-4' has no dot)."""
    return float(v) if isinstance(v, str) else v


def build_train_config(cfg: dict, num_devices: int = 1) -> TrainConfig:
    """The training recipe of the `model:` and `lightning:` sections (the JAX
    bridge's rules, one device: a strategy that shards parameters and
    `num_devices` > 1 need the mesh, which is not ported, and raise)."""
    if num_devices != 1:
        raise NotImplementedError(f"build_train_config: {num_devices} devices (the mesh is not ported)")
    mnode = cfg.get("model", {})
    lightning = cfg.get("lightning", {}).get("trainer", {})
    p = mnode.get("params", {})
    patterns = []
    # the reference's trainable-selection flags -> parameter-path regexes
    for flag, pattern in (("multi_cond_adaptor_trainable", r"^adaptor/"), ("image_proj_model_trainable", r"^image_proj/"),
                          ("pose_encoder_trainable", r"^pose_encoder/"), ("use_zero_conv_latent_input", r"^zero_conv/"),
                          ("plucker_proj_trainable", r"pluker_projection"), ("epipolar_attn_trainable", r"/epipolar/"),
                          ("cond_stage_trainable", r"^clip_text/")):
        if p.get(flag, False):
            patterns.append(pattern)
    target = mnode.get("target", "")
    if "motionctrl" in target.lower() or "cameractrl" in target.lower():
        patterns.append(r"cc_projection")  # the baselines' adapters are always trainable
    for name in p.get("diffusion_model_trainable_param_list", []) or []:
        if name == "TemporalTransformer.attn1":
            patterns.append(r"temporal/block_\d+/attn1/")
        elif name == "TemporalTransformer.attn2":
            patterns.append(r"temporal/block_\d+/attn2/")
        elif name == "SpatialTransformer":
            patterns.append(r"_spatial/")
        elif name:
            patterns.append(re.escape(name))
    if not patterns:
        patterns = [r"^unet/"]  # DynamiCrafter's default: train the UNet
    # precision "16-mixed": frozen weights in half precision, fp32 masters of the trainables
    precision = str(lightning.get("precision", "32") or "32")
    frozen_dtype = "bfloat16" if ("16" in precision and precision != "32") else None
    strategy = str(lightning.get("strategy", "") or "")
    if any(k in strategy for k in ("stage_2", "stage_3", "fsdp")):
        raise NotImplementedError(f"build_train_config: strategy '{strategy}' shards parameters over the mesh, "
                                  "which is not ported")
    return TrainConfig(
        learning_rate=_number(mnode.get("base_learning_rate", 1e-4)),
        scale_lr=mnode.get("scale_lr", False),
        weight_decay=_number(p.get("weight_decay", 1e-2)),
        grad_clip=_number(lightning.get("gradient_clip_val", 0.5)),
        accumulate_grad_batches=lightning.get("accumulate_grad_batches", 1),
        use_ema=p.get("use_ema", False),
        trainable_patterns=tuple(patterns),
        max_steps=lightning.get("max_steps", 50000),
        frozen_param_dtype=frozen_dtype,
    )
