"""The port's camera modules against the JAX package, plus `presets.build`.

Each module runs in f32 on the same numpy inputs with the same seeded,
fully non-zero weights (`test_torch_port_modules.jax_params`; the zero-init
projections of a fresh JAX init would make the camera branches vacuous):

  * `Epipolar` on its kernel path (t 4, 16x16 latents, so `kernel_tiling_ok`
    holds and the port runs K6's plain twin) and on its materialised path
    (8x8, the mask through the attention seam);
  * `CameraPoseEncoder` with two levels of two blocks (both branch orders,
    the downsampling block and the positional encoding);
  * `MultiLatentEpipolarAdaptor` on its kernel path (num_queries = hw = 256,
    2 target frames over the cond frame and 1 context frame) and on its
    dense-mask path.
One `CamI2V` guided denoise step at TINY on the fused batch-2B path is in
`test_torch_camera_sampling.py`.

Tolerance: 1e-4 of the output's max |value| (f32, summation order only).
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.append(str(Path(__file__).parent / "oracle"))

from refload import my_model  # noqa: E402
from test_torch_port_modules import _normal, assert_close, flat, jax_params, jit_o0, run_both  # noqa: E402

from camc2v_tpu.camera import geometry as JG  # noqa: E402
from camc2v_tpu.ops import epipolar_flash as jef  # noqa: E402

from camc2v_tpu_torch import config as pc  # noqa: E402
from camc2v_tpu_torch.ops import epipolar_flash as tef  # noqa: E402
from camc2v_tpu_torch.utils.weights import load_jax_params  # noqa: E402

T_ = lambda a: torch.from_numpy(np.array(a))  # noqa: E731


def _F(t, img, seed=0):
    """F of every frame pair of a trajectory with distinct translations."""
    rng = np.random.default_rng(seed)
    K = np.array([[img, 0, img / 2], [0, img, img / 2], [0, 0, 1]], np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (1, t, 1, 1))
    c2w[0, :, :3, 3] = np.stack([0.4 * np.arange(t) + 0.05, 0.1 * np.arange(t), -0.15 * np.arange(t)], -1)
    c2w[0, :, :3, 3] += 0.01 * rng.standard_normal((t, 3))
    pairs = JG.relative_c2w_pairs(jnp.asarray(c2w))
    tv = JG.add_small_perturbation(pairs[..., :3, 3:4], jax.random.key(1))
    return JG.fundamental_matrix(jnp.broadcast_to(jnp.asarray(K), (1, t, t, 3, 3)), pairs[..., :3, :3], tv)


@pytest.fixture
def count_paths(monkeypatch):
    """Counts of the epipolar module's two attention paths in the port."""
    from camc2v_tpu_torch.nn import epipolar as seam

    counts = {"kernel": 0, "materialised": 0}
    twin = tef.epipolar_attention_plain

    def kernel(*a, **k):
        counts["kernel"] += 1
        return twin(*a, **k)

    def materialised(*a, **k):
        counts["materialised"] += 1
        return dense(*a, **k)

    dense = seam.dot_product_attention
    monkeypatch.setattr(tef, "epipolar_attention_plain", kernel)
    monkeypatch.setattr(seam, "dot_product_attention", materialised)
    return counts


@pytest.mark.parametrize("hw,path", [(16, "kernel"), (8, "materialised")])
def test_epipolar_matches_jax(hw, path, count_paths):
    from camc2v_tpu.nn.epipolar import Epipolar as JEpipolar
    from camc2v_tpu.nn.epipolar import EpipolarConfig as JCfg
    from camc2v_tpu_torch.nn.epipolar import Epipolar

    t, c, heads = 4, 64, 2
    kw = dict(origin_h=8 * hw, origin_w=8 * hw, attention_resolution=(1,), num_register_tokens=4)
    F = _F(t, 8 * hw)
    feats = _normal(1, t, hw, hw, c)
    jm = JEpipolar(config=JCfg(**kw), query_dim=c, heads=heads)
    params = jax_params(jm, jnp.asarray(feats), F=F)
    assert float(np.abs(params["epipolar_attn"]["to_out"]["kernel"]).min()) > 0
    got, ref = run_both(jm, params, Epipolar(pc.EpipolarConfig(**kw), c, heads), [feats],
                        jkw=dict(F=F), tkw=dict(F=T_(F)))
    assert got.shape == (hw * hw, t, c)
    assert count_paths == {"kernel": 0, "materialised": 0, path: 1}
    assert_close(got, ref)


def test_pose_encoder_matches_jax():
    from camc2v_tpu.camera.pose_encoder import CameraPoseEncoder as JEnc
    from camc2v_tpu.camera.pose_encoder import PoseEncoderConfig as JCfg
    from camc2v_tpu_torch.camera.pose_encoder import CameraPoseEncoder

    kw = dict(channels=(32, 64), nums_rb=2, temporal_attention_nhead=2, temporal_position_encoding_max_len=16)
    x = _normal(1, 4, 32, 32, 6)
    jm = JEnc(JCfg(**kw))
    params = jax_params(jm, jnp.asarray(x))
    tm = CameraPoseEncoder(pc.PoseEncoderConfig(**kw))
    load_jax_params(tm, flat(params))
    ref = jit_o0(lambda p, x_: jm.apply({"params": p}, x_))(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(T_(x))
    assert [tuple(g.shape) for g in got] == [(1, 4, 4, 4, 32), (1, 4, 2, 2, 64)]
    for g, r in zip(got, ref):
        assert_close(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("path", ["kernel", "dense"])
def test_adaptor_matches_jax(path, count_paths):
    from camc2v_tpu.camera.adaptors import MultiLatentEpipolarAdaptor as JAdaptor
    from camc2v_tpu_torch.camera.adaptors import MultiLatentEpipolarAdaptor

    t, n_ctx, hl = 2, 1, 16
    hw, img = hl * hl, 8 * hl
    kw = dict(query_dim=32, depth=1, dim_head=16, heads=2, num_queries=hw, embedding_dim=4, output_dim=4,
              num_register_tokens=2, use_mask=True, video_length=t, timestep_embedding_type="sinusoidal_embedded")
    K = np.broadcast_to(np.array([[img, 0, img / 2], [0, img, img / 2], [0, 0, 1]], np.float32), (1, t, 3, 3))
    w2c = np.tile(np.eye(4, dtype=np.float32), (1, t, 1, 1))
    w2c[0, :, 0, 3] = [0.0, 0.6]
    w2c[0, :, 1, 3] = 0.1
    w2c_cond = np.tile(np.eye(4, dtype=np.float32), (1, n_ctx, 1, 1))
    w2c_cond[0, 0, :3, 3] = [-0.4, 0.05, 0.15]
    poses = (jnp.asarray(K), jnp.asarray(w2c), jnp.asarray(w2c_cond), jnp.zeros((1,), jnp.int32))
    x = _normal(1, (1 + n_ctx) * hw, 4)
    jm = JAdaptor(**kw)
    params = jax_params(jm, jnp.asarray(x))
    tm = MultiLatentEpipolarAdaptor(**kw)
    if path == "kernel":
        lines = jef.epipolar_lines(JG.conditional_fundamental(*poses), hl, hl, 8)
        tiles = jef.epipolar_tile_map(lines, 1 + n_ctx, hl, hl, 8, block_q=jef.BLOCK_Q, block_k=hw)
        geom = (1 + n_ctx, hl, hl, 8, hw)
        jkw = dict(use_mask=True, lines=lines, geom=geom, tile_any=tiles)
        tkw = dict(use_mask=True, lines=T_(lines), geom=geom, tile_any=T_(tiles))
        got, ref = run_both(jm, params, tm, [x], jkw=jkw, tkw=tkw)
    else:
        mask = JG.conditional_epipolar_mask(*poses, img, img, downsample=8)
        assert 0 < float(mask.mean()) < 0.9
        got, ref = run_both(jm, params, tm, [x, np.array(mask)])
    assert got.shape == (1, t * hw, 4)
    assert count_paths[{"kernel": "kernel", "dense": "materialised"}[path]] == 1
    assert_close(got, ref)


def tiny_camcontext_config():
    return pc.CamContextI2VConfig(
        unet=pc.UNetConfig(model_channels=32, num_res_blocks=1, attention_resolutions=(1,), channel_mult=(1, 2),
                           num_head_channels=8, context_dim=16, temporal_length=4, use_camera=True,
                           epipolar=pc.EpipolarConfig(origin_h=32, origin_w=32, attention_resolution=(1,),
                                                      num_register_tokens=2)),
        vae=pc.VAEConfig(resolution=32, ch=32, num_res_blocks=1),
        clip_text=pc.CLIPTextConfig(vocab_size=64, width=16, heads=2, layers=2),
        clip_vision=pc.CLIPVisionConfig(patch_size=112, width=16, heads=2, layers=1),
        resampler=pc.ResamplerConfig(dim=32, depth=1, dim_head=8, heads=2, embedding_dim=16, output_dim=16,
                                     video_length=4),
        pose_encoder=pc.PoseEncoderConfig(channels=(32, 64), nums_rb=1, temporal_attention_nhead=2),
        epipolar=pc.EpipolarConfig(origin_h=32, origin_w=32, attention_resolution=(1,), num_register_tokens=2),
        adaptor=pc.AdaptorConfig(query_dim=16, num_queries=16, video_length=4, depth=1, dim_head=8, heads=2),
    )


def test_build_raises_without_cuda_and_matches_hand_built(monkeypatch):
    from camc2v_tpu_torch import presets
    from camc2v_tpu_torch.models.camcontexti2v import CamContextI2V
    from camc2v_tpu_torch.utils.weights import cast_for_inference, init_weights

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            presets.build("camcontexti2v_256")
    monkeypatch.setitem(presets.PRESETS, "camcontexti2v_256", tiny_camcontext_config)
    got = presets.build("camcontexti2v_256", device="cpu", seed=3)
    assert type(got) is CamContextI2V and not got.training
    ref = CamContextI2V(tiny_camcontext_config())
    init_weights(ref, torch.Generator().manual_seed(3))
    ref = cast_for_inference(ref.eval(), torch.bfloat16)
    got_sd, ref_sd = got.state_dict(), ref.state_dict()
    assert got_sd.keys() == ref_sd.keys()
    for name, value in ref_sd.items():
        assert got_sd[name].dtype == value.dtype and torch.equal(got_sd[name], value), name
    assert got.unet.in_0_temporal.block_0.epipolar.epipolar_attn.register_tokens.abs().max() > 1.0  # N(0, 1)
    assert got.zero_conv.weight.dtype == torch.bfloat16 and got.zero_conv.weight.dim() == 5


def test_unported_variants_raise():
    """What raises in the JAX package raises in the port, and nothing else:
    the 'pose_agent_enc' strategy (a stub in the reference) on both sides (the
    soft epipolar masks: `test_torch_variants_masks.py`); a baseline's camera
    injection on an epipolar UNet is refused; the other options build."""
    from camc2v_tpu.models.camcontexti2v import CamContextI2V as JCamContextI2V
    from camc2v_tpu_torch.models.camcontexti2v import CamContextI2V
    from camc2v_tpu_torch.nn.epipolar import Epipolar

    cfg = tiny_camcontext_config()
    jcfg = my_model("camcontext").config
    with pytest.raises(NotImplementedError, match="pose_agent_enc"):
        JCamContextI2V(dataclasses.replace(jcfg, multi_cond_strategy="pose_agent_enc"))
    with pytest.raises(NotImplementedError, match="pose_agent_enc"):
        CamContextI2V(dataclasses.replace(cfg, multi_cond_strategy="pose_agent_enc"))
    with pytest.raises(ValueError, match="camera_mode"):  # a baseline's injection on an epipolar UNet
        CamContextI2V(dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, camera_mode="motionctrl")))
    Epipolar(pc.EpipolarConfig(epipolar_hybrid_attention=True), 64, 2)
    for kw in (dict(use_cross_normalization=True), dict(multi_cond_strategy="max"),
               dict(adaptor=dataclasses.replace(cfg.adaptor, use_plucker_embedding=True))):
        CamContextI2V(dataclasses.replace(cfg, **kw))
