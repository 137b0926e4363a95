"""The port's FVD pieces (`camc2v_tpu_torch/eval/fvd.py`) against the JAX
package's (`camc2v_tpu/eval/fvd.py`).

  * the I3D: `Unit3D` with stride 2 at odd sizes (flax's SAME pads are
    asymmetric there), the SAME max pools (exact), and the full-width
    `InceptionI3D` logits and pool features at (2, 9, 33, 33, 3), every
    weight moved into the port by `load_i3d_variables` from a seeded flax
    variables tree whose BatchNorm scales, biases, means and variances are
    all off their 0/1 init; relative L2 <= 1e-4 (f32 against f32);
  * the resize to 224 against `jax.image.resize(..., "bilinear")` (which
    antialiases when it shrinks): max |difference| <= 5e-6 on [-1, 1]
    frames. The weights are JAX's f32 ones to an ulp; the port sums in f64,
    and JAX's f32 contraction is itself up to 3.6e-6 from that sum (at 32 x
    48 -> 224; 3.7e-7 at 256 -> 224);
  * `gaussian_stats` + `frechet_distance` on 400- and 1024-wide features of
    12 videos (singular covariances), plain and through the `eps` retry:
    1e-6 relative.
Three tests, so xdist queues this file after the long ones. numpy's BLAS
runs on one thread here as torch does: a 1024-wide `sqrtm` takes ~4 s so,
and ten times that with every worker's BLAS threads on the machine's cores.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch
from threadpoolctl import threadpool_limits

from test_torch_port_modules import jit_o0, one_torch_thread  # noqa: F401

from camc2v_tpu.eval import fvd as J

from camc2v_tpu_torch.eval import fvd as P
from camc2v_tpu_torch.utils.weights import i3d_variables, load_i3d_variables

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    with threadpool_limits(1):
        yield


def seeded_variables(module, x, seed):
    """A flax variables tree for `module.init(x)` drawn from numpy: kernels
    N(0, 2/fan_in), biases N(0, 0.1), BN scales U(0.5, 1.5), means N(0, 0.1),
    variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: module.init(k, x), jax.random.key(0))

    def leaf(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            v = rng.standard_normal(s.shape) * (2.0 / np.prod(s.shape[:-1])) ** 0.5
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, s.shape)
        else:  # bias, mean
            v = 0.1 * rng.standard_normal(s.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def to_ncdhw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 4, 1, 2, 3)


def test_i3d_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 9, 33, 33, 3)).astype(np.float32)

    # Unit3D, stride 2 at odd sizes: flax pads (3, 3) at 7 and 33, (2, 3) at 7 and 16
    for shape, kernel in (((1, 9, 33, 33, 3), (7, 7, 7)), ((1, 16, 16, 15, 5), (7, 7, 7)),
                          ((1, 9, 33, 33, 3), (3, 3, 3))):
        xi = rng.standard_normal(shape).astype(np.float32)
        m = J.Unit3D(8, kernel, (2, 2, 2))
        v = seeded_variables(m, xi, 1)
        want = np.asarray(jit_o0(lambda a: m.apply(v, a))(xi))
        unit = P.Unit3D(shape[-1], 8, kernel, (2, 2, 2))
        load_i3d_variables(unit, v)
        with torch.no_grad():
            got = unit(to_ncdhw(xi)).permute(0, 2, 3, 4, 1).numpy()
        assert got.shape == want.shape and rel_l2(got, want) < TOL, (shape, kernel, rel_l2(got, want))

    # the SAME max pools: -inf pads, exact
    for kernel, stride in (((1, 3, 3), (1, 2, 2)), ((3, 3, 3), (2, 2, 2)), ((2, 2, 2), (2, 2, 2)),
                           ((3, 3, 3), (1, 1, 1))):
        want = np.asarray(fnn.max_pool(jnp.asarray(x), kernel, strides=stride, padding="SAME"))
        got = P.max_pool_same(to_ncdhw(x), kernel, stride).permute(0, 2, 3, 4, 1).numpy()
        np.testing.assert_array_equal(got, want)

    # the full-width network, both feature variants, one flax program
    v = seeded_variables(J.InceptionI3D(), x, 2)
    want_logits, want_pool = jit_o0(lambda a: (J.InceptionI3D(features="logits").apply(v, a),
                                               J.InceptionI3D(features="pool").apply(v, a)))(x)
    for features, want in (("logits", want_logits), ("pool", want_pool)):
        net = P.InceptionI3D(features=features)
        load_i3d_variables(net, v)
        with torch.no_grad():
            got = net(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == (2, 400 if features == "logits" else 1024)
        for j in range(2):
            assert rel_l2(got[j], want[j]) < TOL, (features, j, rel_l2(got[j], want[j]))

    # the carry-over is strict over BN buffers too, and `i3d_variables` is its inverse
    back = i3d_variables(net)
    for col in ("params", "batch_stats"):
        jax.tree_util.tree_map(np.testing.assert_array_equal, back[col], jax.tree_util.tree_map(np.asarray, v[col]))
    stats = dict(v["batch_stats"])
    stats["Mixed_4c"] = dict(stats["Mixed_4c"], b2b={})
    with pytest.raises(ValueError, match="Mixed_4c.b2b.bn.running_mean"):
        load_i3d_variables(P.InceptionI3D(), dict(v, batch_stats=stats))
    with pytest.raises(ValueError, match="unused"):
        load_i3d_variables(P.InceptionI3D(), dict(v, extra={"w": np.zeros(1)}))


def test_resize_matches_jax():
    """The resize to 224: shrinking (256, antialiased) and growing (32 x 48),
    max |difference| <= 5e-6; the scorer resizes only when H != 224."""
    rng = np.random.default_rng(3)
    for shape in ((2, 3, 256, 256, 3), (1, 2, 32, 48, 3)):
        x = rng.uniform(-1, 1, shape).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x), shape[:2] + (224, 224, 3), "bilinear"))
        got = P.resize_224(torch.from_numpy(x)).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.abs(got - want).max() <= 5e-6, (shape, np.abs(got - want).max())

    class Spy(torch.nn.Module):
        def forward(self, b):
            seen.append(tuple(b.shape))
            return b.mean(dim=(1, 2, 3))

    seen = []
    scorer = P.FVDScorer(None)
    scorer.model = Spy()
    scorer.extract_features(np.zeros((9, 2, 256, 256, 3), np.float32))
    scorer.extract_features(np.zeros((1, 2, 224, 100, 3), np.float32))
    assert seen == [(8, 2, 224, 224, 3), (1, 2, 224, 224, 3), (1, 2, 224, 100, 3)]


def test_frechet_matches_jax(monkeypatch):
    """N = 12 videos, so both covariances are singular. SciPy's `sqrtm`
    returns a finite root of their product, so the `eps` retry is driven by a
    `sqrtm` that fails on the unregularised product (as older SciPy's did)."""
    rng = np.random.default_rng(4)
    real_sqrtm = scipy.linalg.sqrtm

    def failing_on_product(m, **kw):  # JAX asks for (root, error) with disp=False, the port for the root
        if failing and np.array_equal(m, product):
            return (np.full_like(m, np.nan), np.inf) if "disp" in kw else np.full_like(m, np.nan)
        return real_sqrtm(m, **kw)

    monkeypatch.setattr(scipy.linalg, "sqrtm", failing_on_product)
    for d, retry in ((400, False), (400, True), (1024, True)):
        f1 = rng.standard_normal((12, d)) * rng.uniform(0.5, 2.0, d)
        f2 = rng.standard_normal((12, d)) + 0.3
        stats = [P.gaussian_stats(f) for f in (f1, f2)]
        for got, want in zip(stats, [J.gaussian_stats(f) for f in (f1, f2)]):
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        assert np.linalg.matrix_rank(stats[0][1]) == 11
        product, failing = stats[0][1] @ stats[1][1], retry
        got = P.frechet_distance(*stats[0], *stats[1])
        want = J.frechet_distance(*stats[0], *stats[1])
        assert np.isfinite(got) and got == pytest.approx(want, rel=1e-6), (d, retry, got, want)
