"""The port's geometry algorithms, ``models.nn``, the terrain nets, the
racer, ``ops.poly.quadratic_fit`` and the tracing helpers against the JAX
package's on the CPU (``fpyv_tpu.vision.geometry``, ``models.nn``,
``models.terrain``, ``physics.racer``), the racer also against
tests/test_racer_and_io.py's float64 oracle.

Tolerances, float64 unless said: ``eight_point``'s F 1e-9 up to its sign
(an SVD's last vector is defined up to sign), the epipolar residuals below
1e-8 and the rank-2 singular value below 1e-10 (JAX's test's); the
triangulated points 1e-9 and 1e-6 of the truth; Gauss-Newton 1e-10 of
JAX's and 1e-8 of the truth; gradient descent's written-out gradient
1e-12 of ``jax.grad``, its solution 1e-6 of the truth; ICP 1e-9 of JAX's
and 1e-2 of the truth; the sphere points equal from JAX's draws; nn 1e-12
(float32 attention 1e-6); ``binarize``'s gradient equal to ``jax.grad``'s;
the terrain from JAX's weights 1e-12, from JAX's draws 1e-6 relative to
the largest height in float32 (``linspace`` rounds its grid otherwise);
the racer 1e-10 of JAX's and of the oracle over 200 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpyv_tpu.models import nn as jnn
from fpyv_tpu.models.terrain import TerrainNet as JTerrain
from fpyv_tpu.models.terrain import terrain_heightmap as j_heightmap
from fpyv_tpu.physics.racer import RacerParams as JRacerParams
from fpyv_tpu.physics.racer import racer_reset as j_racer_reset
from fpyv_tpu.physics.racer import racer_step as j_racer_step
from fpyv_tpu.vision import geometry as jgeo
from fpyv_tpu_torch import interop
from fpyv_tpu_torch.models import nn
from fpyv_tpu_torch.models.terrain import TerrainNet, terrain_heightmap
from fpyv_tpu_torch.physics.racer import RacerParams, racer_reset, racer_step
from fpyv_tpu_torch.utils.profiling import trace
from fpyv_tpu_torch.vision import geometry as geo
from tests.test_racer_and_io import oracle_racer_steps


@pytest.fixture(autouse=True)
def one_thread():
    """Every tensor here is small: with the suite's workers sharing the
    cores, intra-op threads only add synchronisation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _projective_pair(seed=0, n=30):
    rng = np.random.default_rng(seed)
    K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]])
    th = 0.1
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
    X = rng.uniform(-2, 2, (n, 3)) + np.array([0, 0, 8.0])
    P1 = K @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = K @ np.hstack([R, np.array([[1.0], [0.2], [0.1]])])

    def proj(P):
        h = (P @ np.hstack([X, np.ones((n, 1))]).T).T
        return h[:, :2] / h[:, 2:3]

    return P1, P2, proj(P1), proj(P2), X


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def test_eight_point_and_triangulate_match_jax():
    P1, P2, p1, p2, X = _projective_pair()
    F = geo.eight_point(_t(p1), _t(p2)).numpy()
    jF = np.asarray(jgeo.eight_point(jnp.asarray(p1), jnp.asarray(p2)))
    sign = np.sign((F * jF).sum())
    np.testing.assert_allclose(F, sign * jF, atol=1e-9)
    assert geo.epipolar_residual(_t(F), _t(p1), _t(p2)).max().item() < 1e-8
    assert np.linalg.svd(F, compute_uv=False)[2] < 1e-10
    np.testing.assert_allclose(geo.epipolar_residual(_t(F), _t(p1), _t(p2)).numpy(),
                               np.asarray(jgeo.epipolar_residual(jnp.asarray(F), jnp.asarray(p1),
                                                                 jnp.asarray(p2))), atol=1e-12)
    Xr = geo.triangulate(_t(P1), _t(P2), _t(p1), _t(p2)).numpy()
    np.testing.assert_allclose(Xr, np.asarray(jgeo.triangulate(*map(jnp.asarray,
                                                                    (P1, P2, p1, p2)))), atol=1e-9)
    np.testing.assert_allclose(Xr, X, atol=1e-6)


@pytest.mark.parametrize("dim", [2, 3])
def test_trilaterate_gauss_newton_matches_jax(dim):
    rng = np.random.default_rng(1)
    anchors = rng.normal(size=(6, dim)) * 5
    target = rng.normal(size=dim)
    ranges = np.linalg.norm(anchors - target, axis=1)
    x = geo.trilaterate_gauss_newton(_t(anchors), _t(ranges)).numpy()
    np.testing.assert_allclose(x, np.asarray(jgeo.trilaterate_gauss_newton(anchors, ranges)),
                               atol=1e-10)
    np.testing.assert_allclose(x, target, atol=1e-8)
    noisy = ranges + rng.normal(0, 0.01, 6)
    assert np.linalg.norm(geo.trilaterate_gauss_newton(_t(anchors), _t(noisy)).numpy()
                          - target) < 0.1


def test_trilaterate_gd_gradient_and_solution():
    """The written-out gradient equals ``jax.grad`` of JAX's loss at a few
    points; the descent reaches the truth as JAX's test asks."""
    rng = np.random.default_rng(2)
    anchors = rng.normal(size=(5, 3)) * 5
    target = rng.normal(size=3)
    ranges = np.linalg.norm(anchors - target, axis=1)
    loss = lambda x: jnp.sum((jnp.linalg.norm(jnp.asarray(anchors) - x, axis=-1)
                              - jnp.asarray(ranges)) ** 2)
    for x0 in rng.normal(size=(4, 3)):
        step = geo.trilaterate_gd(_t(anchors), _t(ranges), _t(x0), learning_rate=1.0,
                                  iterations=1).numpy()
        np.testing.assert_allclose(x0 - step, np.asarray(jax.grad(loss)(jnp.asarray(x0))),
                                   atol=1e-12)
    x = geo.trilaterate_gd(_t(anchors), _t(ranges), learning_rate=1e-2, iterations=5000).numpy()
    np.testing.assert_allclose(x, target, atol=1e-6)


def test_icp_matches_jax():
    rng = np.random.default_rng(4)
    src = rng.uniform(-1, 1, (80, 2))
    th = 0.12
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    t = np.array([0.1, -0.05])
    dst = src @ R.T + t
    R2, t2, rmse = geo.icp_2d(_t(src), _t(dst), 40)
    jR, jt, jrmse = jgeo.icp_2d(jnp.asarray(src), jnp.asarray(dst), 40)
    np.testing.assert_allclose(R2.numpy(), np.asarray(jR), atol=1e-9)
    np.testing.assert_allclose(t2.numpy(), np.asarray(jt), atol=1e-9)
    np.testing.assert_allclose(rmse.item(), float(jrmse), atol=1e-9)
    assert rmse.item() < 1e-3
    np.testing.assert_allclose(R2.numpy(), R, atol=1e-2)


def test_random_points_on_sphere_matches_jax(monkeypatch):
    key = jax.random.key(0)
    jp = jgeo.random_points_on_sphere(key, 2000, 3, jnp.float64)
    draw = jax.random.normal(key, (2000, 3), jnp.float64)
    monkeypatch.setattr(geo, "sphere_draw", lambda *a: _t(draw))
    p = geo.random_points_on_sphere(torch.Generator(), 2000, 3, torch.float64, "cpu")
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-15)
    own = geo.random_points_on_sphere(torch.Generator().manual_seed(0), 2000, 3, torch.float64,
                                      "cpu").numpy()
    np.testing.assert_allclose(np.linalg.norm(own, axis=1), 1.0, atol=1e-12)
    assert np.abs(own.mean(0)).max() < 0.1


# ---------------------------------------------------------------------------
# models.nn and the terrain
# ---------------------------------------------------------------------------


def _jax_linear_draws(key, sizes):
    """JAX's mlp_init draws in layer order: ``split(key, L)``, then each
    layer's ``kw, kb``."""
    out = []
    for i, k in enumerate(jax.random.split(key, len(sizes) - 1)):
        kw, kb = jax.random.split(k)
        out.append((jax.random.normal(kw, (sizes[i], sizes[i + 1]), jnp.float32),
                    jax.random.normal(kb, (sizes[i + 1],), jnp.float32)))
    return out


def _feed_linear(monkeypatch, draws):
    it = iter(draws)
    monkeypatch.setattr(nn, "linear_draws", lambda *a: tuple(_t(x) for x in next(it)))


def test_mlp_matches_jax(monkeypatch):
    sizes = (2, 10, 10, 1)
    key = jax.random.key(0)
    jp = jnn.mlp_init(key, sizes, scale=0.5)
    _feed_linear(monkeypatch, _jax_linear_draws(key, sizes))
    tp = nn.mlp_init(torch.Generator(), sizes, scale=0.5, device="cpu")
    for a, b in zip(tp, jp):
        for k in ("weight", "bias"):
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    x = np.random.default_rng(0).normal(size=(5, 2))
    jp64 = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), jp)
    tp64 = interop.mlp_params_from_numpy(interop.mlp_params_to_numpy(
        [{k: v.double() for k, v in layer.items()} for layer in tp]), "cpu")
    for act in ("sin", "tanh", "relu", "sigmoid", "cos"):
        y = nn.mlp_apply(tp64, _t(x), getattr(nn, act), final_activation=nn.sigmoid)
        jy = jnn.mlp_apply(jp64, jnp.asarray(x), getattr(jnn, act), jnn.sigmoid)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-12)
    np.testing.assert_allclose(nn.binary_linear_apply(tp64[0], _t(x)).numpy(),
                               np.asarray(jnn.binary_linear_apply(jp64[0], jnp.asarray(x))),
                               atol=1e-12)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-6)])
def test_attention_matches_jax(dtype, tol):
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=s) for s in ((2, 4, 8), (2, 6, 8), (2, 6, 8)))
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    out, w = nn.attention(*(torch.from_numpy(a.astype(np_dtype)) for a in (q, k, v)))
    jout, jw = jnn.attention(*(jnp.asarray(a.astype(np_dtype)) for a in (q, k, v)))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=tol)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=tol)


def test_binarize_gradient_matches_jax_grad():
    w = np.array([0.3, -0.7, 0.0, 2.5, -1e-9])
    wt = torch.tensor(w, requires_grad=True)
    b = nn.binarize(wt)
    np.testing.assert_array_equal(b.detach().numpy(), np.asarray(jnn.binarize(jnp.asarray(w))))
    np.testing.assert_array_equal(b.detach().numpy(), [1.0, -1.0, 1.0, 1.0, -1.0])
    (g,) = torch.autograd.grad((nn.binarize(wt) * torch.arange(5.0, dtype=wt.dtype)).sum(), wt)
    jg = jax.grad(lambda x: jnp.sum(jnn.binarize(x) * jnp.arange(5.0)))(jnp.asarray(w))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


def test_terrain_matches_jax(monkeypatch):
    """TerrainNet on JAX's weights (carried across with interop), and the
    heightmap from JAX's draws."""
    key = jax.random.key(7)
    jnet = JTerrain(key, (10, 10), jnp.float64)
    net = TerrainNet.from_params(interop.mlp_params_from_numpy(jnet.params, "cpu"))
    xy = np.random.default_rng(3).uniform(-5, 5, (64, 2))
    np.testing.assert_allclose(net(_t(xy)).numpy(), np.asarray(jnet(jnp.asarray(xy))), atol=1e-12)
    back = interop.mlp_params_to_numpy(net.params)
    np.testing.assert_array_equal(back[1]["weight"], np.asarray(jnet.params[1]["weight"]))
    jxy, jz = j_heightmap(key, scale=5.0, resolution=40)
    _feed_linear(monkeypatch, _jax_linear_draws(key, (2, 10, 10, 1)))
    txy, tz = terrain_heightmap(torch.Generator(), scale=5.0, resolution=40, device="cpu")
    assert txy.shape == (1600, 2) and tz.shape == (1600,)
    scale = np.abs(np.asarray(jz)).max()
    np.testing.assert_allclose(txy.numpy(), np.asarray(jxy), atol=1e-6)
    np.testing.assert_allclose(tz.numpy() / scale, np.asarray(jz) / scale, atol=1e-6)
    grid = tz.numpy().reshape(40, 40)
    assert np.abs(np.diff(grid, axis=0)).mean() < tz.numpy().std()  # smooth


# ---------------------------------------------------------------------------
# The racer
# ---------------------------------------------------------------------------


def test_racer_matches_jax_and_oracle():
    params = RacerParams()
    rng = np.random.default_rng(0)
    actions = rng.uniform(-1, 1, (200, 4)) * np.array([50, 50, 5, 2.0])
    ref = oracle_racer_steps(params, actions)

    def body(st, a):
        st = j_racer_step(JRacerParams(), st, a)
        return st, (st.pos, st.R, st.omega)

    _, (jpos, jR, jomega) = jax.lax.scan(body, j_racer_reset((), jnp.float64),
                                         jnp.asarray(actions))
    st = racer_reset((), torch.float64, "cpu")
    for t, a in enumerate(actions):
        st = racer_step(params, st, torch.from_numpy(a))
        if t in (0, 1, 50, 199):
            for got, jw_, ref_ in ((st.pos, jpos[t], ref[t][0]), (st.R, jR[t], ref[t][1]),
                                   (st.omega, jomega[t], ref[t][2])):
                np.testing.assert_allclose(got.numpy(), ref_, atol=1e-10, err_msg=f"t={t}")
                np.testing.assert_allclose(got.numpy(), np.asarray(jw_), atol=1e-10)


def test_racer_tracks_rates_batched_and_interop():
    params = RacerParams()
    st = racer_reset((16,), torch.float64, "cpu")
    cmd = torch.tensor([80.0, 10.0, 0.0, 0.0], dtype=torch.float64).expand(16, 4)
    for _ in range(1500):
        st = racer_step(params, st, cmd)
    np.testing.assert_allclose(st.omega[:, :2].numpy(), np.tile([80.0, 10.0], (16, 1)), rtol=0.05)
    st = racer_step(params, racer_reset((16,), device="cpu"), torch.tensor([0, 0, 0, 1.0]))
    assert (st.vel[:, 2] > 0).all() and st.pos.shape == (16, 3)
    js = j_racer_step(JRacerParams(), j_racer_reset((16,), jnp.float32),
                      jnp.asarray([0, 0, 0, 1.0], jnp.float32))
    back = interop.racer_state_from_numpy(interop.to_numpy_tree(js), "cpu")
    for f in ("pos", "vel", "R", "omega", "is_first"):
        np.testing.assert_allclose(getattr(back, f).numpy(), getattr(st, f).numpy(), atol=1e-7)
    assert interop.racer_state_to_numpy(st)["R"].shape == (16, 3, 3)


# ---------------------------------------------------------------------------
# Profiling
# ---------------------------------------------------------------------------


def test_trace_writes_a_trace_and_measure_rate(tmp_path):
    with trace(str(tmp_path / "tr")):
        (torch.ones(64) * 2).sum()
    files = list((tmp_path / "tr").rglob("*.json"))
    assert files and files[0].stat().st_size > 0
    with trace(None):
        pass
