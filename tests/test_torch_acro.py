"""The port's AcroEnv against the JAX env on the CPU.

Both envs start from the same state (the JAX reset carried across with
``interop``). They draw resets from different generators (threefry keys
against ``torch.Generator``), so trajectories are compared up to the first
reset, and the port's reset draws are checked for their distributions.
Tolerances: 25 chained float32 steps, pos/vel/prev_dist 2e-4 and
attitude 1e-4, reward sums 2e-3 (tests/test_pallas_env.py); t equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fpyv_tpu.envs.acro import AcroEnv as JEnv
from fpyv_tpu.physics.drone import DroneParams as JP
from fpyv_tpu_torch import interop
from fpyv_tpu_torch.envs.acro import AcroEnv as TEnv, rollout, vector_reset
from fpyv_tpu_torch.envs.base import tree_where
from fpyv_tpu_torch.physics.drone import DroneParams as TP

HIGH = dict(pos_low=(-5.0, -5.0, 30.0), pos_high=(5.0, 5.0, 40.0))


def _pair(att_mode="quat", n=64, seed=3, **kw):
    jenv = JEnv(params=JP(att_mode=att_mode), dtype=jnp.float32, **kw)
    tenv = TEnv(params=TP(att_mode=att_mode), **kw)
    jworld = jenv.default_world()
    keys = jax.random.split(jax.random.key(seed), n)
    jstate, _ = jax.vmap(lambda k: jenv.reset(k, jworld))(keys)
    tstate = interop.acro_state_from_numpy(interop.to_numpy_tree(jstate), "cpu")
    tworld = interop.world_from_numpy(interop.to_numpy_tree(jworld), "cpu")
    return jenv, tenv, jworld, tworld, jstate, tstate


@pytest.mark.parametrize("att_mode", ["quat", "rotmat"])
def test_step_matches_jax_until_reset(att_mode):
    jenv, tenv, jworld, tworld, js, ts = _pair(att_mode, max_episode_steps=10_000,
                                               randomize=True, wind=(1.0, 0.5, 0.0),
                                               wind_scale=0.5, **HIGH)
    rng = np.random.default_rng(0)
    jstep = jax.jit(jax.vmap(lambda s, a, w: jenv.step(s, a, w), in_axes=(0, 0, None)))
    g = torch.Generator().manual_seed(0)
    jr_sum = np.zeros(64, np.float32)
    tr_sum = torch.zeros(64)
    for _ in range(25):
        act = rng.uniform(-0.3, 0.3, (64, 4)).astype(np.float32)
        act[:, 3] = -0.55
        js, jobs, jr, jd_, _ = jstep(js, jnp.asarray(act), jworld)
        ts, tobs, tr, td_, _ = tenv.step(ts, torch.from_numpy(act), tworld, generator=g)
        assert not np.asarray(jd_).any(), "test premise: no resets"
        np.testing.assert_array_equal(td_.numpy(), np.asarray(jd_))
        jr_sum += np.asarray(jr)
        tr_sum += tr
    a, b = interop.acro_state_to_numpy(ts), interop.to_numpy_tree(js)
    np.testing.assert_allclose(a["drone"]["pos"], b["drone"]["pos"], atol=2e-4)
    np.testing.assert_allclose(a["drone"]["vel"], b["drone"]["vel"], atol=2e-4)
    np.testing.assert_allclose(a["drone"]["att"], b["drone"]["att"], atol=1e-4)
    np.testing.assert_allclose(a["prev_dist"], b["prev_dist"], atol=2e-4)
    np.testing.assert_array_equal(a["t"], b["t"])
    np.testing.assert_allclose(a["episode_return"], b["episode_return"], atol=2e-3)
    np.testing.assert_allclose(tr_sum.numpy(), jr_sum, atol=2e-3)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=2e-4)


def test_rollout_with_moving_target_matches_jax():
    from fpyv_tpu.envs.acro import rollout as jrollout

    jenv, tenv, jworld, tworld, js, ts = _pair(max_episode_steps=10_000, **HIGH)
    policy = lambda obs: obs[..., :4] * 0.0 + jnp.asarray([0.1, -0.1, 0.0, -0.55])  # noqa: E731
    tpolicy = lambda obs: obs[..., :4] * 0.0 + torch.tensor([0.1, -0.1, 0.0, -0.55])  # noqa: E731
    js, jworld, jr, jd = jrollout(jenv, js, jworld, policy, 20)
    ts, tworld, tr, td = rollout(tenv, ts, tworld, tpolicy, 20,
                                 generator=torch.Generator().manual_seed(1))
    assert not np.asarray(jd).any()
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=2e-4)
    np.testing.assert_allclose(ts.drone.pos.numpy(), np.asarray(js.drone.pos), atol=2e-4)
    np.testing.assert_array_equal(tworld.sphere_path_count.numpy(),
                                  np.asarray(jworld.sphere_path_count))
    np.testing.assert_allclose(tworld.sphere_center.numpy(), np.asarray(jworld.sphere_center),
                               atol=1e-4)


def test_default_world_matches_jax():
    jenv, tenv, jworld, _, _, _ = _pair()
    a = interop.world_to_numpy(tenv.default_world("cpu"))
    b = interop.to_numpy_tree(jworld)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_reset_distributions():
    env = TEnv(params=TP(att_mode="quat"), randomize=True, wind=(1.0, 0.5, 0.0),
               wind_scale=0.5, **HIGH)
    g = torch.Generator().manual_seed(5)
    n = 4096
    st, obs = vector_reset(env, g, n, device="cpu")
    pos = st.drone.pos.numpy()
    assert (pos[:, :2] >= -5).all() and (pos[:, :2] <= 5).all()
    assert (pos[:, 2] >= 30).all() and (pos[:, 2] <= 40).all()
    vel = st.drone.vel.numpy()
    assert abs(vel.mean()) < 0.05 and 0.95 < vel.std() < 1.05
    q = st.drone.att.numpy()
    np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0, atol=1e-6)
    # |roll|, |pitch|, |yaw| <= 30 deg -> qw >= cos(45 deg) at most rotation
    assert (q[:, 0] > 0.8).all()
    for x, (lo, hi) in ((st.domain_rand.mass_scale, env.mass_range),
                        (st.domain_rand.drag_scale, env.drag_range),
                        (st.domain_rand.thrust_scale, env.thrust_range)):
        x = x.numpy()
        assert (x >= lo).all() and (x <= hi).all() and x.std() > 0.05
    w = st.wind.numpy()
    np.testing.assert_allclose(w.mean(0), env.wind, atol=0.05)
    np.testing.assert_allclose(w.std(0), 0.5, atol=0.05)
    assert (st.t.numpy() == 0).all() and st.t.dtype == torch.int32
    assert obs.shape == (n, env.obs_dim)
    world = env.default_world("cpu")
    np.testing.assert_allclose(st.prev_dist.numpy(), np.linalg.norm(
        world.sphere_center[0].numpy() - pos, axis=-1), rtol=1e-6)


def test_truncation_auto_resets():
    env = TEnv(params=TP(att_mode="quat"), max_episode_steps=5, **HIGH)
    g = torch.Generator().manual_seed(2)
    world = env.default_world("cpu")
    st, _ = vector_reset(env, g, 32, world)
    act = torch.zeros(32, 4)
    act[:, 3] = -0.55
    for i in range(7):
        st, _, _, done, info = env.step(st, act, world, generator=g)
        assert bool(done.all()) == (i == 4)
    assert (st.t.numpy() == 2).all()
    assert not st.drone.done.any()


def test_tree_where_selects_per_env():
    env = TEnv(params=TP(att_mode="quat"))
    g = torch.Generator().manual_seed(0)
    world = env.default_world("cpu")
    a, _ = vector_reset(env, g, 6, world)
    b, _ = vector_reset(env, g, 6, world)
    pred = torch.tensor([True, False, True, False, False, True])
    c = tree_where(pred, a, b)
    np.testing.assert_array_equal(c.drone.pos.numpy()[pred.numpy()], a.drone.pos.numpy()[pred.numpy()])
    np.testing.assert_array_equal(c.drone.att.numpy()[~pred.numpy()], b.drone.att.numpy()[~pred.numpy()])


def test_entry_points_refuse_missing_cuda():
    """Entry points run on CUDA unless told otherwise, and never fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TEnv().default_world()
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.world_from_numpy({})
