"""The port's env wrappers, gym adapter and health guards against the JAX
package's on the CPU: observation normalization, frame stacks, action
shaping, ``evaluate_policy``, ``GymAdapter`` (16 envs and 1, over every
env of the calling convention), ``finite_mask`` and ``assert_finite``'s
messages; and the new entry points' device rule (CUDA unless the caller
asks for the CPU, raising without a card).

Tolerances: obs norm 1e-12 in float64 (the same Welford update); frame
stacks and action shaping equal or 1e-7; ``evaluate_policy`` over the
acro env from JAX's resets, 50 float32 steps with no reset, 1e-4 on the
mean step reward (tests/test_torch_acro.py's reward-sum tolerance over its
steps); the guards' masks and messages equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpyv_tpu.envs.acro import AcroEnv as JAcro
from fpyv_tpu.envs.gym_adapter import GymAdapter as JGym
from fpyv_tpu.envs import wrappers as jw
from fpyv_tpu.utils.debug import assert_finite as j_assert_finite
from fpyv_tpu.utils.debug import finite_mask as j_finite_mask
from fpyv_tpu_torch import interop
from fpyv_tpu_torch.envs import (AcroEnv, BallEnv, GymAdapter, HoverEnv, MaComGridEnv,
                                 RotateEnv, SensorAcroEnv)
from fpyv_tpu_torch.envs import wrappers as tw
from fpyv_tpu_torch.utils import assert_finite, finite_mask


@pytest.fixture(autouse=True)
def one_thread():
    """Every tensor here is small: with the suite's workers sharing the
    cores, intra-op threads only add synchronisation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_obs_norm_matches_jax():
    rng = np.random.default_rng(0)
    data = rng.normal(3.0, 2.0, (20, 64, 5))
    st, jst = tw.obs_norm_init(5, torch.float64, "cpu"), jw.obs_norm_init(5, jnp.float64)
    assert st.count.item() == 1e-4
    for batch in data:
        st = tw.obs_norm_update(st, torch.from_numpy(batch))
        jst = jw.obs_norm_update(jst, jnp.asarray(batch))
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(jst, f)),
                                   atol=1e-12, rtol=1e-12)
    np.testing.assert_allclose(np.sqrt(st.var.numpy()), data.reshape(-1, 5).std(0), atol=0.01)
    out = tw.obs_norm_apply(st, torch.from_numpy(data[-1]))
    np.testing.assert_allclose(out.numpy(), np.asarray(jw.obs_norm_apply(
        jst, jnp.asarray(data[-1]))), atol=1e-12)
    big = tw.obs_norm_apply(tw.obs_norm_init(2, torch.float64, "cpu"),
                            torch.tensor([[1e6, -1e6]], dtype=torch.float64), clip=10.0)
    assert big.abs().max().item() == 10.0


def test_frame_stack_and_action_shaping_match_jax():
    f0 = np.random.default_rng(1).uniform(size=(4, 8, 8)).astype(np.float32)
    st, jst = tw.frame_stack_init(torch.from_numpy(f0), k=3), jw.frame_stack_init(
        jnp.asarray(f0), k=3)
    assert st.frames.shape == (4, 3, 8, 8)
    done = np.array([True, False, False, True])
    for i in range(3):
        f = f0 + i + 1
        st = tw.frame_stack_push(st, torch.from_numpy(f))
        jst = jw.frame_stack_push(jst, jnp.asarray(f))
        st = tw.frame_stack_reset_where(st, torch.from_numpy(done), torch.from_numpy(2 * f))
        jst = jw.frame_stack_reset_where(jst, jnp.asarray(done), jnp.asarray(2 * f))
        np.testing.assert_array_equal(st.frames.numpy(), np.asarray(jst.frames))
    a = torch.tensor([-3.0, 0.0, 3.0])
    np.testing.assert_allclose(tw.squash_action(a).numpy(),
                               np.asarray(jw.squash_action(jnp.asarray(a.numpy()))), atol=1e-7)
    np.testing.assert_allclose(tw.scale_action(torch.tensor([-1.0, 0.0, 1.0]), 0.0, 10.0).numpy(),
                               [0.0, 5.0, 10.0])


def test_evaluate_policy_matches_jax(monkeypatch):
    """JAX's evaluation from its keys, the port's from the same resets (fed
    through ``AcroEnv._fresh``); 50 steps at hover throttle from 20-30 m, no
    env resets, so every step is comparable."""
    kw = dict(pos_low=(-5.0, -5.0, 20.0), pos_high=(5.0, 5.0, 30.0))
    jenv, env = JAcro(dtype=jnp.float32, **kw), AcroEnv(**kw)
    jworld = jenv.default_world()
    world = interop.world_from_numpy(interop.to_numpy_tree(jworld), "cpu")
    key = jax.random.key(0)
    stats = jw.evaluate_policy(jenv, jworld, lambda o: jnp.zeros(o.shape[:-1] + (4,)).at[
        ..., 3].set(-0.646), key, n_envs=16, n_steps=50)
    assert int(stats["total_episodes"]) == 0  # premise: no resets
    jstate = jax.vmap(lambda k: jenv.reset(k, jworld))(jax.random.split(key, 16))[0]
    start = interop.acro_state_from_numpy(interop.to_numpy_tree(jstate), "cpu")
    monkeypatch.setattr(AcroEnv, "_fresh", lambda self, g, w, b, part=None: start)

    def policy(obs):
        a = torch.zeros(obs.shape[:-1] + (4,))
        a[..., 3] = -0.646
        return a

    got = tw.evaluate_policy(env, world, policy, torch.Generator(), 16, 50, device="cpu")
    assert set(got) == set(stats)
    np.testing.assert_allclose(got["mean_step_reward"].item(),
                               float(stats["mean_step_reward"]), atol=1e-4)
    for k in ("total_episodes", "crash_rate_per_step"):
        assert got[k].item() == float(stats[k])


def test_evaluate_policy_counts_episodes():
    """From its own generator with a falling action: finite statistics,
    crashes counted."""
    env = AcroEnv()
    got = tw.evaluate_policy(env, env.default_world("cpu"),
                             lambda o: torch.full(o.shape[:-1] + (4,), -1.0),
                             torch.Generator().manual_seed(0), 16, 120, device="cpu")
    assert all(torch.isfinite(v).all() for v in got.values())
    assert got["total_episodes"].item() > 0 and 0 < got["crash_rate_per_step"].item() < 1


def _rollout_shapes(g, action, steps=3):
    obs = g.reset()
    out = None
    for _ in range(steps):
        out = g.step(action)
    return obs, out


@pytest.mark.parametrize("num_envs", [16, 1])
def test_gym_adapter_acro_like_jax(num_envs):
    """The acro env through both adapters: numpy out, the same shapes and
    dtypes, the same info keys."""
    jenv, env = JAcro(dtype=jnp.float32), AcroEnv()
    jworld = jenv.default_world()
    world = interop.world_from_numpy(interop.to_numpy_tree(jworld), "cpu")
    shape = (num_envs,) if num_envs > 1 else ()
    a = np.zeros(shape + (4,), np.float32)
    a[..., 3] = -0.6
    jobs, (jo, jr, jd, jinfo) = _rollout_shapes(JGym(jenv, num_envs, 0, (jworld,)), a)
    tobs, (to, tr, td, tinfo) = _rollout_shapes(GymAdapter(env, num_envs, 0, (world,),
                                                           device="cpu"), a)
    for t, j in ((tobs, jobs), (to, jo), (tr, jr), (td, jd)):
        assert isinstance(t, np.ndarray) and t.shape == np.shape(j) and t.dtype == np.asarray(
            j).dtype
    assert set(tinfo) == set(jinfo) and isinstance(tinfo["dist_to_target"], np.ndarray)
    assert isinstance(tinfo["imu"].accel_body, np.ndarray)


@pytest.mark.parametrize("make,action", [
    (lambda: RotateEnv(), np.zeros(3, np.float32)),
    (lambda: SensorAcroEnv(), np.array([0.0, 0.0, 0.0, -0.6], np.float32)),
    (lambda: HoverEnv(), np.array([0.0, 0.0, 0.0, -0.64], np.float32)),
    (lambda: BallEnv(), np.array([0.01, -0.01], np.float32)),
], ids=["rotate", "sensor_acro", "hover", "ball"])
def test_gym_adapter_drives_every_env(make, action):
    """Every env of the calling convention, unbatched (num_envs 1, JAX's
    shapes: rotate's (3, 3, 2)) and a bank of 16."""
    env = make()
    args = (env.acro.default_world("cpu"),) if isinstance(env, SensorAcroEnv) else ()
    g1 = GymAdapter(env, 1, seed=1, env_args=args, device="cpu")
    obs, (o, r, d, _) = _rollout_shapes(g1, action)
    assert np.ndim(r) == 0 and np.ndim(d) == 0 and o.shape == obs.shape
    if isinstance(env, RotateEnv):
        assert obs.shape == (3, 3, 2)
    g16 = GymAdapter(env, 16, seed=1, env_args=args, device="cpu")
    obs16, (o16, r16, d16, _) = _rollout_shapes(g16, np.broadcast_to(action, (16,) + action.shape))
    assert obs16.shape == (16,) + obs.shape and r16.shape == (16,) and d16.dtype == np.bool_
    g16.seed(1)
    np.testing.assert_array_equal(g16.reset(), obs16)  # re-seeded: the same first draws


def test_gym_adapter_grid_dict_actions():
    g = GymAdapter(MaComGridEnv(), 4, seed=0, device="cpu")
    obs = g.reset()
    assert obs["Instructor"].shape == (4, 3, 3)
    obs, r, d, _ = g.step({"Instructor": np.zeros((4, 2), np.float32),
                           "Apprentice": np.array([0, 1, 2, 3])})
    assert r.shape == (4,) and obs["Apprentice"].shape == (4, 2)
    with pytest.raises(RuntimeError, match="reset"):
        GymAdapter(MaComGridEnv(), 4, device="cpu").step({})


def test_new_entry_points_default_to_cuda():
    """``device=None`` means CUDA: on the card the state lands there; without
    one the entry points raise rather than fall back to the CPU."""
    calls = [lambda: HoverEnv().reset(torch.Generator(), (2,)),
             lambda: SensorAcroEnv().reset(torch.Generator(), None, (2,)),
             lambda: GymAdapter(AcroEnv(), 2),
             lambda: tw.evaluate_policy(AcroEnv(), None, lambda o: torch.zeros(
                 o.shape[:-1] + (4,), device=o.device), torch.Generator(), 2, 1)]
    for call in calls:
        if torch.cuda.is_available():
            out = call()
            dev = (out.device if isinstance(out, GymAdapter) else
                   next(v for v in out.values()).device if isinstance(out, dict) else
                   out[1].device)
            assert dev.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                call()


# ---------------------------------------------------------------------------
# Health guards
# ---------------------------------------------------------------------------


def test_finite_mask_matches_jax():
    tree = {"a": np.ones((4, 3), np.float32), "b": np.zeros(4, np.float32),
            "i": np.arange(4), "n": [np.ones((4, 2, 2), np.float64)]}
    tree["a"][2, 1] = np.nan
    tree["b"][3] = np.inf
    tree["n"][0][1, 0, 1] = -np.inf
    got = finite_mask({k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else
                           [torch.from_numpy(x) for x in v]) for k, v in tree.items()})
    want = j_finite_mask(jax.tree.map(jnp.asarray, tree))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [True, False, False, False])
    with pytest.raises(ValueError):
        finite_mask({"i": torch.arange(3)})


def test_assert_finite_names_leaves_as_jax():
    """The same message from both packages: a dict, a list and an acro state
    whose drone position and one wind are poisoned."""
    jenv = JAcro(dtype=jnp.float32)
    js = jax.vmap(lambda k: jenv.reset(k, jenv.default_world())[0])(
        jax.random.split(jax.random.key(0), 4))
    js = js.replace(drone=js.drone.replace(pos=js.drone.pos.at[1, 2].set(jnp.nan)),
                    wind=js.wind.at[3].set(jnp.inf))
    ts = interop.acro_state_from_numpy(interop.to_numpy_tree(js), "cpu")
    mask = finite_mask(ts)
    np.testing.assert_array_equal(mask.numpy(), [True, False, True, False])
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_finite_mask(js.replace(
        key=jnp.zeros(4)))))
    messages = []
    for t, j in (({"bad": torch.tensor([1.0, float("nan")]), "ok": [torch.ones(2)]},
                  {"bad": jnp.asarray([1.0, jnp.nan]), "ok": [jnp.ones(2)]}),
                 (ts, js.replace(key=jnp.zeros(4))),
                 ((torch.ones(1), [float("inf")]), (jnp.ones(1), [float("inf")]))):
        with pytest.raises(FloatingPointError) as te:
            assert_finite(t, name="state")
        with pytest.raises(FloatingPointError) as je:
            j_assert_finite(j, name="state")
        assert str(te.value) == str(je.value)
        messages.append(str(te.value))
    assert messages[0] == "non-finite values in state: ['bad'] (1 values)"
    assert messages[1] == "non-finite values in state: .drone.pos (1 values), .wind (3 values)"
    assert messages[2] == "non-finite values in state: [1][0] (1 values)"
    assert_finite({"ok": torch.ones(3), "i": torch.arange(2)})
