"""The port's fused kernels K2/K3/K4: their plain PyTorch versions against
the JAX Pallas kernels run with ``interpret=True`` on the CPU, the RNG hash
bit for bit, and the layouts. Each CUDA kernel against its plain version on
the card is in tests/test_torch_cuda.py, which imports no JAX.

Tolerances (tests/test_pallas_env.py, tests/test_pallas_step.py): one step
pos/vel 1e-5 and attitude 1e-6; K chained float32 steps pos/vel/prev_dist
2e-4, attitude 1e-4, reward sums 2e-3; the step counter t, crash flags and
every reset decision equal exactly. The RNG hash and the uniform draws are
exact uint32 arithmetic in both, so they are compared for equality; the
Box-Muller normals pass through log/cos/sin and differ by libm ulps (1e-6).
The CUDA kernels are built with --fmad=false and without fast math, so on
the card they match their plain versions to within libm ulps (1e-5 on
metre-scale positions after K steps).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fpyv_tpu.config import SimulatorConfig as JSim
from fpyv_tpu.envs.acro import AcroEnv as JEnv
from fpyv_tpu.ops import pallas_env as jpe
from fpyv_tpu.ops import pallas_step as jps
from fpyv_tpu.physics.drone import DroneParams as JP, drone_reset as jreset
from fpyv_tpu.physics.world import empty_world as jempty
from fpyv_tpu.world.generators import WorldSpec as JSpec, build_world as jbuild
from fpyv_tpu_torch import interop
from fpyv_tpu_torch.envs.acro import AcroEnv as TEnv
from fpyv_tpu_torch.ops import _build
from fpyv_tpu_torch.ops import env_kernel as tek
from fpyv_tpu_torch.ops import step_kernel as tsk
from fpyv_tpu_torch.physics.drone import DroneParams as TP
from fpyv_tpu_torch.world.generators import (CONTACT_CYLINDERS, CONTACT_SPHERES, contact_start,
                                              contact_world)

ROOT = Path(__file__).resolve().parents[1]
N = 64


def _tw(jworld, device="cpu"):
    return interop.world_from_numpy(interop.to_numpy_tree(jworld), device)


def _unpack(mat, rows):
    """Pallas (rows*8, N/8) sublane tiles -> the port's (rows, N)."""
    return np.asarray(mat).reshape(rows, -1)


# ---------------------------------------------------------------------------
# RNG: murmur3 counter hash, bit for bit
# ---------------------------------------------------------------------------

HASH_GRID = np.concatenate([np.arange(0, 4096, dtype=np.uint64),
                            np.linspace(0, 2**32 - 1, 4096, dtype=np.uint64)]).astype(np.uint32)


def test_murmur3_fmix_equal_exactly():
    ref = np.asarray(jpe._murmur3_fmix(jnp.asarray(HASH_GRID, jnp.uint32)))
    out = tek.murmur3_fmix(torch.from_numpy(HASH_GRID.astype(np.int64))).numpy()
    np.testing.assert_array_equal(out, ref.astype(np.int64))


@pytest.mark.parametrize("ctr", [0, 1, 32, 33, 47, 32 * 1000 + 9, 2**31 + 5, 2**32 - 1])
def test_uniform_draws_equal_exactly(ctr):
    lanes = HASH_GRID
    ref = np.asarray(jpe._uniform_01(jnp.asarray(lanes, jnp.uint32), jnp.uint32(ctr)))
    out = tek.uniform_01(torch.from_numpy(lanes.astype(np.int64)), ctr).numpy()
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


def test_normal_pair_close():
    lanes = torch.from_numpy(HASH_GRID.astype(np.int64))
    ja, jb = jpe._normal_pair(jnp.asarray(HASH_GRID, jnp.uint32), jnp.uint32(35), jnp.uint32(36))
    ta, tb = tek.normal_pair(lanes, 35, 36)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 7, -3])
def test_lane_ids_match_pallas_layout(seed):
    """Env n's pre-mix lane id in the (8, N/8) Pallas tiling is n."""
    n_lane = N // 8
    lane = (jax.lax.broadcasted_iota(jnp.uint32, (8, n_lane), 0) * jnp.uint32(n_lane)
            + jax.lax.broadcasted_iota(jnp.uint32, (8, n_lane), 1))
    lane = jpe._murmur3_fmix(lane ^ jpe._murmur3_fmix(jnp.asarray(seed, jnp.int32)
                                                      .astype(jnp.uint32)))
    out = tek.lane_ids(N, seed, "cpu").numpy()
    np.testing.assert_array_equal(out, np.asarray(lane).reshape(-1).astype(np.int64))


# ---------------------------------------------------------------------------
# K2 / K3: the plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _step_world(cylinders):
    w = jempty(n_spheres=2, n_cylinders=3 if cylinders else 0, ground=True, dtype=jnp.float32)
    w = w.replace(sphere_center=jnp.asarray([[3.0, 0.0, 5.0], [-4.0, 2.0, 8.0]], jnp.float32),
                  sphere_radius=jnp.asarray([1.0, 1.5], jnp.float32))
    if cylinders:
        w = w.replace(
            cyl_center=jnp.asarray([[0.0, 0.0, 0.0], [2.0, 1.0, 0.0], [-2.5, -1.0, 3.0]],
                                   jnp.float32),
            cyl_radius=jnp.asarray([1.0, 0.8, 1.5], jnp.float32),
            cyl_height=jnp.asarray([10.0, 6.0, 2.0], jnp.float32))
    return w


def _drones(seed, z_lo, z_hi, n=N):
    rng = np.random.default_rng(seed)
    f = np.float32
    pos = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(z_lo, z_hi, n)],
                   -1).astype(f)
    vel = rng.uniform(-2, 2, (n, 3)).astype(f)
    ypr = rng.uniform(-30, 30, (n, 3)).astype(f)
    act = rng.uniform(-0.4, 0.4, (n, 4)).astype(f)
    params = JP(att_mode="quat")
    js = jreset(params, *map(jnp.asarray, (pos, vel, ypr)))
    ts = interop.drone_state_from_numpy(interop.to_numpy_tree(js), "cpu")
    return js, ts, act


@pytest.mark.parametrize("cylinders", [False, True])
def test_k2_plain_matches_pallas(cylinders):
    jworld = _step_world(cylinders)
    js, ts, act = _drones(5, 0.02, 8.0)
    ref = jps.pallas_drone_step(JP(att_mode="quat"), js, jnp.asarray(act), jworld, interpret=True)
    before = dict(_build.launch_counts)
    out = tsk.fused_drone_step(TP(att_mode="quat"), ts, torch.from_numpy(act), _tw(jworld))
    assert _build.launch_counts == before  # the CPU path launches no kernel
    assert np.asarray(ref.done).any() and not np.asarray(ref.done).all()  # contact + free
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(ref.pos), atol=1e-5)
    # spring contacts (k = 100) turn a distance ulp into 1e-4 of velocity
    np.testing.assert_allclose(out.vel.numpy(), np.asarray(ref.vel), atol=2e-4)
    np.testing.assert_allclose(out.att.numpy(), np.asarray(ref.att), atol=1e-6)
    np.testing.assert_allclose(out.rates.numpy(), np.asarray(ref.rates), atol=1e-4)
    np.testing.assert_allclose(out.thrust.numpy(), np.asarray(ref.thrust), atol=1e-4)
    np.testing.assert_array_equal(out.done.numpy(), np.asarray(ref.done))


@pytest.mark.parametrize("cylinders", [False, True])
def test_k3_plain_matches_pallas(cylinders):
    jworld = _step_world(cylinders)
    js, ts, act = _drones(7, 15.0, 20.0)
    act[:, 3] = -0.6
    K = 20
    ref = jps.pallas_rollout(JP(att_mode="quat"), js, jnp.asarray(act), jworld, K,
                             interpret=True)
    out = tsk.fused_rollout(TP(att_mode="quat"), ts, torch.from_numpy(act), _tw(jworld), K)
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(ref.pos), atol=2e-4)
    np.testing.assert_allclose(out.vel.numpy(), np.asarray(ref.vel), atol=2e-4)
    np.testing.assert_allclose(out.att.numpy(), np.asarray(ref.att), atol=1e-4)
    np.testing.assert_array_equal(out.done.numpy(), np.asarray(ref.done))


def test_step_layouts_match_pallas():
    jworld = _step_world(True)
    js, ts, _ = _drones(1, 1.0, 9.0)
    np.testing.assert_array_equal(tsk.state_to_matrix(ts).numpy(),
                                  _unpack(jps.state_to_matrix(js), tsk.STATE_ROWS))
    tw = _tw(jworld)
    sph, S = jps._world_matrix(jworld)
    np.testing.assert_array_equal(tsk.sphere_matrix(tw).numpy(), np.asarray(sph)[:, :2])
    np.testing.assert_array_equal(tsk.cylinder_matrix(tw).numpy(),
                                  np.asarray(jps.cylinder_matrix(jworld))[:, :3])
    back = tsk.matrix_to_state(tsk.state_to_matrix(ts), ts)
    for k in ("pos", "vel", "att", "rates", "thrust", "done"):
        np.testing.assert_array_equal(getattr(back, k).numpy(), getattr(ts, k).numpy())


# ---------------------------------------------------------------------------
# K4: the plain version against the Pallas env kernel, across resets
# ---------------------------------------------------------------------------


def _env_pair(world="default", seed=3, **kw):
    common = dict(pos_low=(-5.0, -5.0, 30.0), pos_high=(5.0, 5.0, 40.0), **kw)
    jenv = JEnv(params=JP(att_mode="quat"), dtype=jnp.float32, **common)
    tenv = TEnv(params=TP(att_mode="quat"), **common)
    if world == "default":
        jworld = jenv.default_world()
    else:
        jworld = jbuild(JSpec.from_config(JSim(), seed=2), dtype=jnp.float32)
    keys = jax.random.split(jax.random.key(seed), N)
    js, _ = jax.vmap(lambda k: jenv.reset(k, jworld))(keys)
    ts = interop.acro_state_from_numpy(interop.to_numpy_tree(js), "cpu")
    act = np.zeros((N, 4), np.float32)
    act[:, 3] = -0.55
    return jenv, tenv, jworld, _tw(jworld), js, ts, act


def _compare_env(tout, jout, rsum, jrsum, tw_out=None, jw_out=None, extra_rows=True):
    a, b = interop.acro_state_to_numpy(tout), interop.to_numpy_tree(jout)
    np.testing.assert_array_equal(a["t"], b["t"])  # every reset decision equal
    np.testing.assert_array_equal(a["drone"]["done"], b["drone"]["done"])
    np.testing.assert_allclose(a["drone"]["pos"], b["drone"]["pos"], atol=2e-4)
    np.testing.assert_allclose(a["drone"]["vel"], b["drone"]["vel"], atol=2e-4)
    np.testing.assert_allclose(a["drone"]["att"], b["drone"]["att"], atol=1e-4)
    np.testing.assert_allclose(a["drone"]["rates"], b["drone"]["rates"], atol=1e-4)
    np.testing.assert_allclose(a["prev_dist"], b["prev_dist"], atol=2e-4)
    np.testing.assert_allclose(a["episode_return"], b["episode_return"], atol=2e-3)
    np.testing.assert_allclose(rsum.numpy(), np.asarray(jrsum), atol=2e-3)
    if extra_rows:
        for k in ("mass_scale", "drag_scale", "thrust_scale"):
            # affine maps of bit-equal uniform draws
            np.testing.assert_allclose(a["domain_rand"][k], b["domain_rand"][k], atol=1e-6)
        np.testing.assert_allclose(a["wind"], b["wind"], atol=1e-5)  # Box-Muller ulps
    if tw_out is not None:
        np.testing.assert_array_equal(tw_out.sphere_path_count.numpy(),
                                      np.asarray(jw_out.sphere_path_count))


@pytest.mark.parametrize("seed,max_steps", [(7, 9), (11, 10), (13, 8)])
def test_k4_plain_matches_pallas_across_resets(seed, max_steps):
    jenv, tenv, jworld, tworld, js, ts, act = _env_pair(max_episode_steps=max_steps)
    K = 25  # every env truncates twice or more
    jout, jw_out, jrsum = jpe.pallas_env_rollout(jenv, js, jnp.asarray(act), jworld, K,
                                                 seed=seed, interpret=True)
    tout, tw_out, rsum = tek.fused_env_rollout(tenv, ts, torch.from_numpy(act), tworld, K,
                                               seed=seed)
    assert (tout.t.numpy() < K).all()  # premise: resets happened
    _compare_env(tout, jout, rsum, jrsum, tw_out, jw_out)


def test_k4_params_world_with_dr_and_wind_across_resets():
    """The params.yaml world (cylinders) with DomainRand and wind gusts:
    draws 10..16 (DR resample, gusts) run on every reset."""
    jenv, tenv, jworld, tworld, js, ts, act = _env_pair(
        "params", seed=9, max_episode_steps=6, randomize=True, wind=(1.0, 0.5, 0.0),
        wind_scale=0.5)
    K = 14
    jout, jw_out, jrsum = jpe.pallas_env_rollout(jenv, js, jnp.asarray(act), jworld, K,
                                                 seed=5, interpret=True)
    tout, tw_out, rsum = tek.fused_env_rollout(tenv, ts, torch.from_numpy(act), tworld, K,
                                               seed=5)
    assert (tout.t.numpy() < K).all()
    ms0 = np.asarray(js.domain_rand.mass_scale)
    assert np.abs(tout.domain_rand.mass_scale.numpy() - ms0).max() > 1e-3  # resampled
    _compare_env(tout, jout, rsum, jrsum, tw_out, jw_out)


def test_k4_cylinder_crashes_match_pallas():
    """Drones dropped into the obstacle band: crash-driven resets equal."""
    jenv, tenv, jworld, tworld, js, ts, act = _env_pair("params", seed=9)
    cx, cy = np.asarray(jworld.cyl_center)[0, :2]
    pos = np.stack([cx + np.linspace(-3, 3, N), np.full(N, cy), np.linspace(0.3, 3.0, N)],
                   -1).astype(np.float32)
    dist = np.linalg.norm(np.asarray(jworld.sphere_center)[0] - pos, axis=-1).astype(np.float32)
    js = js.replace(drone=js.drone.replace(pos=jnp.asarray(pos)), prev_dist=jnp.asarray(dist))
    ts = ts.replace(drone=ts.drone.replace(pos=torch.from_numpy(pos)),
                    prev_dist=torch.from_numpy(dist))
    K = 3
    jout, _, jrsum = jpe.pallas_env_rollout(jenv, js, jnp.asarray(act), jworld, K, seed=2,
                                            interpret=True)
    tout, _, rsum = tek.fused_env_rollout(tenv, ts, torch.from_numpy(act), tworld, K, seed=2)
    assert (tout.t.numpy() < K).any()  # premise: some envs crashed and reset
    _compare_env(tout, jout, rsum, jrsum)


# ---------------------------------------------------------------------------
# A contact-heavy start: several motor points on a sphere and a cylinder in
# the same step. The contact forces are sums over motor points and
# primitives, and float addition is not associative, so these cases pin
# down the order (motor by motor: the ground, each sphere, each cylinder)
# that the CUDA K3 and K4 keep when they spread an env's motor points over
# the lanes of a warp.
# ---------------------------------------------------------------------------

def _contact_world():
    c = CONTACT_CYLINDERS
    return jempty(n_spheres=2, n_cylinders=8, ground=True, dtype=jnp.float32).replace(
        sphere_center=jnp.asarray(CONTACT_SPHERES), sphere_radius=jnp.ones((2,), jnp.float32),
        cyl_center=jnp.asarray(c[:, :3]), cyl_radius=jnp.asarray(c[:, 3]),
        cyl_height=jnp.asarray(c[:, 4]), cyl_active=jnp.asarray(c[:, 5] > 0))


def _contact_drones(seed, n=N, n_motors=4):
    """Drones at the gaps of ``contact_world`` (``contact_start``), hovering
    with random stick inputs."""
    pos, vel, ypr = contact_start(n, seed)
    act = np.random.default_rng(seed).uniform(-0.4, 0.4, (n, 4)).astype(np.float32)
    act[:, 3] = -0.6
    js = jreset(JP(att_mode="quat", n_motors=n_motors), *map(jnp.asarray, (pos, vel, ypr)))
    ts = interop.drone_state_from_numpy(interop.to_numpy_tree(js), "cpu")
    return js, ts, act


def _motor_contacts(ts, n_motors=4):
    """Per env, the motor points that touch a sphere and that touch an active
    cylinder at the first step (penetration below the motor radius)."""
    k = tsk.step_constants(TP(att_mode="quat", n_motors=n_motors))
    pos, (w, x, y, z) = ts.pos.numpy(), ts.att.numpy().T
    cols = np.stack([np.stack([1 - 2 * (y * y + z * z), 2 * (x * y + z * w), 2 * (x * z - y * w)], 1),
                     np.stack([2 * (x * y - z * w), 1 - 2 * (x * x + z * z), 2 * (y * z + x * w)], 1)])
    on_sphere, on_cyl = np.zeros(len(pos), int), np.zeros(len(pos), int)
    for m0, m1 in zip(k.motor_x, k.motor_y):
        mp = pos + cols[0] * m0 + cols[1] * m1
        sd = np.linalg.norm(mp[:, None] - CONTACT_SPHERES[None], axis=-1) - 1.0
        on_sphere += (sd < k.motor_radius).any(1)
        c = CONTACT_CYLINDERS
        d2d = np.linalg.norm(mp[:, None, :2] - c[None, :, :2], axis=-1) - c[None, :, 3]
        z0, z1 = c[None, :, 2], c[None, :, 2] + c[None, :, 4]
        band = (z0 < mp[:, None, 2]) & (mp[:, None, 2] < z1)
        dh = np.minimum(np.abs(mp[:, None, 2] - z0), np.abs(mp[:, None, 2] - z1))
        d = np.where(band, d2d, np.sqrt(d2d * d2d + dh * dh))
        on_cyl += ((d < k.motor_radius) & (c[None, :, 5] > 0)).any(1)
    return on_sphere, on_cyl


def _assert_contact_heavy(ts, n_motors=4):
    on_sphere, on_cyl = _motor_contacts(ts, n_motors)
    both = (on_sphere >= 1) & (on_cyl >= 1) & (on_sphere + on_cyl >= 2)
    assert both.sum() >= len(both) // 4, (on_sphere, on_cyl)  # premise


def test_contact_world_matches_its_jax_twin():
    """The port's ``contact_world`` (what the card checks use) is the world
    these CPU tests build for the JAX package."""
    a = interop.world_to_numpy(contact_world(device="cpu"))
    b = interop.to_numpy_tree(_contact_world())
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_env_probe_split_reads_the_instrumented_launch():
    """An instrumented K4 launch's probe: each phase's nanoseconds summed over
    the blocks' first threads become ms a launch per block; the last slot
    counts reset env-steps."""
    probe = torch.tensor([4_000_000, 8_000_000, 0, 12_000_000, 4_000_000, 7])
    split = tek.env_probe_split(probe, 4 * tek.ENVS_PER_BLOCK - 5)  # 4 blocks, the last ragged
    assert split == {"centres": 1.0, "head": 2.0, "contacts": 0.0, "tail": 3.0, "env": 1.0,
                     "resets": 7}


# The quad's cases keep their ids; the others put 3, 6 and 8 motor points
# (DroneParams.n_motors) through the same sums.
CONTACT_CASES = [pytest.param(17, 4, id="17"), pytest.param(23, 4, id="23"),
                 pytest.param(17, 3, id="17-m3"), pytest.param(23, 6, id="23-m6"),
                 pytest.param(17, 8, id="17-m8")]


@pytest.mark.parametrize("seed,n_motors", CONTACT_CASES)
def test_k3_plain_matches_pallas_contact_heavy(seed, n_motors):
    jworld = _contact_world()
    js, ts, act = _contact_drones(seed, n_motors=n_motors)
    _assert_contact_heavy(ts, n_motors)
    K = 6
    ref = jps.pallas_rollout(JP(att_mode="quat", n_motors=n_motors), js, jnp.asarray(act),
                             jworld, K, interpret=True)
    out = tsk.fused_rollout(TP(att_mode="quat", n_motors=n_motors), ts, torch.from_numpy(act),
                            _tw(jworld), K)
    assert np.asarray(ref.done).any()  # premise: motor points inside obstacles
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(ref.pos), atol=2e-4)
    np.testing.assert_allclose(out.vel.numpy(), np.asarray(ref.vel), atol=2e-4)
    np.testing.assert_allclose(out.att.numpy(), np.asarray(ref.att), atol=1e-4)
    np.testing.assert_array_equal(out.done.numpy(), np.asarray(ref.done))


@pytest.mark.parametrize("seed,n_motors", CONTACT_CASES)
def test_k4_plain_matches_pallas_contact_heavy(seed, n_motors):
    """The contact-heavy start through the env: contact forces, then the
    crash resets that follow."""
    common = dict(pos_low=(-5.0, -5.0, 30.0), pos_high=(5.0, 5.0, 40.0))
    jenv = JEnv(params=JP(att_mode="quat", n_motors=n_motors), dtype=jnp.float32, **common)
    tenv = TEnv(params=TP(att_mode="quat", n_motors=n_motors), **common)
    jworld = _contact_world()
    keys = jax.random.split(jax.random.key(seed), N)
    js, _ = jax.vmap(lambda k: jenv.reset(k, jworld))(keys)
    jd, td, act = _contact_drones(seed, n_motors=n_motors)
    _assert_contact_heavy(td, n_motors)
    dist = np.linalg.norm(CONTACT_SPHERES[0] - td.pos.numpy(), axis=-1).astype(np.float32)
    js = js.replace(drone=jd, prev_dist=jnp.asarray(dist))
    ts = interop.acro_state_from_numpy(interop.to_numpy_tree(js), "cpu")
    K = 5
    jout, jw_out, jrsum = jpe.pallas_env_rollout(jenv, js, jnp.asarray(act), jworld, K,
                                                 seed=seed, interpret=True)
    tout, tw_out, rsum = tek.fused_env_rollout(tenv, ts, torch.from_numpy(act), _tw(jworld), K,
                                               seed=seed)
    assert (tout.t.numpy() < K).any()  # premise: crashes reset envs
    _compare_env(tout, jout, rsum, jrsum, tw_out, jw_out)


def test_env_layouts_match_pallas():
    jenv, tenv, jworld, tworld, js, ts, _ = _env_pair("params", randomize=True)
    np.testing.assert_array_equal(tek.env_state_to_matrix(ts).numpy(),
                                  _unpack(jpe.env_state_to_matrix(js), tek.ENV_ROWS))
    S = jworld.num_spheres
    np.testing.assert_array_equal(tek.env_world_matrix(tworld).numpy(),
                                  np.asarray(jpe.env_world_matrix(jworld))[:, :S])
    back = tek.matrix_to_env_state(tek.env_state_to_matrix(ts), ts)
    a, b = interop.acro_state_to_numpy(back), interop.acro_state_to_numpy(ts)
    for k in ("t", "prev_dist", "episode_return", "wind"):
        np.testing.assert_array_equal(a[k], b[k])
    assert tek.env_constants(tenv).as_array().size == 24
    assert tsk.step_constants(tenv.params).as_array().size == 53  # 16-motor arrays


def test_step_constants_pad_motors_and_refuse_past_the_cap():
    """The motor arrays: the n_motors points of motor_layout, zero-padded to
    MAX_MOTORS in the launch array; 17 motors raise, naming the cap."""
    for n_motors in (2, 6, 16):
        k = tsk.step_constants(TP(att_mode="quat", n_motors=n_motors))
        assert k.n_motors == len(k.motor_x) == len(k.motor_y) == n_motors
        arr = k.as_array()
        i = [f.name for f in dataclasses.fields(k)].index("motor_x")  # 20 scalars before
        assert arr[i - 1] == n_motors  # the field before the motor arrays
        xs, ys = arr[i:i + tsk.MAX_MOTORS], arr[i + tsk.MAX_MOTORS:i + 2 * tsk.MAX_MOTORS]
        ref = jps.motor_layout(n_motors).astype(np.float32)  # JAX's points
        np.testing.assert_array_equal(xs[:n_motors], ref[:, 0])
        np.testing.assert_array_equal(ys[:n_motors], ref[:, 1])
        assert not xs[n_motors:].any() and not ys[n_motors:].any()
    with pytest.raises(ValueError, match="at most 16 motors"):
        tsk.step_constants(TP(att_mode="quat", n_motors=17))
    tworld = contact_world(device="cpu")
    js, ts, act = _contact_drones(17, n=8)
    with pytest.raises(ValueError, match="16"):
        tsk.fused_rollout(TP(att_mode="quat", n_motors=17), ts, torch.from_numpy(act[:8]),
                          tworld, 2)


def test_routing_gates_agree_with_jax_for_a_hexacopter():
    """The gates that send an env to a kernel read what JAX's read (att_mode,
    dtype, ground, DR and wind for K7) and not the motor count."""
    from fpyv_tpu.ops import pallas_policy as jpp
    from fpyv_tpu_torch.ops import policy_kernel as tpk
    for att_mode in ("quat", "rotmat"):
        for kw in (dict(), dict(randomize=True, wind=(1.0, 0.0, 0.0))):
            jp, tp = JP(att_mode=att_mode, n_motors=6), TP(att_mode=att_mode, n_motors=6)
            jenv = JEnv(params=jp, dtype=jnp.float32, **kw)
            tenv = TEnv(params=tp, **kw)
            for world in ("default", "ground"):
                jworld = jenv.default_world() if world == "default" else _contact_world()
                tworld = _tw(jworld)
                assert tsk.supported(tp, tworld) == jps._supported(jp, jworld)
                assert tek.env_supported(tenv, tworld) == jpe.env_supported(jenv, jworld)
                assert (tpk.policy_rollout_supported(tenv, tworld)
                        == jpp.policy_rollout_supported(jenv, jworld))
    jenv = JEnv(params=JP(att_mode="quat", n_motors=6), dtype=jnp.float32)
    tenv = TEnv(params=TP(att_mode="quat", n_motors=6))
    assert tek.env_supported(tenv, _tw(jenv.default_world()))  # the hexacopter is routed


def test_launches_refuse_cpu_tensors():
    tenv = TEnv(params=TP(att_mode="quat"))
    world = tenv.default_world("cpu")
    s = torch.zeros(tek.ENV_ROWS, 8)
    a = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tek.launch_env_rollout(tenv, s, a, tek.env_world_matrix(world), 4)
    with pytest.raises(ValueError, match="CUDA"):
        tsk.launch_rollout(tenv.params, s[:15].contiguous(), a, tsk.sphere_matrix(world), 4)


# ---------------------------------------------------------------------------
# Import hygiene: the port and chip_smoke.py never import JAX or fpyv_tpu
# ---------------------------------------------------------------------------


def test_port_imports_no_jax():
    code = r"""
import importlib, pkgutil, sys
before = set(sys.modules)
import fpyv_tpu_torch
for m in pkgutil.walk_packages(fpyv_tpu_torch.__path__, "fpyv_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
new = set(sys.modules) - before
bad = sorted(m for m in new
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "fpyv_tpu", "tools"))
assert not bad, bad
walked = {m.name for m in pkgutil.walk_packages(fpyv_tpu_torch.__path__, "fpyv_tpu_torch.")}
for name in ("ops.vision_kernel", "envs.vision_acro", "vision.raycast", "vision.renderer",
             "control.guidance", "sensors.uwb", "world.randomize", "world.render_bank",
             "models.policy", "rl.ppo", "rl.gae", "ops.policy_kernel", "apps.train",
             "utils.checkpoint", "envs.multi_race", "envs.vision_race", "ops.race_kernel",
             "apps.play", "rl.sac", "rl.replay", "rl.es", "envs.rotate", "parallel.mesh",
             "parallel.train", "parallel.launch", "cli", "apps.simulator", "viz.video",
             "viz.hud", "viz.render3d", "viz.pid_plot", "viz.trail", "inputs.rc",
             "inputs.mouse", "inputs.ports", "inputs.serial_readers", "inputs.build_native",
             "inputs.joystick_native", "io.logs", "io.blackbox_native", "oracle.sim",
             "sensors.gyro", "sensors.imu", "sensors.baro", "control.rates_controller",
             "control.flight_modes", "envs.sensor_acro", "envs.hover", "envs.ball",
             "envs.gridworld", "envs.wrappers", "envs.gym_adapter", "physics.racer",
             "vision.geometry", "models.nn", "models.terrain", "utils.debug"):
    assert "fpyv_tpu_torch." + name in walked, name
print("ok", len([m for m in new if m.startswith("fpyv_tpu_torch")]))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
    assert int(res.stdout.split()[1]) >= 50  # every module of the port was imported
