"""Policy-in-kernel vision RACE rollout: CUDA kernel K8 with its plain
PyTorch version (mirrors ``fpyv_tpu.ops.pallas_race``).

One launch runs T steps of the pixel race trainer's rollout over the whole
race bank. Per step and env: render the gate track, the ground and the
orbiting obstacles (their centres at episode time t) in patch-major pixel
order; push the frame onto a K-frame stack in patch-stack-major order (per
patch, K frames of 64 levels, oldest first); run the patch actor
(:class:`~fpyv_tpu_torch.models.policy.PixelActorCritic`, a K*64-wide embed)
with the proprio [rates / max (3), accel_z / 30, thrust / max, next-gate
one-hot (G)]; sample a Gaussian action with its log-prob; then the
single-agent ``MultiRaceEnv`` step: K1 against the obstacles at t + 1, gate
passing, the centre-progress reward, termination on a crash or at
``max_episode_steps``, and the respawn on the ring behind gate 0.

- State: the (N, 22) env-major float32 matrix of :func:`race_state_to_cols`
  (0:3 pos, 3:6 vel, 6:10 quat, 10:13 rates, 13 thrust, 14 crashed, 15 t,
  16 next_gate, 17 prev_center_dist, 18 accel_z, 19 gates_passed,
  20 prev_gate_dist, 21 flush: set on the step after a reset, it replaces
  every older frame of the stack with the current one).
- History: (N, NP*(K-1)*64) uint8, the K-1 older frames of each patch, the
  stack's first K-1 slots at the first step (nothing at K = 1).
- Outputs: frames (T, N, NP*K*64) uint8 levels (the stacks), extra (T, N, 16)
  the proprio padded with zeros, aux (T, N, 8) [a0..a3, reward, env_done,
  value, log_prob], and the final state. aux column 5 is the env's end (a
  crash or the time limit), where K7's holds the crash alone.
- RNG: K4's murmur3 stream with the global env index as lane; step i of a
  launch uses draws ``(i + 1) * 32 + d``: d = 0..3 for the respawn jitter,
  d = 20..23 for the action noise.

Obstacle centres follow the Pallas kernel's float formula
``(2 pi mod(count0 + t, res)) / res`` (``res`` clamped to >= 1), which
differs by ulps from the env's ``2 pi (mod / res)``.

The plain version (:func:`race_vision_rollout_reference`) accumulates every
product in the float32 kernel's row order, so on the card the two agree bit
for bit in float32; the bf16 kernel's tensor-core sums agree within
:data:`~fpyv_tpu_torch.ops.policy_kernel.TOL_BF16_HEADS`. A CPU tensor runs
the plain version; a CUDA tensor launches the kernel, and anything the
kernel does not take raises.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from fpyv_tpu_torch.envs.vision_race import per_camera_world
from fpyv_tpu_torch.ops import _build
from fpyv_tpu_torch.ops.env_kernel import _TWO_PI, lane_ids, normal_pair
from fpyv_tpu_torch.ops.policy_kernel import (
    ENVS_PER_BLOCK,
    PP,
    SHARED_LIMIT,  # noqa: F401
    PolicyWeights,
    _aligned_floats,
    _boot_levels,
    _check_actor_launch,
    _kernel_rollout_fn,
    actor_batch,
    device_patch_dcam,
    policy_forward_reference,
    pre_cols,
    proprio_divisors,
    tc_tile_bytes,
)
from fpyv_tpu_torch.ops.step_kernel import (
    _f32,
    step_components,
    step_constants,
    step_constants_array,
)
from fpyv_tpu_torch.ops.vision_kernel import (
    RenderConfig,
    camera_rows,
    depth_levels,
    render_tiles,
    world_cols,
)
from fpyv_tpu_torch.physics.world import World

RROWS = 22
N_EXTRA = 16  # the proprio block [rates (3), accel_z, thrust, one-hot (G)] and its zero pad
N_AUX = 8
OCOLS = 8  # per obstacle: path centre (3), path radius, res, count0, radius, 0


# ---------------------------------------------------------------------------
# Configuration and constants
# ---------------------------------------------------------------------------


def _check_supported(venv) -> None:
    race = venv.race
    if not (race.n_agents == 1 and race.params.att_mode == "quat"
            and race.dtype == torch.float32):
        raise ValueError("the kernel race rollout is single-agent, quat, float32 "
                         "(multi-agent views read other envs' positions)")


def race_render_config(venv) -> RenderConfig:
    """K8's render: the obstacle spheres (their columns rewritten every
    step), no cylinders, the gates and the ground."""
    race = venv.race
    S = race.n_obstacles
    return RenderConfig(n_spheres=S, n_cylinders=0, n_gates=race.n_gates, spheres=S > 0,
                        cylinders=False, ground=True, gates=True,
                        max_depth=float(venv.max_depth), ground_extent=None,
                        frame_width=float(venv.frame_width))


@dataclass(frozen=True)
class RaceConstants:
    """float32 launch constants in the order of ``RaceConsts`` in
    ``csrc/race_kernels.cu``."""

    max_steps: float
    spawn_x: float  # track_radius + spawn_radius
    spawn_y: float  # -3 - spawn_radius
    spawn_z: float
    jitter: float  # the spawn jitter's std
    w_gate: float
    w_progress: float
    w_alive: float
    w_crash: float
    inv_max_rates: float
    inv_30: float
    inv_max_force: float
    log_2pi2: float
    sq2h: float  # cos and sin of the 90 deg spawn yaw's half-angle
    onehot: float  # 1.0 where the next-gate one-hot feeds the policy
    mount: Tuple[float, ...]  # 9, row major
    rel: Tuple[float, float, float]

    def as_array(self) -> np.ndarray:
        vals = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            vals.extend(v if isinstance(v, tuple) else [v])
        return np.asarray(vals, np.float32)


@functools.lru_cache(maxsize=32)
def race_constants(venv) -> RaceConstants:
    """Each Python-float constant of ``pallas_race._kernel`` rounded once to
    float32."""
    race, rig = venv.race, venv.rig
    return RaceConstants(
        max_steps=_f32(race.max_episode_steps),
        spawn_x=_f32(race.track_radius + race.spawn_radius),
        spawn_y=_f32(-3.0 - race.spawn_radius), spawn_z=_f32(race.spawn_height),
        jitter=_f32(0.3), w_gate=_f32(race.w_gate), w_progress=_f32(race.w_progress),
        w_alive=_f32(race.w_alive), w_crash=_f32(race.w_crash),
        inv_max_rates=_f32(1.0 / float(race.params.max_rates)), inv_30=_f32(1.0 / 30.0),
        inv_max_force=_f32(1.0 / float(race.params.thrust_curve.max_force)),
        log_2pi2=_f32(2.0 * math.log(2.0 * math.pi)), sq2h=_f32(math.sqrt(0.5)),
        onehot=1.0 if venv.gate_onehot else 0.0,
        mount=tuple(_f32(x) for x in np.asarray(rig.mount_rotation).reshape(-1)),
        rel=tuple(_f32(x) for x in rig.rel_position))


def race_shared_bytes(hw: int, frame_stack: int, n_obstacles: int, n_gates: int, hidden: int,
                      pool: int, batch: int = 0) -> int:
    """Shared memory of one K8 block (``shared_bytes`` in
    ``csrc/race_kernels.cu``): the level table, per-env camera, proprio,
    heads, flush flag, world columns, obstacle rows and the render's
    invariant table, the hidden layer and the current frames (one byte a
    pixel). ``batch`` 0 is the float32 layout: one fc group's input, the
    pooled embeddings and one patch group's stacks. Else the bf16 layout: the tensor-core tiles for batches
    of ``batch`` patches, whose levels tile holds the stacks. The K-1 older
    frames stay in device memory either way."""
    wcols = 5 * n_obstacles + 15 * n_gates + 1
    E = ENVS_PER_BLOCK
    head = (16 + N_EXTRA + N_AUX + 1 + wcols + 5 * n_obstacles
            + pre_cols(n_obstacles, 0, n_gates))
    if batch == 0:
        floats = 256 + E * (head + 128 + hidden + (pool * 128 if pool > 1 else 0))
        return floats * 4 + E * hw + E * pool * frame_stack * PP
    return (4 * _aligned_floats(256 + E * (head + hidden))
            + tc_tile_bytes(frame_stack * PP, batch, pool) + E * hw)


def race_actor_batch(hw: int, frame_stack: int, n_obstacles: int, n_gates: int, hidden: int,
                     pool: int) -> int:
    """Patches a barrier pass of K8's bf16 actor (0: no batch fits)."""
    return actor_batch(hw // PP, pool, lambda b: race_shared_bytes(
        hw, frame_stack, n_obstacles, n_gates, hidden, pool, b))


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------


def race_state_to_cols(state) -> torch.Tensor:
    """Batched single-agent MultiRaceState -> (N, 22) env-major float32. The
    flush flag starts at 1 where episode time is 0 (a fresh env's history
    is its first frame repeated, what a flush to the current frame gives)."""
    d = state.drones
    f = torch.float32

    def sq(x):  # drop the A == 1 agent axis
        return x[:, 0].to(f)

    return torch.cat([sq(d.pos), sq(d.vel), sq(d.att), sq(d.rates), sq(d.thrust)[:, None],
                      sq(d.done)[:, None], state.t.to(f)[:, None],
                      sq(state.next_gate)[:, None], sq(state.prev_center_dist)[:, None],
                      sq(d.accel)[:, 2:3], sq(state.gates_passed)[:, None],
                      sq(state.prev_gate_dist)[:, None], (state.t == 0).to(f)[:, None]],
                     dim=1).contiguous()


def race_world_cols(world: World) -> torch.Tensor:
    """(1, 15G + 1) the shared track's gate columns and the ground column
    (``world_cols``' layout past its sphere and cylinder blocks)."""
    skip = 5 * world.num_spheres + 6 * world.num_cylinders
    return world_cols(world)[:, skip:].contiguous()


def obstacle_cols(world: World, n_obstacles: int) -> torch.Tensor:
    """(1, max(S, 1)*8) [path_cx path_cy path_cz path_r res count0 radius 0]
    per obstacle sphere (``pallas_race._obstacle_cols``, one shared row)."""
    dev = world.gate_pos.device
    S = n_obstacles
    if S == 0:
        return torch.zeros(1, OCOLS, dtype=torch.float32, device=dev)
    f = torch.float32
    cols = torch.cat([world.sphere_path_center[:S].to(f),
                      world.sphere_path_radius[:S].to(f)[:, None],
                      world.sphere_path_res[:S].to(f)[:, None],
                      world.sphere_path_count[:S].to(f)[:, None],
                      world.sphere_radius[:S].to(f)[:, None],
                      torch.zeros(S, 1, dtype=f, device=dev)], dim=1)
    return cols.reshape(1, S * OCOLS).contiguous()


def obstacles_at(ocol: torch.Tensor, n_obstacles: int, t: torch.Tensor):
    """Obstacle spheres at episode time t (N,) as K1's (cx, cy, cz, r,
    active) rows: ``theta = (2 pi mod(count0 + t, res)) / res``, res >= 1."""
    out = []
    for s in range(n_obstacles):
        oc = [ocol[:, s * OCOLS + j] for j in range(OCOLS)]
        res = torch.clamp_min(oc[4], 1.0)
        theta = _f32(_TWO_PI) * torch.remainder(oc[5] + t, res) / res
        cx = oc[0] + oc[3] * torch.cos(theta)
        cy = oc[1] + oc[3] * torch.sin(theta)
        out.append((cx, cy, oc[2].expand_as(cx), oc[6].expand_as(cx), torch.ones_like(cx)))
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch version of K8
# ---------------------------------------------------------------------------


def race_vision_rollout_reference(venv, state_cols: torch.Tensor, hist: torch.Tensor,
                                  wcol: torch.Tensor, ocol: torch.Tensor, weights: PolicyWeights,
                                  n_steps: int, seed: int, patch_pool: int = 1,
                                  forced_actions: Optional[torch.Tensor] = None):
    """Plain version of K8, line by line as ``pallas_race._kernel``. Returns
    (frames (T, N, NP*K*64) uint8, extra (T, N, 16), aux (T, N, 8), state
    (N, 22)).

    ``forced_actions`` (T, N, 4) teacher-forces the env: each step still
    renders, stacks, runs the actor and samples (the aux row holds that
    sample, value and log-prob), but the env advances with the given
    action."""
    race = venv.race
    cfg = race_render_config(venv)
    k = step_constants(race.params)
    c = race_constants(venv)
    dev = state_cols.device
    n = state_cols.shape[0]
    W, H = venv.rig.resolution
    NP, K, S, G = (W * H) // PP, venv.frame_stack, race.n_obstacles, race.n_gates
    if 5 + G > N_EXTRA:
        raise ValueError(f"the proprio block 5 + {G} exceeds its {N_EXTRA} columns")
    lane = lane_ids(n, seed, dev)
    dcam = device_patch_dcam(venv.rig, dev)
    gates = wcol[0, :15 * G].reshape(G, 15)
    wgates = wcol.expand(n, -1)
    std = [float(v) for v in weights.std[0].tolist()]
    st = list(state_cols.unbind(1))
    older = hist.to(torch.float32).reshape(n, NP, K - 1, PP)
    frames, extras, auxs = [], [], []
    for i in range(n_steps):
        cR, (cx, cy, cz) = camera_rows(c.mount, c.rel, st)
        zero = torch.zeros_like(cx)
        cam = torch.stack([cx, cy, cz] + cR + [zero] * 4, dim=1)
        sph = obstacles_at(ocol, S, st[15])
        wenv = torch.cat([torch.stack([v for s in sph for v in s], dim=1), wgates], dim=1) \
            if S else wgates
        cur = depth_levels(render_tiles(cfg, dcam, cam, wenv), cfg.max_depth).reshape(n, NP, 1, PP)
        # shift, flush on the step after a reset, newest last
        flush = (st[21] > 0.5)[:, None, None, None]
        stack = torch.cat([torch.where(flush, cur.expand_as(older), older), cur], dim=2)
        older = stack[:, :, 1:]
        levels = stack.reshape(n, NP * K * PP)
        frames.append(levels.to(torch.uint8))

        masks = [(torch.abs(st[16] - g) < 0.5).to(torch.float32) for g in range(G)]
        prop = [st[10] * c.inv_max_rates, st[11] * c.inv_max_rates, st[12] * c.inv_max_rates,
                st[18] * c.inv_30, st[13] * c.inv_max_force] + [m * c.onehot for m in masks]
        extras.append(torch.stack(prop + [zero] * (N_EXTRA - len(prop)), dim=1))
        mm = policy_forward_reference(weights, levels, prop, patch_pool)

        base = (i + 1) * 32
        z0, z1 = normal_pair(lane, base + 20, base + 21)
        z2, z3 = normal_pair(lane, base + 22, base + 23)
        z = (z0, z1, z2, z3)
        a = [mm[:, j] + std[j] * z[j] for j in range(4)]
        log_prob = (-0.5 * (z0 * z0 + z1 * z1 + z2 * z2 + z3 * z3)
                    - _f32(_f32(_f32(std[4] + std[5]) + std[6]) + std[7]) - c.log_2pi2)
        act = a if forced_actions is None else list(forced_actions[i].unbind(1))
        phys = step_components(k, obstacles_at(ocol, S, st[15] + 1.0), st[:15], act,
                               with_accel_z=True)
        crashed = phys[14]

        # gate passing and reward (multi_race.step at A == 1)
        g1 = gates[st[16].long()]
        relx, rely, relz = phys[0] - g1[:, 0], phys[1] - g1[:, 1], phys[2] - g1[:, 2]
        plane_d = relx * g1[:, 3] + rely * g1[:, 4] + relz * g1[:, 5]
        lat2 = (relx * relx + rely * rely + relz * relz) - plane_d * plane_d
        lateral = torch.sqrt(torch.clamp_min(lat2, 0.0))
        center_d = torch.sqrt(relx * relx + rely * rely + relz * relz)
        newly_crashed = crashed * (1.0 - st[14])
        f = torch.float32
        passed = ((st[20] < 0).to(f) * (plane_d >= 0).to(f) * (lateral < g1[:, 12] * 0.5).to(f)
                  * (1.0 - crashed))
        ng2 = torch.remainder(st[16] + passed, float(G))
        gates2 = st[19] + passed
        g2 = gates[ng2.long()]
        r2x, r2y, r2z = phys[0] - g2[:, 0], phys[1] - g2[:, 1], phys[2] - g2[:, 2]
        plane_d_new = r2x * g2[:, 3] + r2y * g2[:, 4] + r2z * g2[:, 5]
        center_d_new = torch.sqrt(r2x * r2x + r2y * r2y + r2z * r2z)
        progress = (1.0 - passed) * (st[17] - center_d)
        reward = (c.w_gate * passed + c.w_progress * progress + c.w_alive * (1.0 - crashed)
                  - c.w_crash * newly_crashed)
        t_next = st[15] + 1.0
        env_done = torch.maximum(crashed, (t_next >= c.max_steps).to(f))
        auxs.append(torch.stack(a + [reward, env_done, mm[:, 4], log_prob], dim=1))

        # respawn (multi_race._sample_drones at A == 1): draws 0..3
        j0, j1 = normal_pair(lane, base + 0, base + 1)
        j2, _ = normal_pair(lane, base + 2, base + 3)
        sx, sy, sz = c.spawn_x + c.jitter * j0, c.spawn_y + c.jitter * j1, c.spawn_z + c.jitter * j2
        d0x, d0y, d0z = sx - gates[0, 0], sy - gates[0, 1], sz - gates[0, 2]
        plane_d0 = d0x * gates[0, 3] + d0y * gates[0, 4] + d0z * gates[0, 5]
        center_d0 = torch.sqrt(d0x * d0x + d0y * d0y + d0z * d0z)
        one, sq2h = torch.ones_like(zero), torch.full_like(zero, c.sq2h)
        live = phys[:15] + [t_next, ng2, center_d_new, phys[15], gates2, plane_d_new, zero]
        reset = ([sx, sy, sz] + [zero] * 3 + [sq2h, zero, zero, sq2h] + [zero] * 7
                 + [center_d0, zero, zero, plane_d0, one])
        sel = env_done > 0.5
        st = [torch.where(sel, r, l) for r, l in zip(reset, live)]
    return (torch.stack(frames), torch.stack(extras), torch.stack(auxs),
            torch.stack(st, dim=1).contiguous())


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------


def launch_race_vision_rollout(venv, state_cols: torch.Tensor, hist: torch.Tensor,
                               wcol: torch.Tensor, ocol: torch.Tensor, weights: PolicyWeights,
                               n_steps: int, seed: int, patch_pool: int = 1,
                               phase_ns: Optional[torch.Tensor] = None):
    """K8 on the card; returns what :func:`race_vision_rollout_reference`
    returns. ``phase_ns`` launches the instrumented instantiation, as in
    :func:`~fpyv_tpu_torch.ops.policy_kernel.launch_policy_vision_rollout`."""
    race, rig = venv.race, venv.rig
    n = state_cols.shape[0]
    W, H = rig.resolution
    hw, hidden = W * H, weights.wf.shape[1]
    NP, K, S, G = hw // PP, venv.frame_stack, race.n_obstacles, race.n_gates
    batch, timing = _check_actor_launch(
        "race_vision_rollout", state_cols, weights, rig, K, 5 + G, patch_pool, n_steps,
        race.params.n_motors, phase_ns, lambda b: race_shared_bytes(
            hw, K, S, G, hidden, patch_pool, b), world_cols=wcol, obstacle_cols=ocol)
    _check_supported(venv)
    device, dt = state_cols.device, weights.we.dtype
    if state_cols.shape != (n, RROWS) or wcol.shape != (1, 15 * G + 1):
        raise ValueError(f"state / world columns must be (N, {RROWS}) / (1, {15 * G + 1})")
    if ocol.shape != (1, max(S, 1) * OCOLS):
        raise ValueError(f"obstacle columns must be (1, {max(S, 1) * OCOLS})")
    if (hist.device != device or hist.dtype != torch.uint8 or not hist.is_contiguous()
            or hist.shape != (n, NP * (K - 1) * PP)):
        raise ValueError(f"the history must be a contiguous (N, {NP * (K - 1) * PP}) uint8 "
                         f"tensor on {device}")
    if 5 + G > N_EXTRA:
        raise ValueError(f"the proprio block 5 + {G} exceeds its {N_EXTRA} columns")
    lib = _build.library()
    kc = step_constants_array(race.params)
    rcon = race_constants(venv).as_array()
    rc = race_render_config(venv).as_array()
    dcam = device_patch_dcam(rig, device)
    frames = torch.empty(n_steps, n, NP * K * PP, dtype=torch.uint8, device=device)
    extra = torch.empty(n_steps, n, N_EXTRA, dtype=torch.float32, device=device)
    aux = torch.empty(n_steps, n, N_AUX, dtype=torch.float32, device=device)
    state_out = torch.empty_like(state_cols)
    w = weights
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.fpyv_race_vision_rollout(
            kc.ctypes.data, kc.size, rcon.ctypes.data, rcon.size, rc.ctypes.data, rc.size,
            int(np.int64(seed).astype(np.int32)), K, state_cols.data_ptr(), wcol.data_ptr(),
            ocol.data_ptr(), hist.data_ptr(), dcam.data_ptr(), hw, w.we.data_ptr(),
            w.be.data_ptr(), w.wp.data_ptr(), w.bp.data_ptr(), w.wf.data_ptr(), w.bf.data_ptr(),
            hidden, w.wf_tc.data_ptr() if batch else None, batch, w.wm.data_ptr(),
            w.bm.data_ptr(), w.std.data_ptr(), patch_pool,
            int(dt == torch.bfloat16), frames.data_ptr(), extra.data_ptr(), aux.data_ptr(),
            state_out.data_ptr(), n, n_steps, timing, stream)
    _build.check(err, "race_vision_rollout")
    _build.launch_counts["race_vision_rollout"] += 1
    return frames, extra, aux, state_out


def fused_race_vision_rollout(venv, state_cols: torch.Tensor, hist: torch.Tensor, world: World,
                              weights: PolicyWeights, n_steps: int, seed: int,
                              patch_pool: int = 1):
    """T policy-driven race steps in one launch on CUDA tensors, the plain
    version on CPU tensors. ``venv`` is a single-agent ``VisionRaceEnv`` on
    its shared track ``world``; the compute type is the weights' (bf16 or
    float32). Returns (frames (T, N, NP*K*64) uint8, extra (T, N, 16), aux
    (T, N, 8), state (N, 22))."""
    _check_supported(venv)
    wcol = race_world_cols(world)
    ocol = obstacle_cols(world, venv.race.n_obstacles)
    if state_cols.device.type == "cpu":
        return race_vision_rollout_reference(venv, state_cols, hist, wcol, ocol, weights,
                                             n_steps, seed, patch_pool)
    return launch_race_vision_rollout(venv, state_cols, hist, wcol, ocol, weights, n_steps,
                                      seed, patch_pool)


# ---------------------------------------------------------------------------
# PPO integration: a rollout_fn for rl.ppo.make_ppo
# ---------------------------------------------------------------------------


def make_kernel_race_ppo_parts(venv, world: World, net, num_envs: int):
    """(apply_fn, make_rollout_fn, obs_from_carry, init_carry, race_metrics)
    of the kernel-rollout race trainer (``apps.train.train_vision_race``).

    The PPO ``env_state`` is the carry ``(cols (N, 22), hist (N,
    NP*(K-1)*64) uint8)``: the frame history survives rollout boundaries, so
    the stack runs on seamlessly across iterations.

    - ``apply_fn(net, obs)``: obs {pixels: (..., NP*K*64) uint8
      patch-stack-major, proprio: (..., 5 + G)} through ``net``, a
      ``prepatched`` ``PixelActorCritic`` with ``frame_stack = K``.
    - ``obs_from_carry(carry)``: the GAE bootstrap observation, K5's frame
      stacked under the carried history (flushed where the last step reset).
    - ``init_carry(generator)``: ``num_envs`` fresh races, their history the
      first frame repeated.
    - ``make_rollout_fn(num_steps, compute_dtype, exact_logprob)`` gives
      ``rollout_fn(state) -> (carry, last_obs, traj)``: T steps in one
      launch (:func:`fused_race_vision_rollout`), as
      :func:`~fpyv_tpu_torch.ops.policy_kernel._kernel_rollout_fn` sets out,
      spans included, ``rollout.boot`` being ``obs_from_carry``.
    - ``race_metrics(carry)``: mean gates passed and gates per 100 steps.

    ``rollout.launch`` holds the fused wrapper: its checks, constants, their
    copies and the launch. The ray grid, the camera mount, the fragment index
    and the proprio's divisors are made once per rig and device, so a
    steady-state call copies nothing to the card and reads nothing back.
    """
    _check_supported(venv)
    race, rig = venv.race, venv.rig
    W, H = rig.resolution
    NP, K, G = (W * H) // PP, venv.frame_stack, race.n_gates
    if net.torso != "patch" or not net.prepatched or net.embed != 128:
        raise ValueError("the kernel rollout pairs with PixelActorCritic(torso='patch', "
                         "prepatched=True, embed=128)")
    if net.frame_stack != K:
        raise ValueError(f"the net's frame_stack={net.frame_stack} must be the env's {K}")

    def apply_fn(params, obs):
        px = obs["pixels"]
        return params(px.reshape(px.shape[:-1] + (NP, K * PP)), obs["proprio"])

    def render_obs(cols):
        """K5's frame of the state matrix (obstacles at episode time t) as
        patch-major uint8 levels (N, NP, 1, 64), and the proprio."""
        rworld, include = world, ("gates", "ground")
        if race.n_obstacles:
            centers = race._obstacles_at(world, cols[:, 15].to(torch.int32))
            rworld = per_camera_world(world, centers, world.sphere_radius.to(torch.float32)
                                      .expand(centers.shape[:-1]))
            include = ("spheres", "gates", "ground")
        cur = _boot_levels(rig, cols, rworld, max_depth=venv.max_depth, include=include,
                           frame_width=venv.frame_width).reshape(-1, NP, 1, PP)
        onehot = torch.nn.functional.one_hot(cols[:, 16].long(), G).to(torch.float32)
        if not venv.gate_onehot:
            onehot = torch.zeros_like(onehot)
        d_rates, d_30, d_force = proprio_divisors(race.params, cols.device)
        proprio = torch.cat([cols[:, 10:13] / d_rates, cols[:, 18:19] / d_30,
                             cols[:, 13:14] / d_force, onehot], dim=1)
        return cur, proprio

    def obs_from_carry(carry):
        cols, hist = carry
        cur, proprio = render_obs(cols)
        older = hist.reshape(hist.shape[0], NP, K - 1, PP)
        older = torch.where((cols[:, 21] > 0.5)[:, None, None, None], cur.expand_as(older), older)
        return {"pixels": torch.cat([older, cur], dim=2).reshape(hist.shape[0], NP * K * PP),
                "proprio": proprio}

    def init_carry(generator: torch.Generator):
        state, _ = race.reset(generator, world, (num_envs,))
        cols = race_state_to_cols(state)
        cur, _ = render_obs(cols)
        hist = cur.expand(-1, NP, K - 1, PP).reshape(num_envs, NP * (K - 1) * PP).contiguous()
        cols[:, 21] = 0.0  # the history is the first frame already: no flush
        return cols, hist

    def launch(state, weights, num_steps, seed):
        cols, hist = state.env_state
        frames, extra, aux, cols_out = fused_race_vision_rollout(
            venv, cols, hist, world, weights, num_steps, seed, patch_pool=net.patch_pool)
        N = frames.shape[1]
        new_hist = frames[-1].reshape(N, NP, K, PP)[:, :, 1:].reshape(N, NP * (K - 1) * PP)
        return frames, extra, aux, (cols_out, new_hist)

    def race_metrics(carry):
        cols = carry[0]
        gates = cols[:, 19]
        t = torch.clamp_min(cols[:, 15], 1.0)
        return {"mean_gates_passed": gates.mean(),
                "gates_per_100_steps": (gates / t).mean() * 100.0}

    make_rollout_fn = functools.partial(_kernel_rollout_fn, launch, obs_from_carry, apply_fn,
                                        5 + G)
    return apply_fn, make_rollout_fn, obs_from_carry, init_carry, race_metrics
