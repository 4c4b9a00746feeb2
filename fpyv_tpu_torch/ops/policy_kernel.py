"""Policy-in-kernel vision rollout: CUDA kernel K7 with its plain PyTorch
version (mirrors ``fpyv_tpu.ops.pallas_policy``).

One launch runs K steps of the pixel PPO trainer's rollout over the whole
env bank: per step it renders the full-world depth view (K5's ray math) in
patch-major pixel order, runs the patch actor
(:class:`~fpyv_tpu_torch.models.policy.PixelActorCritic`, ``torso="patch"``)
in bf16 or float32, samples a Gaussian action with the counter RNG and its
log-prob, and steps the in-kernel ``AcroEnv`` (static targets, per-env
worlds, reward to sphere 0, truncation, auto-reset). It streams out what
PPO's learner needs.

- State: the (N, 18) env-major float32 matrix of :func:`acro_state_to_cols`
  (0:3 pos, 3:6 vel, 6:10 quat, 10:13 rates, 13 thrust, 14 done, 15 t,
  16 prev_dist, 17 accel_z).
- Outputs: frames (K, N, H*W) uint8 depth levels in patch-major order (the
  order :func:`prepatch_pixels` gives a row-major image), extra (K, N, 8)
  the normalised proprio [rates / max (3), accel_z / 30, thrust / max, 0,
  0, 0], aux (K, N, 8) [a0..a3, reward, crashed, value, log_prob], and the
  final state.
- RNG: K4's murmur3 stream, lane id ``fmix(env ^ fmix(seed))``; step k of a
  launch uses draws ``(k + 1) * 32 + d``: d = 0..9 for the reset pose,
  d = 20..23 for the action noise. The draws match the Pallas kernel's bit
  for bit, so the plain version matches it across resets.

The plain version (:func:`policy_vision_rollout_reference`) accumulates
every product in row order, as the float32 kernel does, so on the card the
two agree bit for bit in float32. The bf16 kernel sums its products on the
tensor cores in the hardware's order (``csrc/actor.cuh``), so in bf16 the
mean and value agree within :data:`TOL_BF16_HEADS`. A CPU tensor runs the
plain version; a CUDA tensor launches the kernel, and anything the kernel
does not take raises.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from fpyv_tpu_torch.device import divisor
from fpyv_tpu_torch.envs.acro import AcroEnv, AcroState
from fpyv_tpu_torch.ops import _build
from fpyv_tpu_torch.ops.env_kernel import (
    env_constants,
    env_constants_array,
    lane_ids,
    normal_pair,
    reset_pose,
)
from fpyv_tpu_torch.ops.rotations import quat_to_rotmat
from fpyv_tpu_torch.ops.step_kernel import (
    _f32,
    check_cuda_inputs,
    step_components,
    step_constants,
    step_constants_array,
)
from fpyv_tpu_torch.ops.vision_kernel import (
    RenderConfig,
    camera_rows,
    depth_levels,
    fused_render_depth,
    render_tiles,
    world_cols,
)
from fpyv_tpu_torch.physics.drone import DroneParams
from fpyv_tpu_torch.physics.world import World
from fpyv_tpu_torch.utils.profiling import span
from fpyv_tpu_torch.vision.camera import CameraRig, camera_pose, pixel_ray_grid

ROWS = 18
PATCH = 8
PP = PATCH * PATCH  # pixels per patch (the embed contraction)
N_OUT = 8  # extra / aux columns
INCLUDE = ("spheres", "cylinders", "ground", "gates")
ENVS_PER_BLOCK = 8  # kEnvs in csrc/policy_kernels.cu and csrc/race_kernels.cu
# kActorThreads in csrc/actor.cuh: the actor's threads, one hidden unit each (a
# block has 512, kRolloutThreads, 256 of which only render; 256 in all in the
# bf16 generic instantiation)
ACTOR_THREADS = 256
SHARED_LIMIT = 232448  # opt-in shared memory of one block on the H100
MAX_BATCH = 12  # patches a barrier pass of the tensor-core actor, at most
ROW_PAD = 8  # kRowPad in csrc/actor.cuh
# The bf16 kernels' mean and value against the plain version, teacher-forced.
# Both sum float32 products of the same bf16 factors, in other orders, and
# round to bf16 after the embed and the fc, so a sum an ulp across a bf16
# boundary moves a hidden unit by one bf16 step (up to 2^-6 for |h| < 4),
# the value by that times a value weight (|w| < 0.125, two lecun std). The
# order alone moved the value by up to 1.2e-3 over 1024 rows at K8's widths
# (tests/test_torch_actor_order.py, blocks of 16 against row order), above
# the 1e-3 that held while the bf16 kernel summed in the plain version's
# order; the card checks hold up to 32x more rows, so the tolerance is that
# maximum with a margin of about 3.
TOL_BF16_HEADS = 4e-3


def patch_major_ray_grid(rig: CameraRig) -> np.ndarray:
    """(3, H*W) camera-frame ray directions in patch-major pixel order:
    patches row-major over the (H/8, W/8) grid, pixels row-major within each
    patch (the net's own space-to-depth order)."""
    d = pixel_ray_grid(rig)  # (3, H, W)
    W, H = rig.resolution
    d = d.reshape(3, H // PATCH, PATCH, W // PATCH, PATCH)
    d = np.moveaxis(d, 2, 3)  # (3, H/8, W/8, 8, 8)
    return np.ascontiguousarray(d.reshape(3, -1))


@functools.lru_cache(maxsize=16)
def device_patch_dcam(rig: CameraRig, device: torch.device) -> torch.Tensor:
    """:func:`patch_major_ray_grid` on ``device``, made once per rig and
    device (as :func:`~fpyv_tpu_torch.ops.vision_kernel.device_dcam`): a K7
    or K8 launch then neither rebuilds the grid nor waits on a
    host-to-device copy (read only)."""
    return torch.from_numpy(patch_major_ray_grid(rig)).to(device)


def prepatch_pixels(img: torch.Tensor) -> torch.Tensor:
    """Row-major (..., H, W) image -> patch-major flat (..., NP*64), the
    kernel's frame order."""
    H, W = img.shape[-2], img.shape[-1]
    lead = tuple(img.shape[:-2])
    x = img.reshape(lead + (H // PATCH, PATCH, W // PATCH, PATCH)).movedim(-3, -2)
    return x.reshape(lead + ((H // PATCH) * (W // PATCH) * PP,))


# ---------------------------------------------------------------------------
# Weights and constants
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PolicyWeights:
    """The actor's weights laid out for the kernel (``pallas_policy``'s
    tuple), built per rollout from the live module."""

    we: torch.Tensor  # (K*64, embed): K stacked frames of a patch (K = 1 in K7)
    be: torch.Tensor  # (1, embed)
    wp: torch.Tensor  # (pool*embed, embed), or an (8, embed) zero dummy at pool 1
    bp: torch.Tensor  # (1, embed), zeros at pool 1
    # hidden: the net's fc width; in bf16 rounded up to a multiple of 16 with
    # zero units (build_policy_weights)
    wf: torch.Tensor  # (KF_pad, hidden): rows [patch-flat, proprio (5, or 5 + G in K8), zero pad]
    bf: torch.Tensor  # (1, hidden)
    wm: torch.Tensor  # (hidden, 8) float32: cols 0:4 pi_mean, col 4 v_out
    bm: torch.Tensor  # (1, 8) float32, same columns
    std: torch.Tensor  # (1, 8) float32: cols 0:4 exp(clipped log_std), 4:8 the clipped log_std
    # bf16 only: the fc's patch rows in the tensor cores' fragment order
    # (:func:`fragment_order_fc`), read by the bf16 kernels in place of wf's
    wf_tc: Optional[torch.Tensor] = None

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        return None if self.we.dtype == torch.float32 else self.we.dtype


def build_policy_weights(net, compute_dtype: Optional[torch.dtype] = torch.bfloat16
                         ) -> PolicyWeights:
    """:class:`PolicyWeights` from a ``PixelActorCritic`` (patch torso, one
    fc layer); ``compute_dtype`` None means float32."""
    if len(net.hidden) != 1:
        raise ValueError("the kernel rollout takes one fc hidden layer")
    dt = torch.float32 if compute_dtype is None else compute_dtype
    f = torch.float32

    def kernel(layer):  # Flax's (in, out) kernel and the bias, detached
        return layer.weight.detach().T.to(dt).contiguous(), layer.bias.detach().to(dt)[None, :]

    we, be = kernel(net.patch_embed)
    embed, dev = we.shape[1], we.device
    if net.patch_pool > 1:
        wp, bp = kernel(net.patch_pool_layer)
    else:
        wp = torch.zeros(8, embed, dtype=dt, device=dev)
        bp = torch.zeros(1, embed, dtype=dt, device=dev)
    wf_raw, bf_raw = kernel(net.fc0)  # (NP*embed + proprio, hidden)
    kf, hidden = wf_raw.shape
    # The bf16 kernels' fc takes 16-row hidden tiles: another width gets zero
    # units up to the next multiple of 16 (zero fc columns, bias and head
    # rows), each ReLU(0) = +0, adding an exact +0 to the heads.
    width = -(-hidden // 16) * 16 if dt == torch.bfloat16 else hidden
    wf = torch.zeros(-(-kf // 128) * 128, width, dtype=dt, device=dev)
    wf[:kf, :hidden] = wf_raw
    bf = torch.zeros(1, width, dtype=dt, device=dev)
    bf[:, :hidden] = bf_raw
    pi_w, pi_b = net.pi_mean.weight.detach().to(f), net.pi_mean.bias.detach().to(f)
    v_w, v_b = net.v_out.weight.detach().to(f), net.v_out.bias.detach().to(f)
    wm = torch.zeros(width, N_OUT, dtype=f, device=dev)
    wm[:hidden, :4] = pi_w.T
    wm[:hidden, 4] = v_w[0]
    bm = torch.zeros(1, N_OUT, dtype=f, device=dev)
    bm[0, :4] = pi_b
    bm[0, 4] = v_b[0]
    log_std = torch.clamp(net.log_std.detach().to(f), net.log_std_min, net.log_std_max)
    std = torch.zeros(1, N_OUT, dtype=f, device=dev)
    std[0, :4] = torch.exp(log_std)
    std[0, 4:8] = log_std
    wf_tc = None
    if dt == torch.bfloat16:
        wf_tc = fragment_order_fc(wf[:kf // 128 * 128])  # the patch rows (proprio < 128)
    return PolicyWeights(we=we, be=be, wp=wp, bp=bp, wf=wf, bf=bf, wm=wm, bm=bm, std=std,
                         wf_tc=wf_tc)


@functools.lru_cache(maxsize=8)
def _fragment_index(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row, col) of a 16x16 A tile held by lane l as its values j = 0..7
    in ``mma.sync.m16n8k16``: registers a0..a3 hold (g, 2t), (g + 8, 2t),
    (g, 2t + 8), (g + 8, 2t + 8) and the next column each, g = l // 4,
    t = l % 4. Made once per device, so building the weights waits on no
    host-to-device copy (read only)."""
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    rows = torch.stack([g, g, g + 8, g + 8, g, g, g + 8, g + 8], dim=1)
    cols = torch.stack([2 * t, 2 * t + 1, 2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9, 2 * t + 8,
                        2 * t + 9], dim=1)
    return rows.to(device), cols.to(device)


def fragment_order_fc(w: torch.Tensor) -> torch.Tensor:
    """(KI, H) fc rows -> (H/16, KI/16, 32, 8): for the tensor cores' A =
    wᵀ, the tile of hidden rows 16m.. and input rows 16k.. as each lane's
    A fragment, so a warp reads one tile as 512 contiguous bytes."""
    ki, h = w.shape
    if ki % 16 or h % 16:
        raise ValueError(f"fc rows ({ki}, {h}) must be multiples of 16")
    a = w.reshape(ki // 16, 16, h // 16, 16).permute(2, 0, 3, 1)  # (m, k, hidden, input)
    rows, cols = _fragment_index(w.device)
    return a[:, :, rows, cols].contiguous()


def fc_from_fragment_order(f: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`fragment_order_fc`."""
    mt, kt = f.shape[:2]
    rows, cols = _fragment_index(f.device)
    a = torch.zeros(mt, kt, 16, 16, dtype=f.dtype, device=f.device)
    a[:, :, rows, cols] = f
    return a.permute(1, 3, 0, 2).reshape(kt * 16, mt * 16)


def tc_tile_bytes(kp: int, batch: int, pool: int) -> int:
    """Shared bytes of the tensor-core actor's tiles (``tc_tile_elems`` in
    ``csrc/actor.cuh``): the transposed embed weights, a batch's levels, its
    fc input and, when pool > 1, its embeddings; rows padded by 8 bf16."""
    e, xs = ENVS_PER_BLOCK, kp + ROW_PAD
    elems = (128 * xs + batch * e * xs + e * (batch // pool * 128 + ROW_PAD)
             + (e * (batch * 128 + ROW_PAD) if pool > 1 else 0))
    return 2 * elems


def _aligned_floats(n: int) -> int:
    return -(-n // 4) * 4


def pre_cols(n_spheres: int, n_cylinders: int, n_gates: int) -> int:
    """Floats of one env's invariant table of the render
    (``csrc/render.cuh::pre_cols``): 5 a sphere, 6 a cylinder, 16 a gate and
    the ground flag."""
    return 5 * n_spheres + 6 * n_cylinders + 16 * n_gates + 1


def policy_shared_bytes(hw: int, wcols: int, n_phys: int, hidden: int, pool: int,
                        batch: int = 0, n_gates: int = 0) -> int:
    """Shared memory of one K7 block (``launch`` in
    ``csrc/policy_kernels.cu``): the level table, per-env camera, proprio,
    heads, world columns, physics rows (``n_phys`` = 5S + 6C) and the
    render's invariant table (:func:`pre_cols`: ``n_phys`` + 16 ``n_gates``
    + 1 floats), the hidden layer and the frames (one byte a pixel);
    ``batch`` 0 adds the float32 actor's group buffers, else the bf16 tiles
    for batches of ``batch`` patches."""
    e = ENVS_PER_BLOCK
    head = 16 + 2 * N_OUT + wcols + n_phys + (n_phys + 16 * n_gates + 1)
    if batch == 0:
        return 4 * (256 + e * (head + 128 + hidden + (pool * 128 if pool > 1 else 0))) + e * hw
    return 4 * _aligned_floats(256 + e * (head + hidden)) + tc_tile_bytes(PP, batch, pool) + e * hw


def actor_batch(n_patches: int, pool: int, shared_bytes) -> int:
    """Patches a barrier pass of the tensor-core actor: the largest multiple
    of ``pool`` up to :data:`MAX_BATCH` (``pool`` at least) that divides
    ``n_patches`` and whose ``shared_bytes(batch)`` fits a block; 0 if none
    fits."""
    for d in range(max(1, MAX_BATCH // pool), 0, -1):
        batch = d * pool
        if n_patches % batch == 0 and shared_bytes(batch) <= SHARED_LIMIT:
            return batch
    return 0


def check_tc_weights(w: PolicyWeights, n_rows: int) -> None:
    """The bf16 kernels' fc weights: hidden a multiple of 16 and the
    fragment-order copy of the ``n_rows`` patch rows."""
    hidden = w.wf.shape[1]
    if hidden % 16:
        raise ValueError(f"the bf16 kernels take hidden a multiple of 16, got {hidden}")
    want = (hidden // 16, n_rows // 16, 32, 8)
    if (w.wf_tc is None or tuple(w.wf_tc.shape) != want or w.wf_tc.dtype != torch.bfloat16
            or w.wf_tc.device != w.wf.device or not w.wf_tc.is_contiguous()):
        raise ValueError(f"bf16 weights need wf_tc, the fc's patch rows in fragment order "
                         f"{want} (build_policy_weights)")


@dataclass(frozen=True)
class PolicyConstants:
    """float32 launch constants in the order of ``PolicyConsts`` in
    ``csrc/policy_kernels.cu``: K4's env scalars, the proprio scales, the
    log-prob normaliser and the camera mount."""

    env: Tuple[float, ...]  # env_constants(env).as_array()
    inv_max_rates: float
    inv_30: float
    inv_max_force: float
    log_2pi2: float
    mount: Tuple[float, ...]  # 9, row major
    rel: Tuple[float, float, float]

    def as_array(self) -> np.ndarray:
        vals = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            vals.extend(v if isinstance(v, tuple) else [v])
        return np.asarray(vals, np.float32)


@functools.lru_cache(maxsize=32)
def policy_constants(env: AcroEnv, rig: CameraRig) -> PolicyConstants:
    """Each Python-float constant of the Pallas kernel rounded once to
    float32 (``pallas_policy._kernel``)."""
    return PolicyConstants(
        env=tuple(float(x) for x in env_constants_array(env)),
        inv_max_rates=_f32(1.0 / float(env.params.max_rates)), inv_30=_f32(1.0 / 30.0),
        inv_max_force=_f32(1.0 / float(env.params.thrust_curve.max_force)),
        log_2pi2=_f32(2.0 * math.log(2.0 * math.pi)),
        mount=tuple(_f32(x) for x in np.asarray(rig.mount_rotation).reshape(-1)),
        rel=tuple(_f32(x) for x in rig.rel_position))


@functools.lru_cache(maxsize=16)
def proprio_divisors(params: DroneParams, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The bootstrap proprio's divisors ``max_rates``, 30 and ``max_force``
    as float32 tensors on ``device`` (what
    :func:`~fpyv_tpu_torch.device.divisor` gives, so the division stays a
    true division), made once per drone and device: the K7/K8 bootstrap
    frame then waits on no host-to-device copy (read only)."""
    return tuple(torch.tensor(float(x), dtype=torch.float32, device=device)
                 for x in (params.max_rates, 30.0, params.thrust_curve.max_force))


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------


def acro_state_to_cols(state: AcroState) -> torch.Tensor:
    """AcroState (batched, quat mode) -> (N, 18) env-major float32 matrix."""
    d = state.drone
    f = torch.float32
    return torch.cat([d.pos.to(f), d.vel.to(f), d.att.to(f), d.rates.to(f),
                      d.thrust.to(f)[:, None], d.done.to(f)[:, None], state.t.to(f)[:, None],
                      state.prev_dist.to(f)[:, None], d.accel[:, 2:3].to(f)], dim=1).contiguous()


def cols_to_acro_state(mat: torch.Tensor, template: AcroState) -> AcroState:
    """(N, 18) -> AcroState (accel carries only its z; x and y are zero)."""
    d = template.drone
    accel = torch.zeros_like(d.accel)
    accel[:, 2] = mat[:, 17]
    return template.replace(
        drone=d.__class__(pos=mat[:, 0:3].clone(), vel=mat[:, 3:6].clone(),
                          att=mat[:, 6:10].clone(), rates=mat[:, 10:13].clone(),
                          thrust=mat[:, 13].clone(), accel=accel, done=mat[:, 14] > 0.5),
        t=mat[:, 15].to(torch.int32), prev_dist=mat[:, 16].clone())


def _env_supported(env: AcroEnv) -> bool:
    return (env.params.att_mode == "quat" and env.dtype == torch.float32 and not env.randomize
            and float(env.wind_scale) == 0.0 and all(w == 0.0 for w in env.wind))


def policy_rollout_supported(env: AcroEnv, world: World) -> bool:
    return _env_supported(env) and bool(world.has_ground.all())


def policy_world_cols(world: World, n: int) -> torch.Tensor:
    """(N, n_cols) per-env world columns (a shared world repeated)."""
    return world_cols(world).expand(n, -1).contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch version of K7
# ---------------------------------------------------------------------------


def _rounder(dtype: Optional[torch.dtype]):
    if dtype is None:
        return lambda x: x
    return lambda x: x.to(dtype).to(torch.float32)


def policy_forward_reference(w: PolicyWeights, levels: torch.Tensor, proprio, pool: int):
    """The kernels' actor (K7, K8) on depth levels (N, NP*K*64) (float,
    patch-stack-major; K = 1 in K7) and the proprio rows (N,) (5 in K7,
    5 + G in K8): float32 products accumulated in row order, rounded to the
    compute type where the kernels round. Returns the heads (N, 5): mean
    (4), value."""
    rnd = _rounder(w.compute_dtype)
    f = torch.float32
    n = levels.shape[0]
    x = rnd(levels / divisor(255.0, levels)).reshape(n, -1, w.we.shape[0])  # (N, NP, K*64)
    we, wp, wf = w.we.to(f), w.wp.to(f), w.wf.to(f)
    emb = torch.zeros(n, x.shape[1], we.shape[1], dtype=f, device=levels.device)
    for k in range(we.shape[0]):
        emb = emb + x[:, :, k:k + 1] * we[k]
    emb = torch.clamp_min(rnd(rnd(emb) + w.be.to(f)[0]), 0.0)
    if pool > 1:
        grouped = emb.reshape(n, -1, pool * we.shape[1])
        acc = torch.zeros(n, grouped.shape[1], we.shape[1], dtype=f, device=levels.device)
        for i in range(grouped.shape[2]):
            acc = acc + grouped[:, :, i:i + 1] * wp[i]
        emb = torch.clamp_min(rnd(rnd(acc) + w.bp.to(f)[0]), 0.0)
    fc_in = emb.reshape(n, -1)
    acc = torch.zeros(n, wf.shape[1], dtype=f, device=levels.device)
    for i in range(fc_in.shape[1]):
        acc = acc + fc_in[:, i:i + 1] * wf[i]
    for i in range(len(proprio)):
        acc = acc + rnd(proprio[i])[:, None] * wf[fc_in.shape[1] + i]
    h = torch.clamp_min(rnd(rnd(acc) + w.bf.to(f)[0]), 0.0)
    mm = torch.zeros(n, 5, dtype=f, device=levels.device)
    for j in range(h.shape[1]):
        mm = mm + h[:, j:j + 1] * w.wm[j, :5]
    return mm + w.bm[0, :5]


def policy_vision_rollout_reference(env: AcroEnv, rig: CameraRig, state_cols: torch.Tensor,
                                    wcol: torch.Tensor, cfg: RenderConfig, weights: PolicyWeights,
                                    n_steps: int, seed: int, patch_pool: int = 1,
                                    forced_actions: Optional[torch.Tensor] = None):
    """Plain version of K7, line by line as ``pallas_policy._kernel``.
    Returns (frames (K, N, H*W) uint8, extra (K, N, 8), aux (K, N, 8),
    state (N, 18)).

    ``forced_actions`` (K, N, 4) teacher-forces the env: each step still
    renders, runs the actor and samples (the aux row holds that sample,
    value and log-prob), but the env advances with the given action, the
    reward's rates penalty included."""
    k = step_constants(env.params)
    pc = policy_constants(env, rig)
    c = env_constants(env)
    dev = state_cols.device
    n = state_cols.shape[0]
    lane = lane_ids(n, seed, dev)
    dcam = device_patch_dcam(rig, dev)
    S, C = cfg.n_spheres, cfg.n_cylinders
    wc = list(wcol.unbind(1))
    spheres = [tuple(wc[s * 5 + j] for j in range(5)) for s in range(S)]
    cyls = [tuple(wc[S * 5 + i * 6 + j] for j in range(6)) for i in range(C)]
    tx, ty, tz = spheres[0][:3]
    std = [float(v) for v in weights.std[0].tolist()]
    st = list(state_cols.unbind(1))
    frames, extras, auxs = [], [], []
    for i in range(n_steps):
        cR, (cx, cy, cz) = camera_rows(pc.mount, pc.rel, st)
        zero = torch.zeros_like(cx)
        cam = torch.stack([cx, cy, cz] + cR + [zero] * 4, dim=1)
        levels = depth_levels(render_tiles(cfg, dcam, cam, wcol), cfg.max_depth)
        frames.append(levels.to(torch.uint8))
        prop = [st[10] * pc.inv_max_rates, st[11] * pc.inv_max_rates, st[12] * pc.inv_max_rates,
                st[17] * pc.inv_30, st[13] * pc.inv_max_force]
        extras.append(torch.stack(prop + [zero] * 3, dim=1))
        mm = policy_forward_reference(weights, levels, prop, patch_pool)

        base = (i + 1) * 32
        z0, z1 = normal_pair(lane, base + 20, base + 21)
        z2, z3 = normal_pair(lane, base + 22, base + 23)
        z = (z0, z1, z2, z3)
        a = [mm[:, j] + std[j] * z[j] for j in range(4)]
        log_prob = (-0.5 * (z0 * z0 + z1 * z1 + z2 * z2 + z3 * z3)
                    - _f32(_f32(_f32(std[4] + std[5]) + std[6]) + std[7]) - pc.log_2pi2)
        act = a if forced_actions is None else list(forced_actions[i].unbind(1))
        phys = step_components(k, spheres, st[:15], act, cyls=cyls, with_accel_z=True)
        crashed = phys[14]
        ddx, ddy, ddz = phys[0] - tx, phys[1] - ty, phys[2] - tz
        dist = torch.sqrt(ddx * ddx + ddy * ddy + ddz * ddz)
        rates_pen = act[0] * act[0] + act[1] * act[1] + act[2] * act[2]
        reward = (c.w_progress * (st[16] - dist) + c.w_alive - c.w_crash * crashed
                  - c.w_rates * rates_pen)
        t_next = st[15] + 1.0
        done = torch.maximum(crashed, (t_next >= c.max_steps).to(torch.float32))
        auxs.append(torch.stack(a + [reward, crashed, mm[:, 4], log_prob], dim=1))

        pose, dist_r = reset_pose(c, lane, i, tx, ty, tz)
        live = phys[:14] + [zero, t_next, dist, phys[15]]
        reset = pose + [zero] * 6 + [dist_r, zero]
        sel = done > 0.5
        st = [torch.where(sel, r, l) for r, l in zip(reset, live)]
    return (torch.stack(frames), torch.stack(extras), torch.stack(auxs),
            torch.stack(st, dim=1).contiguous())


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------


def _check_actor_launch(name: str, state_cols: torch.Tensor, weights: PolicyWeights,
                        rig: CameraRig, frame_stack: int, n_proprio: int, patch_pool: int,
                        n_steps: int, n_motors: int, phase_ns: Optional[torch.Tensor],
                        shared_bytes, **inputs) -> Tuple[int, Optional[int]]:
    """The checks K7 and K8 share before a launch (``name``: the kernel's
    launch counter): a CUDA device, the weights' dtype, device and layout,
    the kernel's other float32 ``inputs``, the rig's 8x8 patches,
    ``patch_pool``, an embed of ``frame_stack`` * 64 levels to 128, the fc's
    rows (the pooled patches' and ``n_proprio``), ``n_steps``, the
    instrumented launch, and the block's shared memory, ``shared_bytes(batch)``
    being the kernel's own sizing. Returns the bf16 actor's batch (0 in
    float32) and the phase array's pointer (None: a plain launch)."""
    device = state_cols.device
    if device.type != "cuda":
        raise ValueError(f"{name} launches on a CUDA device, got {device}")
    dt = weights.we.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"policy weights must be float32 or bfloat16, got {dt}")
    check_cuda_inputs(device, state=state_cols, **inputs, wm=weights.wm, bm=weights.bm,
                      std=weights.std)
    for wname in ("we", "be", "wp", "bp", "wf", "bf"):
        t = getattr(weights, wname)
        if t.device != device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"weight {wname} must be a contiguous {dt} tensor on {device}")
    W, H = rig.resolution
    n_patches = W * H // PP
    if W % PATCH or H % PATCH:
        raise ValueError(f"the rig's {W}x{H} must split into 8x8 patches")
    if patch_pool < 1 or n_patches % patch_pool:
        raise ValueError(f"patch_pool={patch_pool} must divide {n_patches} patches")
    embed, hidden = weights.we.shape[1], weights.wf.shape[1]
    fc_rows = n_patches // patch_pool * embed
    if (weights.we.shape[0] != frame_stack * PP or embed != 128
            or weights.wf.shape[0] < fc_rows + n_proprio):
        raise ValueError(f"the kernel takes a {frame_stack}*64-wide embed of 128")
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    timing = check_phase_ns(phase_ns, device, dt, n_motors, hidden)
    batch = 0
    if dt == torch.bfloat16:
        check_tc_weights(weights, fc_rows)
        batch = actor_batch(n_patches, patch_pool, shared_bytes)
    shared = shared_bytes(batch)
    if (dt == torch.bfloat16 and not batch) or shared > SHARED_LIMIT:
        raise ValueError(f"{name} needs {shared} B of shared memory a block, above the "
                         f"{SHARED_LIMIT} B a block may use")
    return batch, timing


def launch_policy_vision_rollout(env: AcroEnv, rig: CameraRig, state_cols: torch.Tensor,
                                 wcol: torch.Tensor, cfg: RenderConfig, weights: PolicyWeights,
                                 n_steps: int, seed: int, patch_pool: int = 1,
                                 phase_ns: Optional[torch.Tensor] = None):
    """K7 on the card; returns what :func:`policy_vision_rollout_reference`
    returns. ``phase_ns`` (a zeroed int64 tensor of :data:`N_PHASES` on the
    device, bf16 weights only) launches the instrumented instantiation, which
    adds each block's nanoseconds per step phase into it
    (:func:`phase_split_ms`)."""
    W, H = rig.resolution
    n, hw, hidden = state_cols.shape[0], W * H, weights.wf.shape[1]
    n_phys = 5 * cfg.n_spheres + 6 * cfg.n_cylinders
    batch, timing = _check_actor_launch(
        "policy_vision_rollout", state_cols, weights, rig, 1, 5, patch_pool, n_steps,
        env.params.n_motors, phase_ns, lambda b: policy_shared_bytes(
            hw, cfg.n_cols, n_phys, hidden, patch_pool, b, cfg.n_gates), world_cols=wcol)
    if not _env_supported(env):
        raise ValueError("the kernel rollout needs a quat, float32 env without DR or wind")
    if state_cols.shape != (n, ROWS) or wcol.shape != (n, cfg.n_cols):
        raise ValueError(f"state / world columns must be (N, {ROWS}) / (N, {cfg.n_cols})")
    if cfg.n_spheres < 1:
        raise ValueError("the reward needs sphere 0")
    device, dt = state_cols.device, weights.we.dtype
    lib = _build.library()
    kc = step_constants_array(env.params)
    pc = policy_constants(env, rig).as_array()
    rc = cfg.as_array()
    dcam = device_patch_dcam(rig, device)
    frames = torch.empty(n_steps, n, hw, dtype=torch.uint8, device=device)
    extra = torch.empty(n_steps, n, N_OUT, dtype=torch.float32, device=device)
    aux = torch.empty_like(extra)
    state_out = torch.empty_like(state_cols)
    w = weights
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.fpyv_policy_vision_rollout(
            kc.ctypes.data, kc.size, pc.ctypes.data, pc.size, rc.ctypes.data, rc.size,
            int(np.int64(seed).astype(np.int32)), state_cols.data_ptr(), wcol.data_ptr(),
            cfg.n_cols, dcam.data_ptr(), hw, w.we.data_ptr(), w.be.data_ptr(), w.wp.data_ptr(),
            w.bp.data_ptr(), w.wf.data_ptr(), w.bf.data_ptr(), hidden,
            w.wf_tc.data_ptr() if batch else None, batch, w.wm.data_ptr(),
            w.bm.data_ptr(), w.std.data_ptr(), patch_pool, int(dt == torch.bfloat16),
            frames.data_ptr(), extra.data_ptr(), aux.data_ptr(), state_out.data_ptr(), n,
            n_steps, timing, stream)
    _build.check(err, "policy_vision_rollout")
    _build.launch_counts["policy_vision_rollout"] += 1
    return frames, extra, aux, state_out


PHASES = ("render", "stack", "embed", "fc", "heads", "step")  # the Phase enum of csrc/actor.cuh
N_PHASES = len(PHASES)


def check_phase_ns(phase_ns: Optional[torch.Tensor], device, dt, n_motors: int,
                   hidden: int) -> Optional[int]:
    """The pointer of an instrumented launch's phase array (None: a plain
    launch)."""
    if phase_ns is None:
        return None
    if dt != torch.bfloat16:
        raise ValueError("the instrumented instantiation takes bf16 weights")
    if n_motors != 4 or hidden > ACTOR_THREADS:
        raise ValueError(f"the instrumented instantiation is the quad's (n_motors=4) with at "
                         f"most {ACTOR_THREADS} hidden units")
    if (phase_ns.device != device or phase_ns.dtype != torch.int64
            or phase_ns.shape != (N_PHASES,)):
        raise ValueError(f"phase_ns must be an int64 ({N_PHASES},) tensor on {device}")
    return phase_ns.data_ptr()


def phase_split_ms(phase_ns: torch.Tensor, n_envs: int) -> dict:
    """An instrumented launch's per-phase time, ms a launch: each block's
    nanoseconds averaged over the blocks (at 1024 envs the 128 blocks are one
    wave, one block an SM)."""
    blocks = -(-n_envs // ENVS_PER_BLOCK)
    return {name: float(v) / blocks * 1e-6 for name, v in zip(PHASES, phase_ns.tolist())}


def fused_policy_vision_rollout(
    env: AcroEnv,
    rig: CameraRig,
    state_cols: torch.Tensor,  # (N, 18) from acro_state_to_cols
    worlds: World,  # per-env batched (or shared) world
    weights: PolicyWeights,
    n_steps: int,
    seed: int,
    max_depth: float,
    include: Tuple[str, ...] = INCLUDE,
    ground_extent: Optional[float] = None,
    frame_width: float = 0.08,
    patch_pool: int = 1,
    prepared: Optional[Tuple[RenderConfig, torch.Tensor]] = None,
):
    """K policy-driven env steps in one launch on CUDA tensors, the plain
    version on CPU tensors. The compute type is the weights' (bf16 or
    float32). Returns (frames (K, N, H*W) uint8, extra (K, N, 8), aux
    (K, N, 8), state (N, 18)).

    ``prepared`` is the render configuration and (N, n_cols) world columns
    of ``worlds`` made by a caller that has checked them already
    (:func:`make_kernel_vision_ppo_parts`, whose worlds are fixed); without
    it the worlds are checked here, which reads ``has_ground`` back from the
    device, and both are made."""
    if prepared is None:
        if not policy_rollout_supported(env, worlds):
            raise ValueError("the kernel rollout needs a quat, float32 env without DR or "
                             "wind, over ground")
        prepared = (RenderConfig.for_world(worlds, max_depth, include, ground_extent,
                                           frame_width),
                    policy_world_cols(worlds, state_cols.shape[0]))
    cfg, wcol = prepared
    if state_cols.device.type == "cpu":
        return policy_vision_rollout_reference(env, rig, state_cols, wcol, cfg, weights, n_steps,
                                               seed, patch_pool)
    return launch_policy_vision_rollout(env, rig, state_cols, wcol, cfg, weights, n_steps, seed,
                                        patch_pool)


# ---------------------------------------------------------------------------
# PPO integration: a rollout_fn for rl.ppo.make_ppo
# ---------------------------------------------------------------------------


def _boot_levels(rig: CameraRig, cols: torch.Tensor, world: World, **render) -> torch.Tensor:
    """K5's frame of the state matrix ``cols`` (position 0:3, quaternion
    6:10) as patch-major uint8 levels (N, NP*64), the order of the frames
    K7 and K8 emit; ``render`` goes to
    :func:`~fpyv_tpu_torch.ops.vision_kernel.fused_render_depth`."""
    cam_pos, cam_R = camera_pose(rig, cols[:, 0:3], quat_to_rotmat(cols[:, 6:10]))
    img = fused_render_depth(rig, cam_pos, cam_R, world, **render)
    return prepatch_pixels(torch.round(img * 255.0).to(torch.uint8))


def _kernel_rollout_fn(launch, boot, apply_fn, n_proprio: int, num_steps: int,
                       compute_dtype=torch.bfloat16, exact_logprob: bool = True):
    """``rollout_fn(state) -> (carry, last_obs, traj)`` of a kernel-rollout
    PPO trainer (K7, K8): the kernel's seed drawn from ``state.generator``,
    the weights built from ``state.params`` in ``compute_dtype``, then
    ``launch(state, weights, num_steps, seed) -> (frames, extra, aux,
    carry)``, one kernel launch. The trajectory is the frames, the first
    ``n_proprio`` extra columns and the aux columns [action (4), reward,
    done, value, log_prob]; ``exact_logprob`` recomputes log_prob and value
    with one batched (T*N) forward of ``apply_fn`` (the epoch-0 ratio is
    then exactly 1). ``boot(carry)`` is the GAE bootstrap observation.

    Under ``torch.profiler`` a call is a ``rollout`` span holding
    ``rollout.weights``, ``rollout.launch``, ``rollout.logprob`` (with
    ``exact_logprob``) and ``rollout.boot``."""
    from fpyv_tpu_torch.rl.ppo import Transition, gaussian_log_prob

    def rollout(state):
        seed = int(torch.randint(0, 2**31 - 1, (), generator=state.generator,
                                 device=state.generator.device))
        with span("rollout.weights"):
            weights = build_policy_weights(state.params, compute_dtype)
        with span("rollout.launch"):
            frames, extra, aux, carry = launch(state, weights, num_steps, seed)
        obs = {"pixels": frames, "proprio": extra[..., :n_proprio]}
        action = aux[..., 0:4]
        T, N = frames.shape[0], frames.shape[1]
        if exact_logprob:
            with span("rollout.logprob"):
                flat = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in obs.items()}
                mean, log_std, value = apply_fn(state.params, flat)
                log_prob = gaussian_log_prob(mean, log_std, action.reshape(-1, 4)).reshape(T, N)
                value = value.reshape(T, N)
        else:
            value, log_prob = aux[..., 6], aux[..., 7]
        # aux column 5 is the end GAE does not bootstrap across: K7's crash
        # (it bootstraps across time-limit truncations), K8's crash or time
        # limit (the agent's end: bootstrapping across a respawn would
        # corrupt GAE)
        traj = Transition(obs=obs, action=action, log_prob=log_prob, value=value,
                          reward=aux[..., 4], done=aux[..., 5] > 0.5)
        with span("rollout.boot"):
            return carry, boot(carry), traj

    def rollout_fn(state):
        with span("rollout"):
            return rollout(state)

    return rollout_fn


def make_kernel_vision_ppo_parts(venv, worlds: World, net, num_envs: int):
    """(apply_fn, make_rollout_fn, obs_from_cols) of the kernel-rollout
    vision PPO trainer (``apps.train.train_vision``, rollout "kernel").

    - ``apply_fn(net, obs)`` runs the obs dict {pixels: (..., NP*64) uint8
      patch-major, proprio: (..., 5)} through ``net``, a ``prepatched``
      ``PixelActorCritic``.
    - ``make_rollout_fn(num_steps, compute_dtype, exact_logprob)`` gives
      ``rollout_fn(state) -> (env_state, last_obs, traj)``: K steps in one
      launch (:func:`fused_policy_vision_rollout`), as
      :func:`_kernel_rollout_fn` sets out, spans included, ``rollout.boot``
      being ``obs_from_cols``.
    - the PPO ``env_state`` is the raw (N, 18) state matrix.

    The worlds are fixed, so they are checked, and their render
    configuration and world columns made, once here and handed to each
    launch; with the cached ray grid, mount and divisors a steady-state
    call copies nothing to the card and reads nothing back.
    """
    env, rig = venv.acro, venv.rig
    if not policy_rollout_supported(env, worlds):
        raise ValueError("the kernel rollout needs a quat, float32 env without DR or wind, "
                         "over ground")
    if net.torso != "patch" or not net.prepatched:
        raise ValueError("the kernel rollout pairs with PixelActorCritic(torso='patch', "
                         "prepatched=True)")
    prepared = (RenderConfig.for_world(worlds, venv.max_depth, INCLUDE, venv.ground_extent,
                                       venv.frame_width),
                policy_world_cols(worlds, num_envs))

    def apply_fn(params, obs):
        px = obs["pixels"]
        px = px.reshape(px.shape[:-1] + (px.shape[-1] // PP, PP))
        return params(px, obs["proprio"])

    def obs_from_cols(cols):
        """The observation of a state matrix (the GAE bootstrap obs, the one
        frame an iteration the kernel does not emit): K5's frame as uint8
        levels, the proprio by true division."""
        levels = _boot_levels(rig, cols, worlds, max_depth=venv.max_depth, include=INCLUDE,
                              ground_extent=venv.ground_extent, frame_width=venv.frame_width)
        d_rates, d_30, d_force = proprio_divisors(env.params, cols.device)
        proprio = torch.cat([cols[:, 10:13] / d_rates, cols[:, 17:18] / d_30,
                             cols[:, 13:14] / d_force], dim=1)
        return {"pixels": levels, "proprio": proprio}

    def launch(state, weights, num_steps, seed):
        return fused_policy_vision_rollout(
            env, rig, state.env_state, worlds, weights, num_steps, seed, venv.max_depth,
            ground_extent=venv.ground_extent, frame_width=venv.frame_width,
            patch_pool=net.patch_pool, prepared=prepared)

    make_rollout_fn = functools.partial(_kernel_rollout_fn, launch, obs_from_cols, apply_fn, 5)
    return apply_fn, make_rollout_fn, obs_from_cols
