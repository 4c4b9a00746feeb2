"""K6's target pixel box: ``ops/vision_kernel.py::target_pixel_box``, the
plain version of ``csrc/render.cuh::target_pixel_box`` that the chase kernel
uses to test only the pixels its target can light.

Every pixel that the target-only render marks lit (the plain ``_sphere_t``
of the chase, and JAX's ``_render_tiles(chase_only=True)``) lies inside the
box, over seeded poses: targets in front of the camera across and beyond the
120° FOV and at its corners, behind it, across its plane, around the camera,
beside it, at both thresholds, radii from 0.05 to 20 m, on the 96x72, 640x480 and
33x17 rigs with the 35° pitch mount. So the mask count and the pixel sums over
the box equal the full frame's bit for bit (half-integers, exact in float32
below 2^22 at 96x72 and 33x17; in float64 at 640x480); the full frame is
rendered exactly where the sphere reaches within ``BOX_Z_EPS`` of the camera
plane (c.z − r ≤ eps and c.z + r ≥ −eps) and into the cone of the frame's
rays, and a sphere wholly behind the camera, or across its plane outside
that cone, gets an empty box.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpyv_tpu.ops import pallas_vision as jpv
from fpyv_tpu_torch.ops import vision_kernel as tvk
from fpyv_tpu_torch.physics.drone import DroneParams
from fpyv_tpu_torch.vision.camera import CameraRig, default_vision_rig

RIGS = {"96x72": default_vision_rig(), "640x480": CameraRig(resolution=(640, 480)),
        "33x17": CameraRig(resolution=(33, 17))}
KINDS = ("front", "corners", "behind", "straddle", "beside", "inside", "threshold", "rear",
         "keep")


def _consts(rig):
    return tvk.chase_constants(rig, tvk.ChasePilot(), DroneParams(att_mode="quat"))


def _poses(rig, kind, n, seed):
    """Camera rows from seeded drone poses through the rig's mount, and a
    target (centre (3, N), radius (N,)) placed in the camera frame by kind."""
    rng = np.random.default_rng(seed)
    W, H = rig.resolution
    p = _consts(rig)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    pos = rng.normal(size=(n, 3)) * 20.0
    st = [torch.tensor(x, dtype=torch.float32) for x in
          (*pos.T, *np.zeros((3, n)), *q.T)]
    cR, cpos = tvk.camera_rows(p.mount, p.rel, st)
    r = np.exp(rng.uniform(np.log(0.05), np.log(20.0), n))
    if kind in ("front", "corners", "keep"):
        if kind == "front":  # pixels across and beyond the frame
            u = rng.uniform(-0.3 * W, 1.3 * W, n)
            v = rng.uniform(-0.3 * H, 1.3 * H, n)
            z = r + np.exp(rng.uniform(np.log(0.06), np.log(100.0), n))
        elif kind == "corners":  # the corners of the FOV, a few pixels either side
            u = rng.choice([0.0, W], n) + rng.uniform(-3.0, 3.0, n)
            v = rng.choice([0.0, H], n) + rng.uniform(-3.0, 3.0, n)
            z = r + np.exp(rng.uniform(np.log(0.06), np.log(60.0), n))
        else:  # the chase's station: a 1 m target 6-7 m away, in view
            r = np.ones(n)
            u, v = rng.uniform(0.2 * W, 0.8 * W, n), rng.uniform(0.2 * H, 0.8 * H, n)
            z = rng.uniform(6.0, 7.0, n)
        Ki = rig.K_inv
        c = np.stack([Ki[0, 0] * u + Ki[0, 1] * v + Ki[0, 2], Ki[1, 1] * v + Ki[1, 2],
                      np.ones(n)]) * z
    else:
        d = rng.normal(size=(3, n))
        d /= np.linalg.norm(d, axis=0)
        if kind == "behind":
            c = d * rng.uniform(0.5, 50.0, n)
            c[2] = -np.abs(c[2]) - r
        elif kind == "straddle":  # centre within r of the camera plane, beside the camera
            c = d * (r * rng.uniform(1.05, 4.0, n))
            c[2] = r * rng.uniform(-0.95, 0.95, n)
        elif kind == "beside":  # across the camera plane, 0.5-30 m off the optical axis
            phi = rng.uniform(0.0, 2 * np.pi, n)
            c = np.stack([np.cos(phi), np.sin(phi), np.zeros(n)]) * (r + rng.uniform(0.5, 30.0, n))
            c[2] = r * rng.uniform(-0.95, 0.95, n)
        elif kind == "inside":
            c = d * r * rng.uniform(0.0, 0.95, n)
        elif kind == "threshold":  # c.z - r a millimetre either side of BOX_Z_EPS
            c = d * rng.uniform(0.0, 30.0, n)
            c[2] = r + tvk.BOX_Z_EPS + rng.choice([-1e-3, 1e-3], n)
        else:  # rear: c.z + r a millimetre either side of -BOX_Z_EPS
            c = d * rng.uniform(0.0, 30.0, n)
            c[2] = -r - tvk.BOX_Z_EPS + rng.choice([-1e-3, 1e-3], n)
    R = torch.stack(cR).double().numpy().reshape(3, 3, n)
    world = np.stack(cpos).astype(np.float64) + np.einsum("ijn,jn->in", R, c)
    tgt = torch.tensor(world, dtype=torch.float32)
    return cR, cpos, tgt, torch.tensor(r, dtype=torch.float32)


def _mask(rig, cR, cpos, tgt, r):
    """The plain K6's target-only mask (N, H*W), as ``chase_action_fn``."""
    dcam = torch.from_numpy(tvk.flat_dcam(rig))
    col = [x[:, None] for x in cR]
    dxr, dyr, dzr = dcam[0:1], dcam[1:2], dcam[2:3]
    dwx = col[0] * dxr + col[1] * dyr + col[2] * dzr
    dwy = col[3] * dxr + col[4] * dyr + col[5] * dzr
    dwz = col[6] * dxr + col[7] * dyr + col[8] * dzr
    a = dwx * dwx + dwy * dwy + dwz * dwz
    big = torch.tensor(tvk._BIG, dtype=torch.float32)
    t = tvk._sphere_t(a, cpos[0][:, None] - tgt[0][:, None], cpos[1][:, None] - tgt[1][:, None],
                      cpos[2][:, None] - tgt[2][:, None], r[:, None], True, dwx, dwy, dwz, big)
    return t < 1e30


def _inside(rig, box):
    W, H = rig.resolution
    u0, u1, v0, v1, _ = box
    u = torch.arange(W)[None, None, :]
    v = torch.arange(H)[None, :, None]
    ins = ((u >= u0[:, None, None]) & (u <= u1[:, None, None]) & (v >= v0[:, None, None])
           & (v <= v1[:, None, None]))
    return ins.reshape(len(u0), -1)


def _sums(rig, mask, dtype):
    W, H = rig.resolution
    idx = torch.arange(W * H)
    m = mask.to(dtype)
    return (m.sum(1), (m * ((idx % W).to(dtype) + 0.5)).sum(1),
            (m * ((idx // W).to(dtype) + 0.5)).sum(1))


def _camera_centre(cR, cpos, tgt):
    """The target centre in the camera frame (3, N), in float64 from the
    float32 inputs."""
    R = torch.stack(cR).double().reshape(3, 3, -1)
    e = tgt.double() - torch.stack(cpos).double()
    return torch.stack([(R[:, k] * e).sum(0) for k in range(3)])


def _expected_regions(rig, cR, cpos, tgt, r):
    """(full frame, empty box) by the geometry in float64: empty wholly
    behind the camera, or across its plane and outside the frame's cone."""
    W, H = rig.resolution
    K = rig.K
    ym = max(K[1, 2], H - K[1, 2]) / K[1, 1]
    cone = np.hypot((max(K[0, 2], W - K[0, 2]) + abs(K[0, 1]) * ym) / K[0, 0], ym)
    c = _camera_centre(cR, cpos, tgt)
    r = r.double()
    rear = c[2] + r < -tvk.BOX_Z_EPS
    across = (c[2] - r <= tvk.BOX_Z_EPS) & ~rear
    aside = torch.hypot(c[0], c[1]) > r + tvk.CONE_MARGIN * cone * (c[2] + r + tvk.BOX_Z_EPS)
    return across & ~aside, rear | (across & aside)


@pytest.mark.parametrize("rig_name", list(RIGS))
@pytest.mark.parametrize("kind", KINDS)
def test_box_holds_every_lit_pixel(rig_name, kind):
    rig = RIGS[rig_name]
    W, H = rig.resolution
    n = 16 if rig_name == "640x480" else 96
    seed = 100 * list(RIGS).index(rig_name) + KINDS.index(kind)
    cR, cpos, tgt, r = _poses(rig, kind, n, seed)
    box = tvk.target_pixel_box(_consts(rig), cR, cpos, tgt, r, W, H)
    mask = _mask(rig, cR, cpos, tgt, r)
    inside = _inside(rig, box)
    assert not (mask & ~inside).any(), "a lit pixel lies outside the box"
    # the kernel's count and sums over the box equal the full frame's
    for dtype in (torch.float64,) + ((torch.float32,) if W * H < 2 ** 13 else ()):
        for full, boxed in zip(_sums(rig, mask, dtype), _sums(rig, mask & inside, dtype)):
            assert torch.equal(full, boxed)
    if kind == "inside":
        assert box[4].all()  # premise: the camera inside the sphere takes the full frame
    if kind == "straddle":  # premise: most take the full frame, some the cone's cull
        assert box[4].float().mean() > 0.5
    if kind in ("behind", "beside"):  # premise: most lit nothing, with empty boxes
        _, empty = _expected_regions(rig, cR, cpos, tgt, r)
        assert empty.float().mean() > 0.5 and not mask[empty].any()
        assert not box[4][empty].any() and (box[1][empty] < box[0][empty]).all()
    if kind == "keep":
        area = (box[1] - box[0] + 1).clamp_min(0) * (box[3] - box[2] + 1).clamp_min(0)
        assert mask.any(1).all() and (area < W * H // 4).all()  # in view, and a small box
    if kind in ("front", "corners", "keep"):
        assert mask.any() and (~box[4]).any()  # premise: lit pixels and culled boxes


@pytest.mark.parametrize("rig_name", list(RIGS))
def test_box_fallback_exactly_at_the_threshold(rig_name):
    """The full frame is rendered exactly where the sphere reaches within
    BOX_Z_EPS of the camera plane (c.z − r ≤ eps, c.z + r ≥ −eps) and into
    the frame's cone, and the box is empty where it lies wholly behind the
    camera or across its plane outside the cone (float64 geometry on the
    same float32 inputs; the threshold poses keep 1 mm from the planes)."""
    rig = RIGS[rig_name]
    W, H = rig.resolution
    for kind in KINDS:
        cR, cpos, tgt, r = _poses(rig, kind, 64, seed=7)
        u0, u1, _, _, full = tvk.target_pixel_box(_consts(rig), cR, cpos, tgt, r, W, H)
        want_full, empty = _expected_regions(rig, cR, cpos, tgt, r)
        assert torch.equal(full, want_full), kind
        assert (u1[empty] < u0[empty]).all(), kind
        if kind in ("threshold", "rear", "beside"):
            assert full.any() and empty.any(), kind


@pytest.mark.parametrize("rig_name", ["96x72", "33x17"])
def test_box_sums_equal_the_pallas_chase_render(rig_name):
    """The box's count and sums against the JAX chase's full-frame mask."""
    rig = RIGS[rig_name]
    W, H = rig.resolution
    cfg = jpv._RenderCfg(hw=W * H, width=W, n_spheres=1, n_cylinders=0, n_gates=0,
                         spheres=True, cylinders=False, ground=False, gates=False,
                         max_depth=1.0, ground_extent=None)
    for kind in KINDS:
        cR, cpos, tgt, r = _poses(rig, kind, 32, seed=11)
        n = r.shape[0]
        cam = np.concatenate([torch.stack(cpos).numpy().T, torch.stack(cR).numpy().T,
                              np.zeros((n, 4), np.float32)], 1)
        wcol = np.concatenate([tgt.numpy().T, r.numpy()[:, None], np.ones((n, 1), np.float32)], 1)
        t_min, _ = jpv._render_tiles(cfg, jnp.asarray(tvk.flat_dcam(rig)), jnp.asarray(cam),
                                     jnp.asarray(wcol), chase_only=True)
        jmask = torch.from_numpy(np.array(t_min < 1e30))
        box = tvk.target_pixel_box(_consts(rig), cR, cpos, tgt, r, W, H)
        boxed = _mask(rig, cR, cpos, tgt, r) & _inside(rig, box)
        for want, got in zip(_sums(rig, jmask, torch.float32), _sums(rig, boxed, torch.float32)):
            assert torch.equal(want, got), kind


@pytest.mark.parametrize("bw,bh", [(1, 1), (1, 300), (17, 9), (96, 72), (127, 3), (128, 2),
                                   (129, 5), (300, 1), (0, 4)])
def test_box_walk_visits_each_pixel_once(bw, bh):
    """The kernel's walk over a box (csrc/vision_kernels.cu, chase_kernel):
    thread j of 128 starts at row-order index j and advances (u, v) by the
    block's stride with a carry instead of dividing each index by the width."""
    block, u0, v0 = 128, 5, 3
    u1 = u0 + bw - 1
    area = bw * bh if bw > 0 else 0
    seen = []
    for j in range(min(block, area)):
        du, dv = block % bw, block // bw
        u, v = u0 + j % bw, v0 + j // bw
        for _ in range(j, area, block):
            seen.append((u, v))
            u, v = u + du, v + dv
            if u > u1:
                u, v = u - bw, v + 1
    want = [(u0 + k % bw, v0 + k // bw) for k in range(area)]
    assert sorted(seen) == sorted(want) and len(set(seen)) == len(seen)


def test_chase_constants_carry_the_rig_intrinsics():
    """The kernel's box reads K's entries from the chase constants."""
    for rig in RIGS.values():
        p = _consts(rig)
        K = rig.K
        assert (p.ku, p.ks, p.kcu, p.kv, p.kcv) == tuple(
            float(np.float32(K[i, j])) for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2)))


def test_launch_ray_grid_is_made_once():
    """The K5 and K6 wrappers take the ray grid from one tensor per rig and
    device: a launch neither rebuilds it on the host nor waits on a copy."""
    rig = RIGS["33x17"]
    cpu = torch.device("cpu")
    grid = tvk.device_dcam(rig, cpu)
    assert tvk.device_dcam(rig, cpu) is grid
    assert torch.equal(grid, torch.from_numpy(tvk.flat_dcam(rig)))
    cfg, dcam, _, _ = tvk.render_inputs(rig, torch.zeros(2, 3), torch.eye(3).expand(2, 3, 3),
                                        tvk.AcroEnv(params=DroneParams(att_mode="quat"))
                                        .default_world(cpu), 10.0, ("spheres",), None, 0.08)
    assert dcam is grid
