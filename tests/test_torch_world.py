"""The port's world (SoA, generators, SDFs, target motion, collisions)
against the JAX package on the CPU.

The world builder draws from numpy's ``default_rng(seed)`` in both packages,
so the built world must be equal exactly. SDF and collision outputs are
float32 with unit-scale magnitudes: atol 1e-5 (sqrt/division ulps); spring
forces are 100x distances, so their atol is 1e-3; crash flags are equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fpyv_tpu.config import SimulatorConfig as JSim
from fpyv_tpu.physics import collisions as jcol
from fpyv_tpu.physics import world as jw
from fpyv_tpu.world.generators import WorldSpec as JSpec, build_world as jbuild
from fpyv_tpu_torch import interop
from fpyv_tpu_torch.config import SimulatorConfig as TSim
from fpyv_tpu_torch.physics import collisions as tcol
from fpyv_tpu_torch.physics import world as tw
from fpyv_tpu_torch.world.generators import WorldSpec as TSpec, build_world as tbuild

RNG = np.random.default_rng(1)


def _params_world_pair(seed=2):
    jworld = jbuild(JSpec.from_config(JSim(), seed=seed), dtype=jnp.float32)
    tworld = tbuild(TSpec.from_config(TSim(), seed=seed), device="cpu")
    return jworld, tworld


@pytest.mark.parametrize("seed", [0, 2])
def test_build_world_equal_exactly(seed):
    jworld, tworld = _params_world_pair(seed)
    a, b = interop.world_to_numpy(tworld), interop.to_numpy_tree(jworld)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_world_numpy_round_trip():
    jworld, _ = _params_world_pair()
    d = interop.to_numpy_tree(jworld)
    back = interop.world_to_numpy(interop.world_from_numpy(d, "cpu"))
    for k in d:
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)


@pytest.mark.parametrize("n", [(0, 0, 0), (2, 3, 1)])
def test_empty_world_equal(n):
    a = interop.world_to_numpy(tw.empty_world(*n, device="cpu"))
    b = interop.to_numpy_tree(jw.empty_world(*n, dtype=jnp.float32))
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _points(m=64):
    return RNG.uniform([-6, -6, -1], [6, 6, 12], (m, 3)).astype(np.float32)


def test_sphere_sdf():
    c = RNG.uniform(-3, 3, (3, 3)).astype(np.float32)
    r = RNG.uniform(0.5, 2, 3).astype(np.float32)
    p = _points()
    for a, b in zip(tw.sphere_sdf(*map(torch.from_numpy, (c, r, p))),
                    jw.sphere_sdf(jnp.asarray(c), jnp.asarray(r), jnp.asarray(p))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("quirk", [True, False])
def test_cylinder_sdf_both_quirk_settings(quirk):
    c = np.asarray([[0, 0, 0], [2, 1, 0], [-2.5, -1, 3]], np.float32)
    r = np.asarray([1.0, 0.8, 1.5], np.float32)
    h = np.asarray([10.0, 6.0, 2.0], np.float32)
    p = _points(256)
    ta = tw.cylinder_sdf(*map(torch.from_numpy, (c, r, h, p)), relative_band_quirk=quirk)
    ja = jw.cylinder_sdf(*map(jnp.asarray, (c, r, h, p)), relative_band_quirk=quirk)
    for a, b in zip(ta, ja):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_ground_sdf_and_gate_plane():
    p = _points()
    for a, b in zip(tw.ground_sdf(torch.from_numpy(p)), jw.ground_sdf(jnp.asarray(p))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    track = {"count": 4, "radius": 12, "gate_size": 5, "gate_resolution": 17}
    jworld = jbuild(JSpec.from_config(JSim(track=track), seed=3), dtype=jnp.float32)
    tworld = tbuild(TSpec.from_config(TSim(track=track), seed=3), device="cpu")
    a = tw.gate_plane_distance(tworld.gate_pos, tworld.gate_rotmat, torch.from_numpy(p))
    b = jw.gate_plane_distance(jworld.gate_pos, jworld.gate_rotmat, jnp.asarray(p))
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_update_targets_steps():
    jworld, tworld = _params_world_pair()
    jworld = jworld.replace(sphere_path_count=jnp.asarray([5490], jnp.int32))
    tworld = tworld.replace(sphere_path_count=torch.tensor([5490], dtype=torch.int32))
    for _ in range(15):  # crosses the wrap at res = 5500
        jworld, tworld = jw.update_targets(jworld), tw.update_targets(tworld)
        np.testing.assert_allclose(tworld.sphere_center.numpy(),
                                   np.asarray(jworld.sphere_center), atol=2e-5)
        np.testing.assert_array_equal(tworld.sphere_path_count.numpy(),
                                      np.asarray(jworld.sphere_path_count))


def test_collide_matches_jax():
    jworld, tworld = _params_world_pair()
    # motor points spread over the obstacle field, near the ground and the cylinders
    cyl = np.asarray(jworld.cyl_center)
    n = 128
    base = cyl[RNG.integers(0, len(cyl), n)] + RNG.uniform([-3, -3, -0.2], [3, 3, 8], (n, 3))
    motors = (base[:, None, :] + RNG.uniform(-0.2, 0.2, (n, 4, 3))).astype(np.float32)
    vel = RNG.uniform(-2, 2, (n, 3)).astype(np.float32)
    fa, ca = tcol.collide(tworld, torch.from_numpy(motors), torch.from_numpy(vel))
    fb, cb = jcol.collide(jworld, jnp.asarray(motors), jnp.asarray(vel))
    assert np.asarray(cb).any() and not np.asarray(cb).all()  # premise: mixed contacts
    np.testing.assert_array_equal(ca.numpy(), np.asarray(cb))
    np.testing.assert_allclose(fa.numpy(), np.asarray(fb), atol=1e-3)


def test_entry_points_default_to_cuda(monkeypatch):
    """``device=None`` means CUDA: with no CUDA device the world builders
    and the other public constructors raise instead of building on the CPU."""
    from fpyv_tpu_torch.envs.acro import AcroEnv
    from fpyv_tpu_torch.envs.vision_acro import VisionAcroEnv
    from fpyv_tpu_torch.physics.drone import DomainRand, DroneParams, gravity_vector
    from fpyv_tpu_torch.world.randomize import sample_worlds

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = TSpec.from_config(TSim(), seed=2)
    for build in (lambda: tbuild(spec), tw.empty_world, DomainRand.nominal,
                  lambda: gravity_vector(DroneParams()), AcroEnv().default_world,
                  lambda: sample_worlds(torch.Generator(), 4),
                  lambda: VisionAcroEnv().make_world(spec)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    assert tbuild(spec, device="cpu").sphere_center.device.type == "cpu"
