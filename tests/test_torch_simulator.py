"""The port's simulator (``fpyv_tpu_torch.apps.simulator.run_simulator``)
against the JAX package's on the CPU, and the port's copy of the float64
oracle against ``tools/oracle/sim.py``.

Both simulators fly the params.yaml world with the scripted action: JAX
scans each chunk under ``jit``, the port steps eagerly and reads each chunk
once. Their float32 trajectories agree to float32 ulps, not bit for bit
(XLA fuses the step's products into sums), so the final state is held
within ``TOL`` over 60 steps and ``TOL_CRASH`` over a run that crashes
(step 84: the ground contact's spring moves the velocity by more); steps
and the crash flag are equal. The splat renderer is exact on equal poses
(tests/test_torch_vision.py), and the sunk 2d frames, HUD included, are
equal over 30 steps; past ~38 steps an ulp of pose first moves a point
across a pixel's edge (2 of 307 200 pixels at step 38). The chunking is
the port's own business: any chunk size gives the same run bit for bit.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from fpyv_tpu.apps.simulator import run_simulator as jsim
from fpyv_tpu_torch.apps.simulator import run_simulator as tsim
from fpyv_tpu_torch.config import FpyvConfig

TOL = {"final_position": 1e-5, "final_velocity": 1e-4}
TOL_CRASH = {"final_position": 1e-4, "final_velocity": 1e-3}


def _run(kw):
    return jsim(**kw), tsim(device="cpu", **kw)


def _close(out, ref, tol):
    assert out["steps"] == ref["steps"] and out["crashed"] == ref["crashed"]
    for k, t in tol.items():
        assert out[k].dtype == np.float32 and out[k].shape == (3,)
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=t, err_msg=k)


@pytest.mark.parametrize("guided", [True, False])
def test_headless_matches_jax(guided):
    ref, out = _run(dict(steps=60, guided=guided))
    assert out["steps"] == 60 and not out["crashed"]
    _close(out, ref, TOL)


def test_crash_inside_a_chunk_and_chunk_boundaries():
    # the default headless chunk is 512: the crash at step 84 lands inside it
    ref, out = _run(dict(steps=600))
    assert out["crashed"] and out["steps"] == 84
    _close(out, ref, TOL_CRASH)
    # chunks of 50: the crash inside the second; chunks of 16: 60 steps end
    # on a short chunk; either way the same run, bit for bit
    again = tsim(steps=600, chunk=50, device="cpu")
    assert again["steps"] == 84 and again["crashed"]
    for k in TOL:
        np.testing.assert_array_equal(again[k], out[k])
    a, b = tsim(steps=60, chunk=16, device="cpu"), tsim(steps=60, device="cpu")
    assert a["steps"] == 60
    for k in TOL:
        np.testing.assert_array_equal(a[k], b[k])
    # JAX at the same chunks
    jref = jsim(steps=600, chunk=50)
    _close(again, jref, TOL_CRASH)


def test_2d_frames_equal_jax():
    jf, tf = [], []
    ref = jsim(steps=30, render="2d", frame_sink=jf.append)
    out = tsim(steps=30, render="2d", frame_sink=tf.append, device="cpu")
    _close(out, ref, TOL)
    assert len(tf) == len(jf) == 15  # t % 2 == 0
    for i, (a, b) in enumerate(zip(tf, jf)):
        assert a.shape == (480, 640) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")
    assert (tf[0] > 0).mean() > 0.005  # the world is in view (a point splat)
    # the frames of a chunk boundary that is odd (chunk 7) are the same frames
    tf7 = []
    tsim(steps=30, render="2d", frame_sink=tf7.append, chunk=7, device="cpu")
    assert len(tf7) == 15 and all((a == b).all() for a, b in zip(tf7, tf))


def test_scripted_virtual_target_stream():
    """The headless mouse path (tests/test_inputs.py:162): a scripted drag
    steers the guided sim away from the centroid-guided run, as in JAX."""

    def drag_up_left(t):
        return [("down", 0, 0)] if t == 0 else [("move", 0, 0)]

    kw = dict(steps=12, render="none", guided=True, seed=0)
    ref, out = _run(dict(kw, virtual_target=True, target_events=drag_up_left))
    assert out["steps"] == 12
    _close(out, ref, TOL)
    base = tsim(device="cpu", **kw)
    assert np.linalg.norm(out["final_position"] - base["final_position"]) > 1e-3
    cfg = FpyvConfig()
    cfg = replace(cfg, simulator=replace(cfg.simulator, targets=dict(cfg.simulator.targets,
                                                                     count=0)))
    with pytest.raises(ValueError, match="targets"):
        tsim(cfg, steps=2, virtual_target=True, device="cpu")


def test_oracle_copy_equals_tools_oracle():
    from fpyv_tpu.config import FpyvConfig as JCfg
    from fpyv_tpu_torch.oracle.sim import OracleDrone as TOracle
    from fpyv_tpu_torch.oracle.sim import OracleGround as TGround
    from tools.oracle.sim import OracleDrone as JOracle
    from tools.oracle.sim import OracleGround as JGround

    rng = np.random.default_rng(42)
    actions = rng.uniform(-1, 1, (300, 4)) * np.array([0.3, 0.3, 0.2, 1.0])
    actions[:, 3] = rng.uniform(-0.6, 0.3, 300)
    jc, tc = JCfg(), FpyvConfig()
    drones = [(JOracle(jc), [JGround()], jc), (TOracle(tc), [TGround()], tc)]
    for d, _, c in drones:
        d.reset(c.drone.initial_position, c.drone.initial_velocity, c.drone.initial_orientation)
    wind = np.zeros(3)
    for a in actions:
        outs = [d.step(a, wind, objs) for d, objs, _ in drones]
        (j, _, _), (t, _, _) = drones
        for x, y in zip(*outs):
            np.testing.assert_array_equal(x, y)
        for name in ("pos", "vel", "R", "rates", "prev_thrust", "accel", "done"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    assert drones[1][0].pos.dtype == np.float64


def test_simulator_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsim(steps=1)


def test_3d_view_on_agg(monkeypatch):
    """``render="3d"`` (matplotlib, Agg here): the scripted path draws the
    position trail every third step, as JAX's chunked path does."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    shown = []
    monkeypatch.setattr(plt, "pause", lambda *a: shown.append(plt.gca()))
    out = tsim(steps=7, render="3d", chunk=4, device="cpu")
    assert out["steps"] == 7 and len(shown) == 3  # t = 0, 3, 6
    assert len(shown[-1].collections[0].get_offsets()) == 3  # the trail up to t = 6 of chunk 2
    plt.close("all")
