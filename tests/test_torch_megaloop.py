"""The acro megaloop (``ops/env_kernel.py::fused_env_rollout``) against the
benchmark's plain reference (``portbench/reference/acro.py``), its spans,
and the benchmark driver that times it (``portbench/drivers/megaloop.py``).

On the CPU the megaloop runs K4's plain version, which must equal the
reference bit for bit: 64 envs for 300 steps on params.yaml's world with
50-step episodes, so that every env resets several times, with domain
randomisation and wind each on and off, from the bank the run's seed draws
and then once more with the world's target counters threaded on. On the
card (``cuda``, skips here) K4 itself at 4096 envs and K = 64 on the
benchmark's configuration equals the reference bit for bit. Imports no
JAX:

    python -m pytest --noconftest -q tests/test_torch_megaloop.py
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest
import torch

import fpyv_tpu_torch.envs  # noqa: F401  (the envs first: env_kernel imports them)
from fpyv_tpu_torch.config import SimulatorConfig
from fpyv_tpu_torch.envs.acro import AcroEnv, vector_reset
from fpyv_tpu_torch.ops import env_kernel as ek
from fpyv_tpu_torch.physics.drone import AIR_DENSITY, DroneParams
from fpyv_tpu_torch.utils import profiling
from fpyv_tpu_torch.world.generators import WorldSpec, build_world
from portbench import counts, counts_env
from portbench.drivers import megaloop as driver
from portbench.reference import acro

REPO = Path(__file__).resolve().parents[1]
CFG = json.loads((REPO / "portbench" / "configs" / "acro_dr_wind.json").read_text())
SEED = 2**31 + 7
HOVER = [0.0, 0.0, 0.0, -0.6]


def _cfg(n: int, k: int, dr: bool = True, wind: bool = True, episode: int = 1000):
    cfg = copy.deepcopy(CFG)
    cfg["num_envs"], cfg["num_steps"] = n, k
    a = cfg["acro"]
    a["max_episode_steps"], a["randomize"] = episode, dr
    if not wind:
        a["wind"], a["wind_scale"] = [0.0, 0.0, 0.0], 0.0
    return cfg


def _bank(cfg, device):
    env = driver.make_env(cfg)
    world = build_world(WorldSpec.from_config(SimulatorConfig(), seed=SEED), device=device)
    state, _ = vector_reset(env, torch.Generator().manual_seed(SEED), cfg["num_envs"], world)
    action = torch.tensor(cfg["action"], device=device).repeat(cfg["num_envs"], 1)
    return env, world, state, action


def test_the_configuration_holds_the_ports_numbers():
    p, d, a = DroneParams(att_mode="quat"), CFG["drone"], CFG["acro"]
    assert d["air_density"] == AIR_DENSITY and CFG["params"] == {"att_mode": "quat"}
    for key in ("dt", "gravity", "mass", "max_rates", "rates_transition_rate",
                "thrust_transition_rate", "n_motors", "motor_radius", "double_rotation_quirk"):
        assert d[key] == getattr(p, key), key
    assert tuple(d["drag_coef"]) == p.drag_coef and tuple(d["cross_sections"]) == p.cross_sections
    assert tuple(d["throttle2thrust_coeffs"]) == p.thrust_curve.throttle2thrust_coeffs
    assert d["max_force"] == p.thrust_curve.max_force
    env, default = driver.make_env(CFG), AcroEnv()
    for key in a:
        if key not in ("randomize", "wind", "wind_scale"):
            assert getattr(env, key) == getattr(default, key), key
    assert (env.randomize, env.wind, env.wind_scale) == (True, (1.0, 0.5, 0.0), 0.5)
    sim = SimulatorConfig()
    for key, value in CFG["world"]["targets"].items():
        assert sim.targets[key] == value, key
    for key, value in CFG["world"]["obstacles"].items():
        assert sim.obstacles[key] == value, key
    assert CFG["action"] == HOVER and CFG["num_envs"] == 4096 and CFG["num_steps"] == 2048


@pytest.mark.parametrize("wind", [True, False], ids=["wind", "still"])
@pytest.mark.parametrize("dr", [True, False], ids=["dr", "nominal"])
def test_the_megaloop_equals_the_reference_bit_for_bit(dr, wind):
    cfg = _cfg(64, 300, dr, wind, episode=50)
    env, world, state, action = _bank(cfg, "cpu")
    wld = acro.world(cfg, SEED, "cpu")
    cols = ek.env_state_to_matrix(state)
    assert torch.equal(cols, acro.start(cfg, SEED, wld))
    ref = acro.Megaloop(cfg, wld)
    res = cfg["world"]["targets"]["path"]["resolution"]
    for call in range(2):  # the second call from the first's state and world
        seed = driver.kernel_seed(SEED, call)
        out, world, rsum = ek.fused_env_rollout(env, state, action, world, 300, seed=seed)
        [(ref_state, ref_rsum, flags)] = ref.follow([(cols, call * 300 % res, seed)])
        state, cols = out, ek.env_state_to_matrix(out)
        assert torch.equal(cols, ref_state) and torch.equal(rsum, ref_rsum)
        # every env resets at least 5 times in 300 steps of 50-step episodes
        assert flags.sum(0).min() >= 5
    assert int(world.sphere_path_count[0]) == 600


def test_the_megaloop_records_its_spans_under_the_profiler_only():
    cfg = _cfg(8, 4)
    env, world, state, action = _bank(cfg, "cpu")
    profiling.clear_spans()
    ek.fused_env_rollout(env, state, action, world, 4)
    assert profiling.spans() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        ek.fused_env_rollout(env, state, action, world, 4)
    recs = profiling.spans()
    profiling.clear_spans()
    assert [(r.name, r.parent) for r in recs] == [
        ("megaloop", -1), ("megaloop.pack", 0), ("megaloop.launch", 0), ("megaloop.unpack", 0)]
    assert all(r.end_ns >= r.start_ns > 0 and r.syncs == 0 for r in recs)


def test_the_driver_gives_each_call_its_own_kernel_seed(monkeypatch):
    cfg = _cfg(8, 3)
    seeds = []
    orig = ek.fused_env_rollout

    def spy(env, state, action, world, n_steps, seed=0):
        seeds.append(seed)
        return orig(env, state, action, world, n_steps, seed)

    monkeypatch.setattr(ek, "fused_env_rollout", spy)
    s = driver.setup(cfg, {}, 2**31 - 2, "cpu")
    s["cfg"] = cfg
    ctx = driver.window(s, {"traced_calls": 2}, 0.3, False)
    assert len(seeds) == ctx["calls"] + 1 >= 4
    assert seeds[:4] == [2**31 - 2, 2**31 - 1, 0, 1]
    assert [L.call for L in s["launches"]] == [0, ctx["calls"]]
    assert s["launches"][-1].seed == seeds[-1]
    assert ctx["env_steps"] == ctx["calls"] * 8 * 3


def test_the_k4_counts_are_chip_smokes():
    import chip_smoke

    for dr in (False, True):
        for wind in (False, True):
            assert counts_env.step_ops(1, 5, dr, wind) == chip_smoke.step_ops(1, 5, dr=dr,
                                                                              wind=wind)
            assert counts_env.reset_ops(dr, wind) == chip_smoke.reset_ops(dr, wind)
    work = counts_env.launch_work(CFG, resets=10_000)
    n, k = 4096, 2048
    assert work["ops"] == (n * k * (chip_smoke.step_ops(1, 5, dr=True, wind=True) + 21)
                           + 10_000 * chip_smoke.reset_ops(True, True) + k * 18 + n * 17)
    assert work["bytes"] == n * (24 + 4 + 24 + 1) * 4 + (12 + 6 * 5) * 4
    assert counts.least_seconds(work) == work["ops"] / counts.PEAK_F32_OPS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_k4_equals_the_reference_on_the_benchmarks_configuration(cuda_device):
    cfg = _cfg(4096, 64)
    env, world, state, action = _bank(cfg, cuda_device)
    wld = acro.world(cfg, SEED, cuda_device)
    ref = acro.Megaloop(cfg, wld)
    cols = ek.env_state_to_matrix(state)
    assert torch.equal(cols, acro.start(cfg, SEED, wld))
    starts, outs = [], []
    for call in range(3):
        seed = driver.kernel_seed(SEED, call)
        starts.append((cols, call * 64, seed))
        state, world, rsum = ek.fused_env_rollout(env, state, action, world, 64, seed=seed)
        cols = ek.env_state_to_matrix(state)
        outs.append((cols, rsum))
    for (cols, rsum), (ref_state, ref_rsum, _) in zip(outs, ref.follow(starts)):
        assert torch.equal(cols, ref_state) and torch.equal(rsum, ref_rsum)
