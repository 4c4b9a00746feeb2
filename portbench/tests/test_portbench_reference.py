"""The plain reference against the port on the CPU: the configuration
files hold the port's own numbers, and at a tiny size the reference
follows the port's plain kernel versions exactly on the env half and
within bf16's rounding on the actor and the learner."""

from __future__ import annotations

import pytest
import torch

from portbench.reference import check as rc
from portbench.reference import sim
from portbench.tests.tiny import run_tiny, tiny_cell

EXACT = ("start", "frames", "ends", "env", "boot", "boot_env", "log_prob")


def test_race_config_holds_the_ports_numbers():
    from fpyv_tpu_torch.envs.multi_race import MultiRaceEnv
    from fpyv_tpu_torch.envs.vision_race import VisionRaceEnv
    from fpyv_tpu_torch.physics.drone import AIR_DENSITY, DroneParams

    cfg = tiny_cell("race_train")["cfg"]
    venv = VisionRaceEnv(race=MultiRaceEnv(n_agents=1, gate_size=5.0, n_obstacles=3),
                         frame_width=0.35, gate_onehot=False, frame_stack=4)
    r = venv.race
    for key in ("track_radius", "spawn_radius", "spawn_height", "gate_height", "n_gates",
                "obstacle_radius", "obstacle_period", "w_gate", "w_progress", "w_alive",
                "w_crash", "max_episode_steps", "gate_size", "n_obstacles"):
        assert cfg["race"][key] == getattr(r, key), key
    assert cfg["camera"]["max_depth"] == venv.max_depth
    p, d = DroneParams(), cfg["drone"]
    assert d["air_density"] == AIR_DENSITY
    for key in ("dt", "gravity", "mass", "max_rates", "rates_transition_rate",
                "thrust_transition_rate", "n_motors", "motor_radius", "double_rotation_quirk"):
        assert d[key] == getattr(p, key), key
    assert tuple(d["drag_coef"]) == p.drag_coef and tuple(d["cross_sections"]) == p.cross_sections
    assert tuple(d["throttle2thrust_coeffs"]) == p.thrust_curve.throttle2thrust_coeffs
    assert d["max_force"] == p.thrust_curve.max_force


def test_chase_config_holds_the_ports_numbers():
    from fpyv_tpu_torch.envs.acro import AcroEnv
    from fpyv_tpu_torch.world.randomize import WorldRanges

    cfg = tiny_cell("chase_rollout")["cfg"]
    env, c = AcroEnv(), cfg["chase"]
    assert tuple(c["pos_low"]) == env.pos_low and tuple(c["pos_high"]) == env.pos_high
    for key in ("vel_scale", "ypr_range_deg", "max_episode_steps", "w_progress", "w_alive",
                "w_crash", "w_rates"):
        assert c[key] == getattr(env, key), key
    w = WorldRanges()
    for key in ("target_center", "target_radius", "target_path_radius", "cyl_radius",
                "cyl_height"):
        assert tuple(cfg["world"][key]) == getattr(w, key), key
    assert cfg["world"]["target_center_std"] == w.target_center_std
    assert cfg["world"]["cyl_xy_std"] == w.cyl_xy_std


def test_noise_matches_the_ports_hash():
    from fpyv_tpu_torch.ops.env_kernel import lane_ids, normal_pair

    for seed in (0, 7, 2**31 + 5):
        a, b = sim.lanes(64, seed, "cpu"), lane_ids(64, seed, "cpu")
        assert torch.equal(a, b)
        for x, y in zip(sim.normals(a, 52, 53), normal_pair(b, 52, 53)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("cell,kw", [
    ("race_rollout", {"t": 12, "max_episode_steps": 5}),
    ("chase_rollout", {"t": 8}),
    ("race_train", {"t": 8, "max_episode_steps": 5}),
])
def test_reference_follows_the_ports_plain_versions(cell, kw):
    res = run_tiny(tiny_cell(cell, **kw))
    checks = {k: c["value"] for k, c in res["checks"].items()}
    for k in EXACT:
        assert checks[k] == 0, (k, checks)
    # the program's actor runs in bf16, the reference's in float32
    assert 0 < checks["mean"] < 0.02 and 0 < checks["value"] < 0.02, checks
    if cell == "race_train":
        assert checks["loss"] < 0.02 and checks["grad"] < 0.05 and checks["change"] < 0.05, checks


def test_the_followed_launch_walks_through_respawns():
    """At 5-step episodes every race ends inside a 12-step launch; the
    reference follows the program through each respawn."""
    found = tiny_cell("race_rollout", t=12, max_episode_steps=5)
    s = found["driver"].setup(found["cfg"], found["wl"], 99, "cpu")
    L = s["launches"][0]
    assert float(L.done.sum()) >= L.done.shape[1] * 2
    checks = found["driver"].check(found["cfg"], s)
    assert checks["frames"] == checks["ends"] == checks["env"] == 0


def test_gaps_see_a_difference():
    a = torch.tensor([1.0, 2.0])
    assert rc.relgap(a, a) == 0.0
    assert rc.relgap(a + 0.5, a) > 0.1
    assert not rc.relgap(a * float("nan"), a) <= 1.0
