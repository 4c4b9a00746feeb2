"""The yardstick's work counts for K4, the fused acro env: the least a
launch has to do for its inputs (portbench/counts.py's rules: one
operation per add, multiply, compare, select, min, max, abs, divide,
square root, sine, cosine, log and floor, one per integer operation of the
counter hash; bytes are each input read once and each output written
once). A step is the physics (with the domain randomisation's scales and
the wind where the configuration has them), the env's 21 (reward, rows,
ends); a reset adds its draws; each step moves each target (18), and each
env's reward sum starts and ends a launch (17)."""

from __future__ import annotations

from typing import Dict

from portbench import counts

ENV_STEP_OPS = 21
TARGET_OPS = 18
LAUNCH_OPS = 17
STATE_ROWS, ACTION_ROWS, WORLD_ROWS, CYL_ROWS = 24, 4, 12, 6


def step_ops(spheres: int, cylinders: int, dr: bool, wind: bool, n_motors: int = 4) -> int:
    """One physics step; the scales cost 7, the wind 3."""
    return (counts.step_ops(spheres, cylinders, n_motors=n_motors) + (7 if dr else 0)
            + (3 if wind else 0))


def reset_ops(dr: bool, gust: bool) -> int:
    """One reset: 10 draws for the pose with its Box-Muller pair, the
    quaternion and the distance to the target; 3 draws for the scales; 4
    for the gust and its two pairs."""
    d = counts.DRAW_OPS
    ops = 10 * d + 6 + 18 + 3 + 9 + 6 + 20 + 9
    return ops + (3 * d + 6 if dr else 0) + (4 * d + 24 if gust else 0)


def launch_work(cfg: Dict, resets: float = 0) -> Dict[str, float]:
    """The work of one launch of the configuration's K4: its num_steps
    steps over num_envs envs with ``resets`` env-steps that reset."""
    a, w = cfg["acro"], cfg["world"]
    n, k = cfg["num_envs"], cfg["num_steps"]
    S, C = w["targets"]["count"], w["obstacles"]["count"]
    dr = bool(a["randomize"])
    wind = any(x != 0.0 for x in a["wind"]) or a["wind_scale"] > 0.0
    gust = wind and a["wind_scale"] > 0.0
    ops = (n * k * (step_ops(S, C, dr, wind, cfg["drone"]["n_motors"]) + ENV_STEP_OPS)
           + resets * reset_ops(dr, gust) + k * TARGET_OPS * S + n * LAUNCH_OPS)
    nbytes = n * (2 * STATE_ROWS + ACTION_ROWS + 1) * 4 + (WORLD_ROWS * S + CYL_ROWS * C) * 4
    return {"ops": ops, "flops": 0, "bytes": nbytes}

