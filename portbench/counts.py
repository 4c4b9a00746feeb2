"""The yardstick's work counts: the least a K7 or K8 launch has to do for
its inputs, and the policy's model FLOPs.

Operations are counted per pixel, per env-step and per reset from the
arithmetic the inputs need (one per add, multiply, compare, select, min,
max, abs, divide, square root, sine, cosine, log and floor; one per integer
operation of the counter hash), whatever implements it: a live primitive
of the world (a sphere, a cylinder, the ground, an active gate) costs its
ray test at every pixel, an absent one nothing. The actor's products are
tensor-core work. Bytes are each input read once and each output written
once. The least time is the largest of float32 operations over the float32
peak, bf16 flops over the tensor cores' peak and bytes over HBM's rate.
Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit.
"""

from __future__ import annotations

from typing import Dict

PEAK_F32_OPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

DRAW_OPS = 13  # one hash draw: counter, xor, fmix (8), shift, convert, scale
CHASE_RESET_OPS = 10 * DRAW_OPS + 6 + 18 + 3 + 9 + 6 + 20 + 9
RACE_RESET_OPS = 4 * DRAW_OPS + 2 * 8 + 6 + 20  # 4 draws, 2 Box-Muller pairs, jitter, gate 0


def step_ops(spheres: int, cylinders: int, reps: int = 2, n_motors: int = 4) -> int:
    """One physics step: action, rotation, thrust, drag; per motor point its
    position, the ground and each sphere and cylinder; acceleration,
    integration, the attitude update (``reps`` rotations) and the done
    flag."""
    base = 12 + 9 + 5 + 6 + 3 + 39 + 3 + 6 + 15 + 6 + 15
    motors = n_motors * (19 + 31 * spheres + 58 * cylinders)
    return base + motors + 10 + 12 + 42 + 31 * reps + 1


def render_ops(spheres: int, cylinders: int, gates: int) -> int:
    """One pixel: the world ray and the level; each live primitive's test
    (the ground is in every world of these configurations)."""
    ops = 15 + 8 + 11
    ops += (5 + 33 * spheres) if spheres else 0
    return ops + 50 * cylinders + 89 * gates


def actor_flops(n_patches: int, patch_in: int, proprio: int, hidden: int, embed: int = 128
                ) -> int:
    """One forward of the patch actor: embed, fc, the 5 head outputs."""
    return 2 * (n_patches * patch_in * embed + (n_patches * embed + proprio) * hidden
                + hidden * 5)


def _weight_bytes(n_patches: int, patch_in: int, proprio: int, hidden: int, embed: int = 128
                  ) -> int:
    """The bf16 kernel weights (2 bytes) and the float32 heads and std."""
    return ((patch_in * embed + embed + hidden) * 2 + hidden * 8 * 4 + 8 * 4 + 8 * 4
            + (n_patches * embed + proprio) * hidden * 2)


def k7_launch(n: int, t: int, hw: int, spheres: int, cylinders: int, resets: int = 0,
              hidden: int = 256) -> Dict[str, float]:
    """K7: T steps of render, actor, sample and chase step over n envs in
    their own worlds (spheres, cylinders, ground, no gates)."""
    n_patches = hw // 64
    per_step = (hw * render_ops(spheres, cylinders, 0) + step_ops(spheres, cylinders)
                + 2 * 13 + 20 + 30 + 41)
    n_cols = 5 * spheres + 6 * cylinders + 1
    nbytes = (t * n * (hw + 2 * 8 * 4) + n * (2 * 18 + n_cols) * 4 + 3 * hw * 4
              + _weight_bytes(n_patches, 64, 5, hidden))
    return {"ops": n * t * per_step + resets * CHASE_RESET_OPS,
            "flops": n * t * actor_flops(n_patches, 64, 5, hidden), "bytes": nbytes}


def k8_launch(n: int, t: int, hw: int, obstacles: int, gates: int, frames: int, ends: int = 0,
              hidden: int = 256) -> Dict[str, float]:
    """K8: T steps of render (obstacles, ground, live gates), frame stack,
    actor, sample and race step over n single-agent races."""
    n_patches = hw // 64
    per_step = (hw * render_ops(obstacles, 0, gates) + 60 + 16 * obstacles + 5 + 3 * gates
                + 2 * 13 + 20 + 30 + step_ops(obstacles, 0) + 60)
    nbytes = (t * n * (frames * hw + (16 + 8) * 4) + n * (2 * 22 * 4 + (frames - 1) * hw)
              + 3 * hw * 4 + (15 * gates + 1 + 8) * 4
              + _weight_bytes(n_patches, frames * 64, 5 + gates, hidden))
    return {"ops": n * t * per_step + ends * RACE_RESET_OPS,
            "flops": n * t * actor_flops(n_patches, frames * 64, 5 + gates, hidden),
            "bytes": nbytes}


def least_seconds(work: Dict[str, float]) -> float:
    return max(work["ops"] / PEAK_F32_OPS, work["flops"] / PEAK_BF16_FLOPS,
               work["bytes"] / PEAK_BYTES)


def launch_work(cfg: Dict, ends: int = 0) -> Dict[str, float]:
    """The work of one launch of the configuration's kernel."""
    W, H = cfg["camera"]["resolution"]
    n, t, hidden = cfg["num_envs"], cfg["num_steps"], cfg["net"]["hidden"]
    if cfg["env"] == "race":
        r = cfg["race"]
        return k8_launch(n, t, W * H, r["n_obstacles"], r["n_gates"], r["frame_stack"], ends,
                         hidden)
    w = cfg["world"]
    return k7_launch(n, t, W * H, w["n_spheres"], w["n_cylinders"], ends, hidden)


def forward_flops(cfg: Dict) -> int:
    """Model FLOPs of one forward of the configuration's policy."""
    W, H = cfg["camera"]["resolution"]
    k = cfg["race"]["frame_stack"] if cfg["env"] == "race" else 1
    proprio = 5 + (cfg["race"]["n_gates"] if cfg["env"] == "race" else 0)
    return actor_flops((W * H) // 64, k * 64, proprio, cfg["net"]["hidden"], cfg["net"]["embed"])


def iteration_flops(cfg: Dict) -> int:
    """Model FLOPs of one PPO iteration: the rollout's forwards, the
    bootstrap forward, and forward and backward (3 forwards) over every
    epoch's samples."""
    n, t = cfg["num_envs"], cfg["num_steps"]
    return forward_flops(cfg) * (n * t + n + 3 * cfg["ppo"]["update_epochs"] * n * t)
