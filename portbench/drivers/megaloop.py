"""Back-to-back megaloop calls: ``fused_env_rollout``, one K4 launch of the
configuration's steps over the whole bank a call with a fixed action, the
env state and the world (its target counters) threaded from each call to
the next. The kernel's seed is the run's seed plus the call's index, modulo
2^31, so that the resets at one step of successive launches draw anew.
A traced window times each traced call on the host clock
(``megaloop_call_ms``), with no synchronize added.

Set-up builds the env, the world and the bank from the run's seed as the
configuration says, and makes the first call (call 0), which builds and
warms K4 and is checked with the window's last call."""

from __future__ import annotations

import time
from typing import Dict

import torch

import fpyv_tpu_torch.envs  # noqa: F401  (the envs first: env_kernel imports them)
from fpyv_tpu_torch.config import SimulatorConfig
from fpyv_tpu_torch.envs.acro import AcroEnv, vector_reset
from fpyv_tpu_torch.ops import env_kernel
from fpyv_tpu_torch.physics.drone import DroneParams
from fpyv_tpu_torch.world.generators import WorldSpec, build_world
from portbench import program
from portbench import trace as ptrace
from portbench.reference import acro as ref

F = torch.float32
TUPLES = ("pos_low", "pos_high", "mass_range", "drag_range", "thrust_range", "wind")


def make_env(cfg: Dict) -> AcroEnv:
    kw = {k: tuple(v) if k in TUPLES else v for k, v in cfg["acro"].items()}
    return AcroEnv(params=DroneParams(**cfg["params"]), **kw)


def kernel_seed(seed: int, call: int) -> int:
    return (seed + call) % (1 << 31)


def setup(cfg: Dict, wl: Dict, seed: int, device) -> Dict:
    env = make_env(cfg)
    world = build_world(WorldSpec.from_config(SimulatorConfig(), seed=seed), device=device)
    n = cfg["num_envs"]
    state, _ = vector_reset(env, torch.Generator().manual_seed(seed), n, world)
    action = torch.tensor(cfg["action"], dtype=F, device=device).repeat(n, 1)
    s = {"env": env, "state": state, "world": world, "action": action, "seed": seed,
         "call": 0, "cuda": torch.device(device).type == "cuda", "launches": []}
    s["launches"].append(_record(_call(cfg, s)))
    program.sync(s["cuda"])
    return s


def _call(cfg: Dict, s: Dict):
    """One launch from the current state; threads the state and the world
    on and returns (call, kernel seed, input state, output state, reward
    sum)."""
    call, state = s["call"], s["state"]
    seed = kernel_seed(s["seed"], call)
    s["state"], s["world"], rsum = env_kernel.fused_env_rollout(
        s["env"], state, s["action"], s["world"], cfg["num_steps"], seed)
    s["call"] = call + 1
    return call, seed, state, s["state"], rsum


def _record(made) -> ref.MegaLaunch:
    call, seed, state, out, rsum = made
    return ref.MegaLaunch(call=call, seed=seed, cols=env_kernel.env_state_to_matrix(state),
                          cols_out=env_kernel.env_state_to_matrix(out), reward=rsum)


def window(s: Dict, wl: Dict, seconds: float, trace: bool) -> Dict:
    cfg = s["cfg"]
    traced, calls, last, call_ms = None, 0, None, []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if trace and traced is None and time.perf_counter() - t0 >= seconds / 2:
            def steady():
                for _ in range(wl["traced_calls"]):
                    t = time.perf_counter_ns()
                    with torch.profiler.record_function("fused_env_rollout"):
                        _call(cfg, s)
                    call_ms.append((time.perf_counter_ns() - t) * 1e-6)

            traced = ptrace.profile(steady, s["cuda"])
            calls += wl["traced_calls"]
            continue
        last = _call(cfg, s)
        calls += 1
    program.sync(s["cuda"])
    window_s = time.perf_counter() - t0
    if last is not None:
        s["launches"].append(_record(last))
    return {"kind": "rollout", "window_s": window_s, "calls": calls,
            "env_steps": calls * cfg["num_envs"] * cfg["num_steps"], "trace": traced,
            "megaloop_call_ms": call_ms if traced else None}


def check(cfg: Dict, s: Dict, per_launch=None) -> Dict[str, float]:
    return ref.check_megaloop(cfg, s["seed"], s["launches"], per_launch=per_launch)
