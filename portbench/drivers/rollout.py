"""Back-to-back rollouts: the trainer's ``rollout_fn``, one kernel launch
of T steps over the bank and the bootstrap frame a call, the carry and the
observation threaded from each call to the next and the learner bypassed.

Set-up builds the trainer through its entry point, loads the cell's
weights (the workload's policy file, or the benchmark's seeded weights)
into its net and makes the first call from the trainer's fresh state,
which warms every shape and is checked with the window's first and last
launches."""

from __future__ import annotations

import time
from typing import Dict

import torch

from portbench import program
from portbench import trace as ptrace
from portbench.reference import check as rc


def setup(cfg: Dict, wl: Dict, seed: int, device) -> Dict:
    trainer = program.build(cfg, seed, device)
    st = trainer.state
    policy = wl.get("policy")
    w0 = (program.file_weights(policy, device) if policy
          else program.seeded_weights(cfg, seed, device))
    program.load_weights(st.params, w0)
    race = cfg["env"] == "race"
    start = (st.env_state[0] if race else st.env_state).clone()
    s = {"trainer": trainer, "state": st, "seed": seed, "cuda": st.params.log_std.is_cuda, "w0": w0, "start": start, "launches": []}
    s["launches"].append(_call(cfg, s))
    program.sync(s["cuda"])
    return s


def _call(cfg: Dict, s: Dict):
    """One rollout from the current state; returns its Launch and threads
    the carry on."""
    st = s["state"]
    g = st.generator.get_state()
    carry, obs, traj = s["trainer"].rollout_fn(st)
    s["state"] = st.replace(env_state=carry, last_obs=obs)
    return program.launch_from_traj(cfg, program.seed_of(g), st.env_state, carry, obs, traj)


def window(s: Dict, wl: Dict, seconds: float, trace: bool) -> Dict:
    cfg = s["cfg"]
    rollout_fn = s["trainer"].rollout_fn
    traced, calls, first, last = None, 0, None, None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if trace and traced is None and time.perf_counter() - t0 >= seconds / 2:
            def steady():
                for _ in range(wl["traced_calls"]):
                    st = s["state"]
                    with torch.profiler.record_function("rollout_fn"):
                        carry, obs, _ = rollout_fn(st)
                    s["state"] = st.replace(env_state=carry, last_obs=obs)

            traced = ptrace.profile(steady, s["cuda"])
            calls += wl["traced_calls"]
            continue
        st = s["state"]
        g = st.generator.get_state()
        carry, obs, traj = rollout_fn(st)
        s["state"] = st.replace(env_state=carry, last_obs=obs)
        last = (g, st.env_state, carry, obs, traj)
        first = first or last
        calls += 1
    program.sync(s["cuda"])
    window_s = time.perf_counter() - t0
    for g, env_state, carry, obs, traj in {id(x): x for x in (first, last) if x}.values():
        s["launches"].append(program.launch_from_traj(cfg, program.seed_of(g), env_state, carry,
                                                      obs, traj))
    T, N = s["launches"][0].frames.shape[:2]
    return {"kind": "rollout", "window_s": window_s, "calls": calls, "env_steps": calls * N * T,
            "trace": traced}


def check(cfg: Dict, s: Dict, control: bool = False, detail=None,
          per_launch=None) -> Dict[str, float]:
    return rc.check_rollouts(cfg, s["seed"], s["w0"], s["start"], s["launches"],
                             control=control, per_launch=per_launch)
