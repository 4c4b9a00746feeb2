"""Closed-loop training: the trainer's ``train_iteration`` one iteration
after another, each one kernel launch of T steps over the bank, the
bootstrap frame and the PPO learner.

Set-up builds the trainer through its entry point, loads the benchmark's
weights into its net, and drives its first ``followed_iterations``
iterations through the window's own call while recording each launch, the
loss, Adam's first step and the weights after them: the reference follows
those. They also warm every shape the window uses. The window then goes on
from the same state."""

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
    w0 = program.seeded_weights(cfg, seed, device)
    program.load_weights(st.params, w0)
    race = cfg["env"] == "race"
    start = (st.env_state[0] if race else st.env_state).clone()
    gen0 = st.generator.get_state()
    grad: Dict[str, torch.Tensor] = {}

    def first_step(opt, args, kwargs):
        if not grad:
            grad.update(program.adam_first_grad(st.params, opt))

    hook = st.opt_state.register_step_post_hook(first_step)
    calls, boots, losses = [], [], []
    with program.recording(cfg, calls):
        for _ in range(wl["followed_iterations"]):
            st, info = trainer.train_iteration(st)
            losses.append(info["loss"])
            boots.append(st.last_obs)
    hook.remove()
    n, t = cfg["num_envs"], cfg["num_steps"]
    ppo = cfg["ppo"]
    block = ppo["shuffle_block"] if (n * t) % (ppo["shuffle_block"] * ppo["num_minibatches"]) == 0 else 1
    program.sync(st.params.log_std.is_cuda)
    return {"trainer": trainer, "state": st, "seed": seed, "cuda": st.params.log_std.is_cuda, "w0": w0, "start": start,
            "launches": [program.launch_from_call(cfg, c, b) for c, b in zip(calls, boots)],
            "perms": program.replay_shuffles(gen0, len(calls), ppo["update_epochs"], n * t // block),
            "losses": [float(x) for x in losses], "grad": grad,
            "params": program.net_weights(st.params)}


def _split(trainer, st, reps: int, cuda: bool):
    """The learner's time as ``chip_smoke.py::trainer_split`` takes it: the
    rollout alone, then a whole iteration, CUDA events around each."""
    roll, whole = [], []
    for _ in range(reps):
        ev = [program.Stamp(cuda) for _ in range(4)]
        ev[0].record()
        trainer.rollout_fn(st)
        ev[1].record()
        ev[2].record()
        st, _ = trainer.train_iteration(st)
        ev[3].record()
        program.sync(cuda)
        roll.append(ev[0].elapsed_time(ev[1]))
        whole.append(ev[2].elapsed_time(ev[3]))
    return st, {"rollout_ms": roll, "iteration_ms": whole}


def window(s: Dict, wl: Dict, seconds: float, trace: bool) -> Dict:
    trainer, st, cuda = s["trainer"], s["state"], s["cuda"]
    T, N = s["launches"][0].frames.shape[:2]
    stamps = [program.Stamp(cuda)]  # iteration boundaries; None closes a traced stretch
    traced, spans, calls = None, None, 0
    t0 = time.perf_counter()
    stamps[0].record()
    while time.perf_counter() - t0 < seconds:
        if trace and traced is None and time.perf_counter() - t0 >= seconds / 2:
            box = {"st": st}

            def steady():
                for _ in range(wl["traced_calls"]):
                    with torch.profiler.record_function("train_iteration"):
                        box["st"], _ = trainer.train_iteration(box["st"])

            traced = ptrace.profile(steady, cuda)
            st, spans = _split(trainer, box["st"], wl["split_reps"], cuda)
            calls += wl["traced_calls"] + wl["split_reps"]
            stamps += [None, program.Stamp(cuda).record()]
            continue
        st, _ = trainer.train_iteration(st)
        stamps.append(program.Stamp(cuda).record())
        calls += 1
    program.sync(cuda)
    window_s = time.perf_counter() - t0
    s["state"] = st
    return {"kind": "train", "window_s": window_s, "calls": calls, "env_steps": calls * N * T,
            "iteration_ms": [a.elapsed_time(b) for a, b in zip(stamps, stamps[1:])
                             if a is not None and b is not None],
            "trace": traced, "spans": spans}


def check(cfg: Dict, s: Dict, control: bool = False, detail=None,
          per_launch=None) -> Dict[str, float]:
    return rc.check_training(cfg, s["seed"], s["w0"], s["start"], s["launches"], s["perms"],
                             s["losses"], s["grad"], s["params"], control=control, detail=detail,
                             per_launch=per_launch)
