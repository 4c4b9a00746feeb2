"""Faults planted underneath the timed path, to show that the check comes
out not correct on each that a cell can have: a step that returns its
state unchanged, half of the batch left out, an answer or an action altered
where the kernel produces it, and in the learner half of each minibatch
left out (the mean taken over the rest) or an update that leaves the
weights unchanged. One card holds every cell, so no exchange between chips
can be left out. Used by the tests and by ``portbench.calibrate --fault``;
never by a benchmark run."""

from __future__ import annotations

import importlib
from contextlib import contextmanager
from typing import Dict

import torch

from portbench.program import KERNEL_WRAPPERS


def _halve(x: torch.Tensor, axis: int) -> torch.Tensor:
    """The second half of the envs replaced by the first: half the batch
    left out, the rest stretched over it."""
    x = x.clone()
    h = x.shape[axis] // 2
    x.narrow(axis, h, h).copy_(x.narrow(axis, 0, h))
    return x


def _altered(aux: torch.Tensor, col: int) -> torch.Tensor:
    aux = aux.clone()
    aux[0, 0, col] += 1.0
    return aux


KERNEL = {
    "state_unchanged": lambda args, out, race: out[:3] + (
        (args[1] if race else args[2]).clone(),),
    "half_the_batch": lambda args, out, race: (
        _halve(out[0], 1), _halve(out[1], 1), _halve(out[2], 1), _halve(out[3], 0)),
    "a_reward_altered": lambda args, out, race: (out[0], out[1], _altered(out[2], 4), out[3]),
    "an_action_altered": lambda args, out, race: (out[0], out[1], _altered(out[2], 0), out[3]),
}
LEARNER = ("learner_on_half_the_batch", "weights_unchanged")


@contextmanager
def _swapped(module, name: str, value):
    orig = getattr(module, name)
    setattr(module, name, value)
    try:
        yield orig
    finally:
        setattr(module, name, orig)


@contextmanager
def planted(cfg: Dict, fault: str):
    """While open, the program runs with ``fault``."""
    if fault in KERNEL:
        mod_name, attr = KERNEL_WRAPPERS[cfg["kernel"]]
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, attr)

        def broken(*args, **kwargs):
            return KERNEL[fault](args, orig(*args, **kwargs), cfg["env"] == "race")

        with _swapped(mod, attr, broken):
            yield
        return
    from fpyv_tpu_torch.rl import ppo

    if fault == "learner_on_half_the_batch":
        orig_terms = ppo._ppo_terms

        def half(config, batch, log_prob, value, entropy_log_std, advantages, targets):
            h = advantages.shape[0] // 2

            def cut(x):
                return {k: v[:h] for k, v in x.items()} if isinstance(x, dict) else x[:h]

            batch = ppo.Transition(**{f: cut(getattr(batch, f)) for f in
                                      ("obs", "action", "log_prob", "value", "reward", "done")})
            return orig_terms(config, batch, log_prob[:h], value[:h], entropy_log_std,
                              advantages[:h], targets[:h])

        with _swapped(ppo, "_ppo_terms", half):
            yield
        return
    if fault == "weights_unchanged":
        def no_step(net, opt, loss, config):
            opt.zero_grad(set_to_none=True)
            loss.backward()

        with _swapped(ppo, "_update", no_step):
            yield
        return
    raise KeyError(f"no fault {fault!r}")
