"""The system under test, as the benchmark reaches it: the port's trainers
built through their own entry points, the weights the benchmark makes or
loads and hands to both sides, and what a launch took and gave."""

from __future__ import annotations

import importlib
import time
from contextlib import contextmanager
from typing import Dict, List

import numpy as np
import torch

from portbench.reference.check import Launch

F = torch.float32
# the wrapper each kernel's rollout calls, by the kernel's launch-counter name
KERNEL_WRAPPERS = {
    "race_vision_rollout": ("fpyv_tpu_torch.ops.race_kernel", "fused_race_vision_rollout"),
    "policy_vision_rollout": ("fpyv_tpu_torch.ops.policy_kernel", "fused_policy_vision_rollout"),
}
# the net's layers in the benchmark's (Flax) names: (module, weight key, bias key)
LAYERS = (("patch_embed", "we", "be"), ("fc0", "wf", "bf"), ("pi_mean", "wm", "bm"),
          ("v_out", "wv", "bv"))


class Stamp:
    """A CUDA event on the card; on the CPU (the tests' tiny runs) the host
    clock at ``record``."""

    def __init__(self, cuda: bool):
        self.ev = torch.cuda.Event(enable_timing=True) if cuda else None
        self.t = 0.0

    def record(self) -> "Stamp":
        if self.ev is not None:
            self.ev.record()
        else:
            self.t = time.perf_counter()
        return self

    def elapsed_time(self, other: "Stamp") -> float:
        """ms from this stamp to ``other``."""
        if self.ev is not None:
            return self.ev.elapsed_time(other.ev)
        return (other.t - self.t) * 1e3


def sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def build(cfg: Dict, seed: int, device):
    """The cell's trainer from its configuration's entry point."""
    from fpyv_tpu_torch.vision.camera import CameraRig

    mod, fn = cfg["entry"].rsplit(".", 1)
    make = getattr(importlib.import_module(mod), fn)
    c = cfg["camera"]
    rig = CameraRig(pitch_deg=c["pitch_deg"], rel_position=tuple(c["rel_position"]),
                    fov_deg=c["fov_deg"], resolution=tuple(c["resolution"]))
    return make(seed=seed, rig=rig, device=device, **cfg["entry_kwargs"])


def proprio_width(cfg: Dict) -> int:
    return 5 + (cfg["race"]["n_gates"] if cfg["env"] == "race" else 0)


def patch_in(cfg: Dict) -> int:
    k = cfg["race"]["frame_stack"] if cfg["env"] == "race" else 1
    return k * cfg["net"]["patch"] ** 2


def seeded_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights from ``seed``, drawn on ``device`` in one call:
    kernels at lecun-normal scale (the mean head at 0.3 of it, so the
    actions steer), biases at 0.01, log_std at its initial value."""
    n = cfg["net"]
    W, H = cfg["camera"]["resolution"]
    fin = (W * H) // n["patch"] ** 2 * n["embed"] + proprio_width(cfg)
    shapes = {"we": (patch_in(cfg), n["embed"]), "be": (n["embed"],),
              "wf": (fin, n["hidden"]), "bf": (n["hidden"],),
              "wm": (n["hidden"], n["action_dim"]), "bm": (n["action_dim"],),
              "wv": (n["hidden"], 1), "bv": (1,)}
    scale = {"we": shapes["we"][0] ** -0.5, "wf": fin ** -0.5, "wm": 0.3 * n["hidden"] ** -0.5,
             "wv": n["hidden"] ** -0.5}
    sizes = [int(np.prod(s)) for s in shapes.values()]
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(sum(sizes), generator=g, dtype=F, device=device)
    out, at = {}, 0
    for (k, s), size in zip(shapes.items(), sizes):
        out[k] = flat[at:at + size].reshape(s) * scale.get(k, 0.01)
        at += size
    out["log_std"] = torch.full((n["action_dim"],), float(n["log_std_init"]), dtype=F,
                                device=device)
    return out


def file_weights(path: str, device) -> Dict[str, torch.Tensor]:
    """float32 weights from a policy file of Flax-named arrays
    (``<layer>/kernel``, ``<layer>/bias``, ``log_std``)."""
    with np.load(path) as z:
        flat = {k: torch.from_numpy(np.asarray(z[k], np.float32)).to(device) for k in z.files}
    out = {"log_std": flat["log_std"]}
    for layer, wk, bk in LAYERS:
        out[wk], out[bk] = flat[f"{layer}/kernel"], flat[f"{layer}/bias"]
    return out


def load_weights(net, w: Dict[str, torch.Tensor]) -> None:
    """Copy the benchmark's weights into the program's net, in place."""
    with torch.no_grad():
        for layer, wk, bk in LAYERS:
            m = getattr(net, layer)
            if tuple(m.weight.shape) != tuple(w[wk].T.shape):
                raise ValueError(f"{layer}: the net's {tuple(m.weight.shape)} does not take "
                                 f"{tuple(w[wk].T.shape)}")
            m.weight.copy_(w[wk].T)
            m.bias.copy_(w[bk])
        net.log_std.copy_(w["log_std"])


def net_weights(net) -> Dict[str, torch.Tensor]:
    """A float32 copy of the program's net in the benchmark's names."""
    out = {"log_std": net.log_std.detach().to(F).clone()}
    for layer, wk, bk in LAYERS:
        m = getattr(net, layer)
        out[wk] = m.weight.detach().T.to(F).clone()
        out[bk] = m.bias.detach().to(F).clone()
    return out


def adam_first_grad(net, opt) -> Dict[str, torch.Tensor]:
    """The gradient Adam took at its first step, from its first moment
    ((1 - b1) g after one step), in the benchmark's names."""
    b1 = opt.param_groups[0]["betas"][0]

    def g(p):
        return (opt.state[p]["exp_avg"].to(F) / (1.0 - b1)).clone()

    out = {"log_std": g(net.log_std)}
    for layer, wk, bk in LAYERS:
        m = getattr(net, layer)
        out[wk], out[bk] = g(m.weight).T, g(m.bias)
    return out


def seed_of(gen_state: torch.Tensor) -> int:
    """The kernel seed a rollout draws from a generator in ``gen_state``."""
    g = torch.Generator()
    g.set_state(gen_state)
    return int(torch.randint(0, 2**31 - 1, (), generator=g))


def replay_shuffles(gen_state: torch.Tensor, iterations: int, epochs: int, n_blocks: int
                    ) -> List[List[torch.Tensor]]:
    """Each iteration's epoch permutations, drawn after the rollout's seed
    from a generator in ``gen_state``."""
    g = torch.Generator()
    g.set_state(gen_state)
    out = []
    for _ in range(iterations):
        torch.randint(0, 2**31 - 1, (), generator=g)
        out.append([torch.randperm(n_blocks, generator=g) for _ in range(epochs)])
    return out


def launch_from_traj(cfg: Dict, seed: int, env_state, carry, obs, traj) -> Launch:
    """A Launch from a rollout_fn call: its input env state, output carry,
    bootstrap obs and trajectory."""
    race = cfg["env"] == "race"
    cols, hist = env_state if race else (env_state, None)
    cols_out = carry[0] if race else carry
    return Launch(seed=seed, cols=cols, hist=hist, frames=traj.obs["pixels"],
                  proprio=traj.obs["proprio"], action=traj.action, log_prob=traj.log_prob,
                  value=traj.value, reward=traj.reward, done=traj.done.to(F), cols_out=cols_out,
                  boot_pixels=obs["pixels"], boot_proprio=obs["proprio"])


@contextmanager
def recording(cfg: Dict, sink: List[dict]):
    """While open, every call of the cell's kernel wrapper appends its
    arguments and outputs to ``sink``; the wrapper is restored on exit."""
    mod_name, attr = KERNEL_WRAPPERS[cfg["kernel"]]
    mod = importlib.import_module(mod_name)
    orig = getattr(mod, attr)

    def spy(*args, **kwargs):
        out = orig(*args, **kwargs)
        sink.append({"args": args, "kwargs": kwargs, "out": out})
        return out

    setattr(mod, attr, spy)
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def launch_from_call(cfg: Dict, call: dict, boot: dict) -> Launch:
    """A Launch from a recorded wrapper call: (env, state, [hist,] world,
    weights, n_steps, seed, ...) -> (frames, extra, aux, state)."""
    race = cfg["env"] == "race"
    a = call["args"]
    cols, hist = (a[1], a[2]) if race else (a[2], None)
    seed = a[6]
    frames, extra, aux, cols_out = call["out"]
    return Launch(seed=seed, cols=cols, hist=hist, frames=frames,
                  proprio=extra[..., :proprio_width(cfg)], action=aux[..., 0:4],
                  log_prob=aux[..., 7], value=aux[..., 6], reward=aux[..., 4], done=aux[..., 5],
                  cols_out=cols_out, boot_pixels=boot["pixels"], boot_proprio=boot["proprio"])
