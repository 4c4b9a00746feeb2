"""The comparisons that decide ``correct``: the program's launches, its
bootstrap frames and its learner against the plain reference.

A launch is followed teacher-forced: from the launch's own input state the
reference renders, stacks, reads the proprio and steps the env with the
actions the program took, and compares every frame, proprio row, reward,
end and the final state. The actor is judged at the program's own frames:
the program's mean (its action less the noise the reference draws), value
and log-prob against the reference's float32 actor. The learner is judged
by the training rule: each iteration's loss, the first gradient as the
optimizer got it, and each leaf's change over the iterations followed.

Numbers, each compared against a limit of the cell (``limits`` in its
workload file; a number above its limit, or not a number, is incorrect):

- ``frames``: pixels (levels) of the launches' frame stacks that differ;
- ``ends``: env ends that differ;
- ``env``: widest gap of a proprio entry, reward or final state entry,
  each as |program - reference| / (1 + |reference|);
- ``start``: the same gap between the program's first state and the one
  the reference draws from the seed;
- ``boot``: pixels of the bootstrap frames (rendered outside the kernel)
  that differ, as a share of the bootstrap pixels;
- ``mean``: widest gap of the action mean, in units of the action's std;
- ``value``: widest value gap, |program - reference| / (1 + |reference|);
- ``log_prob``: widest log-prob gap;
- ``loss``, ``grad``, ``change`` (training): the widest gap of an
  iteration's mean loss, against the reference's mean scale of a loss
  (the sum of its terms' magnitudes: the policy, value and entropy terms
  nearly cancel, so the loss itself is no scale); the widest relative gap
  of a leaf's first-gradient norm; of a leaf's change norm after the
  iterations followed. A leaf's gap is taken
  against the larger of its own reference norm and the median leaf's;
  leaves whose reference gradient is under a thousandth of the median
  leaf's move by round-off alone and are left out of ``change``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from portbench.reference import policy as rp
from portbench.reference import sim

F = torch.float32


@dataclass
class Launch:
    """What the program's rollout took and gave, as recorded by a driver."""

    seed: int
    cols: torch.Tensor  # (N, R) the launch's input state
    hist: Optional[torch.Tensor]  # (N, NP*(K-1)*64) uint8, the race's older frames
    frames: torch.Tensor  # (T, N, X) uint8
    proprio: torch.Tensor  # (T, N, P)
    action: torch.Tensor  # (T, N, 4)
    log_prob: torch.Tensor  # (T, N)
    value: torch.Tensor  # (T, N)
    reward: torch.Tensor  # (T, N)
    done: torch.Tensor  # (T, N) float: the race's env end, the chase's crash
    cols_out: torch.Tensor  # (N, R)
    boot_pixels: torch.Tensor  # (N, X) uint8: the bootstrap observation after the launch
    boot_proprio: torch.Tensor  # (N, P)


def relgap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / (1 + |b|), b the reference; nan where either is."""
    if a.numel() == 0:
        return 0.0
    return float(((a.to(F) - b.to(F)).abs() / (1.0 + b.to(F).abs())).max())


def make_env(cfg: Dict, seed: int, device):
    if cfg["env"] == "race":
        return sim.RaceEnv(cfg, device)
    return sim.ChaseEnv(cfg, sim.chase_worlds(cfg, seed, device), device)


def start_state(cfg: Dict, env, seed: int, device) -> torch.Tensor:
    if cfg["env"] == "race":
        return sim.race_start(cfg, seed, device)
    return sim.chase_start(cfg, seed, torch.stack(env.spheres[0][:3], dim=-1))


def start_gap(cfg: Dict, env, seed: int, cols: torch.Tensor) -> float:
    return relgap(cols, start_state(cfg, env, seed, cols.device))


def noise(lane: torch.Tensor, i: int) -> torch.Tensor:
    base = (i + 1) * 32
    z0, z1 = sim.normals(lane, base + 20, base + 21)
    z2, z3 = sim.normals(lane, base + 22, base + 23)
    return torch.stack([z0, z1, z2, z3], dim=1)


def follow(env, L: Launch) -> Dict[str, float]:
    """The env half of a launch, teacher-forced: frames, ends, env."""
    T, N = L.frames.shape[:2]
    s = list(L.cols.to(F).unbind(1))
    lane = sim.lanes(N, L.seed, L.cols.device)
    race = isinstance(env, sim.RaceEnv)
    NP = env.cam.n_patches
    older = L.hist.to(F).reshape(N, NP, env.K - 1, sim.PP) if race else None
    frames = ends = 0
    gap = 0.0
    for i in range(T):
        cur = env.render(s)
        if race:
            cur = cur.reshape(N, NP, 1, sim.PP)
            flush = (s[21] > 0.5)[:, None, None, None]
            stack = torch.cat([torch.where(flush, cur.expand_as(older), older), cur], dim=2)
            older = stack[:, :, 1:]
            cur = stack.reshape(N, -1)
        frames += int((cur != L.frames[i].to(F)).sum())
        gap = max(gap, relgap(L.proprio[i], torch.stack(env.proprio(s), dim=1)))
        s, reward, end = env.step(s, list(L.action[i].to(F).unbind(1)), lane, i)
        gap = max(gap, relgap(L.reward[i], reward))
        ends += int(((end > 0.5) != (L.done[i] > 0.5)).sum())
    gap = max(gap, relgap(L.cols_out, torch.stack(s, dim=1)))
    return {"frames": frames, "ends": ends, "env": gap}


def bootstrap(env, L: Launch) -> Dict[str, float]:
    """The bootstrap observation the program rendered after the launch
    (through its frame renderer, the env's obstacle formula and true
    divisions), against the reference's render of the program's final
    state."""
    s = list(L.cols_out.to(F).unbind(1))
    N = L.cols_out.shape[0]
    cur = env.render(s, env_formula=True)
    if isinstance(env, sim.RaceEnv):
        NP, K = env.cam.n_patches, env.K
        cur = cur.reshape(N, NP, 1, sim.PP)
        older = L.frames[-1].to(F).reshape(N, NP, K, sim.PP)[:, :, 1:]
        older = torch.where((s[21] > 0.5)[:, None, None, None], cur.expand_as(older), older)
        cur = torch.cat([older, cur], dim=2).reshape(N, -1)
        accel = s[18]
    else:
        accel = s[17]
    p = env.phys
    prop = [sim.tdiv(s[10], p.max_rates), sim.tdiv(s[11], p.max_rates),
            sim.tdiv(s[12], p.max_rates), sim.tdiv(accel, 30.0), sim.tdiv(s[13], p.max_force)]
    if isinstance(env, sim.RaceEnv):
        prop = prop + env.proprio(s)[5:]
    boot = float((cur != L.boot_pixels.to(F)).sum()) / cur.numel()
    return {"boot": boot, "boot_env": relgap(L.boot_proprio, torch.stack(prop, dim=1))}


def launch_noise(L: Launch) -> torch.Tensor:
    """(T, N, 4) the action noise the launch's seed draws."""
    T, N = L.frames.shape[:2]
    lane = sim.lanes(N, L.seed, L.cols.device)
    return torch.stack([noise(lane, i) for i in range(T)])


def old_log_prob(L: Launch, log_std: torch.Tensor, log_2pi2: float) -> torch.Tensor:
    """The rollout's log-prob of its own sample: from the noise, as the
    kernels compute it."""
    z0, z1, z2, z3 = launch_noise(L).unbind(-1)
    ls = [sim.f32(x) for x in log_std.tolist()]
    return (-0.5 * (z0 * z0 + z1 * z1 + z2 * z2 + z3 * z3)
            - sim.f32(sim.f32(sim.f32(ls[0] + ls[1]) + ls[2]) + ls[3]) - log_2pi2)


def actor_gaps(params: Dict[str, torch.Tensor], L: Launch, patch_in: int, log_2pi2: float,
               control: bool = False):
    """The actor at the program's frames. Returns (gaps, the reference's
    value (T, N), log-prob (T, N)). With ``control`` the float8 actor takes
    the program's place: its gaps are read against the float32
    reference."""
    z = launch_noise(L)
    mean, log_std, value = rp.actor_batched(params, L.frames, L.proprio, patch_in)
    logp = old_log_prob(L, log_std, log_2pi2)
    std = torch.exp(log_std)
    if control:
        c_mean, _, c_value = rp.actor_batched(params, L.frames, L.proprio, patch_in, control=True)
        p_mean, p_value, p_logp = c_mean, c_value, logp
    else:
        p_mean, p_value, p_logp = L.action.to(F) - std * z, L.value.to(F), L.log_prob.to(F)
    gaps = {"mean": float(((p_mean - mean).abs() / std).max()),
            "value": relgap(p_value, value), "log_prob": float((p_logp - logp).abs().max())}
    return gaps, value, logp


def worst(acc: Dict[str, float], new: Dict[str, float]) -> Dict[str, float]:
    """Per number, the larger (a count adds up); nan wins."""
    out = dict(acc)
    for k, v in new.items():
        if k in ("frames", "ends"):
            out[k] = out.get(k, 0) + v
        elif k not in out or not (v <= out[k]):
            out[k] = v
    return out


def check_rollouts(cfg: Dict, seed: int, params: Dict[str, torch.Tensor], start_cols,
                   launches: List[Launch], control: bool = False,
                   per_launch: Optional[List[Dict]] = None) -> Dict[str, float]:
    """The rollout cells' numbers over the recorded launches;
    ``per_launch`` (optional) gets each launch's own (the start goes with
    the first)."""
    env = make_env(cfg, seed, launches[0].cols.device)
    rows = [{"start": start_gap(cfg, env, seed, start_cols)}] + [{} for _ in launches[1:]]
    patch_in = params["we"].shape[0]
    with rp.exact_matmul():
        for row, L in zip(rows, launches):
            row.update(follow(env, L))
            row.update(bootstrap(env, L))
            row.update(actor_gaps(params, L, patch_in, env.log_2pi2, control)[0])
    return _rows(rows, per_launch)


def _rows(rows: List[Dict], per_launch: Optional[List[Dict]]) -> Dict[str, float]:
    if per_launch is not None:
        per_launch.extend(rows)
    out: Dict[str, float] = {}
    for row in rows:
        out = worst(out, row)
    return out


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              detail: Optional[Dict] = None) -> float:
    """Widest | |prog leaf| - |ref leaf| | against max(|ref leaf|, median
    |ref leaf|) over ``ref``'s leaves; ``detail`` (optional) gets each
    leaf's (program norm, reference norm, gap)."""
    pn = {k: float(torch.linalg.vector_norm(prog[k].to(F))) for k in ref}
    rn = {k: float(torch.linalg.vector_norm(ref[k].to(F))) for k in ref}
    med = float(torch.tensor(list(rn.values())).median())
    gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in ref}
    if detail is not None:
        detail.update({k: (pn[k], rn[k], gaps[k]) for k in ref})
    return max(gaps.values())


def check_training(cfg: Dict, seed: int, params0: Dict[str, torch.Tensor], start_cols,
                   launches: List[Launch], perms: List[List[torch.Tensor]],
                   prog_losses: List[float], prog_grad: Dict[str, torch.Tensor],
                   prog_params: Dict[str, torch.Tensor], control: bool = False,
                   detail: Optional[Dict] = None,
                   per_launch: Optional[List[Dict]] = None) -> Dict[str, float]:
    """The training cell's numbers over the first iterations: each
    launch's env half, the first launch's actor, and the learner that
    follows the program (the program's frames, actions, rewards and ends;
    its own values and log-probs) through the same shuffles. With
    ``control`` the float8 learner takes the program's place. ``detail``
    (optional) gets the leaves' norms behind ``grad`` and ``change``;
    ``per_launch`` (optional) each launch's numbers, the learner's (which
    the iterations make together) in every one."""
    device = launches[0].cols.device
    env = make_env(cfg, seed, device)
    rows = [{"start": start_gap(cfg, env, seed, start_cols)}] + [{} for _ in launches[1:]]
    patch_in = params0["we"].shape[0]
    with rp.exact_matmul():
        ref = rp.Learner(params0, cfg["ppo"], patch_in)
        ctl = rp.Learner(params0, cfg["ppo"], patch_in, control=True) if control else None
        losses, c_losses = [], []
        for k, (row, L) in enumerate(zip(rows, launches)):
            row.update(follow(env, L))
            row.update(bootstrap(env, L))
            if k == 0:
                row.update(actor_gaps(params0, L, patch_in, env.log_2pi2, control)[0])
            for learner, sink in ((ref, losses), (ctl, c_losses)):
                if learner is None:
                    continue
                w = learner.weights()
                _, log_std, value = rp.actor_batched(w, L.frames, L.proprio, patch_in,
                                                     control=learner.control)
                logp = old_log_prob(L, log_std, env.log_2pi2)
                _, _, last = rp.actor_batched(w, L.boot_pixels, L.boot_proprio, patch_in,
                                              control=learner.control)
                data = {"pixels": L.frames, "proprio": L.proprio.to(F), "action": L.action.to(F),
                        "reward": L.reward.to(F), "done": L.done > 0.5, "log_prob": logp,
                        "value": value, "last_value": last}
                sink.append(learner.iteration(data, perms[k]))
    if control:
        prog_grad, prog_params = ctl.first_grad, ctl.weights()
        prog_losses = [loss for loss, _ in c_losses]
    learner = {"loss": max(abs(p - r) / max(scale, 1e-30)
                           for p, (r, scale) in zip(prog_losses, losses))}
    detail = {} if detail is None else detail
    detail.update(grad={}, change={})
    # no first step taken: the program's optimizer never stepped
    learner["grad"] = (leaf_gaps(prog_grad, ref.first_grad, detail["grad"]) if prog_grad
                       else float("nan"))
    gnorm = {k: float(torch.linalg.vector_norm(v)) for k, v in ref.first_grad.items()}
    med = float(torch.tensor(list(gnorm.values())).median())
    moved = {k for k, v in gnorm.items() if v >= 1e-3 * med}
    ref_w = ref.weights()
    learner["change"] = leaf_gaps({k: prog_params[k].to(F) - params0[k].to(F) for k in moved},
                                  {k: ref_w[k] - params0[k].to(F) for k in moved},
                                  detail["change"])
    for row in rows:
        row.update(learner)
    return _rows(rows, per_launch)
