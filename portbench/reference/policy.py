"""Plain float32 reference of the patch actor-critic and of one PPO
iteration, for the K7 and K8 trainers' recipe.

The actor: depth levels / 255 in patch-major order, per patch its K frames
of 64 pixels (oldest first) through ``patch_embed`` and a ReLU, the 108
embeddings and the proprio rows through ``fc0`` and a ReLU, then the mean
and value heads; ``log_std`` is clipped. Weights are in Flax's (in, out)
layout: ``we be wf bf wm bm wv bv log_std``.

Everything runs in float32 with TF32 off (:func:`exact_matmul`). The
control runs the same arithmetic with each product's operands rounded to
float8 (e4m3) under a per-tensor scale: the next precision below the
configuration's bf16.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import torch

F = torch.float32
HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
HALF_LOG_2PIE = 0.5 * math.log(2.0 * math.pi * math.e)
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_matmul():
    """float32 products with TF32 off, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale (gradients
    pass straight through)."""
    s = (x.detach().abs().amax() / FP8_MAX).clamp_min(1e-30)
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(F) * s
    return x + (q - x).detach()


def _mm(a: torch.Tensor, w: torch.Tensor, control: bool) -> torch.Tensor:
    return fp8(a) @ fp8(w) if control else a @ w


def actor(p: Dict[str, torch.Tensor], pixels: torch.Tensor, proprio: torch.Tensor,
          patch_in: int, control: bool = False):
    """(mean (B, 4), clipped log_std (4,), value (B,)) of uint8 pixels (B,
    NP*patch_in) and proprio (B, P)."""
    b = pixels.shape[0]
    x = (pixels.to(F) / torch.tensor(255.0, dtype=F, device=pixels.device)).reshape(
        b, -1, patch_in)
    emb = torch.relu(_mm(x, p["we"], control) + p["be"])
    h = torch.relu(_mm(torch.cat([emb.reshape(b, -1), proprio.to(F)], dim=1), p["wf"], control)
                   + p["bf"])
    mean = _mm(h, p["wm"], control) + p["bm"]
    value = (_mm(h, p["wv"], control) + p["bv"])[:, 0]
    return mean, torch.clamp(p["log_std"], -5.0, 1.5), value


def actor_batched(p, pixels, proprio, patch_in: int, control: bool = False, rows: int = 4096):
    """:func:`actor` over (..., X) inputs in blocks of ``rows``, no grad."""
    lead = pixels.shape[:-1]
    px, pr = pixels.reshape(-1, pixels.shape[-1]), proprio.reshape(-1, proprio.shape[-1])
    means, values = [], []
    with torch.no_grad():
        for i in range(0, px.shape[0], rows):
            m, log_std, v = actor(p, px[i:i + rows], pr[i:i + rows], patch_in, control)
            means.append(m)
            values.append(v)
    return (torch.cat(means).reshape(lead + (4,)), log_std, torch.cat(values).reshape(lead))


def gaussian_log_prob(mean, log_std, action):
    z = (action - mean) / torch.exp(log_std)
    return torch.sum(-0.5 * z ** 2 - log_std - HALF_LOG_2PI, dim=-1)


def gae(rewards, values, dones, last_value, gamma: float, lam: float):
    adv = torch.empty_like(values)
    run = torch.zeros_like(last_value)
    nxt = last_value
    for t in reversed(range(rewards.shape[0])):
        keep = 1.0 - dones[t].to(F)
        run = rewards[t] + gamma * nxt * keep - values[t] + gamma * lam * keep * run
        adv[t] = run
        nxt = values[t]
    return adv, adv + values


class Learner:
    """The PPO learner on its own float32 copy of the weights: GAE, then
    ``update_epochs`` epochs of ``num_minibatches`` Adam steps over
    shuffled blocks of ``shuffle_block`` rows, the clipped surrogate, the
    clipped value loss and the entropy bonus, the gradients clipped to a
    global norm (scaled by ``max_norm / norm`` once the norm reaches it)."""

    def __init__(self, params: Dict[str, torch.Tensor], ppo: Dict, patch_in: int,
                 control: bool = False):
        self.p = {k: v.detach().clone().to(F).requires_grad_(True) for k, v in params.items()}
        self.c, self.patch_in, self.control = ppo, patch_in, control
        self.opt = torch.optim.Adam(list(self.p.values()), lr=ppo["learning_rate"],
                                    eps=ppo["adam_eps"], foreach=False)
        self.first_grad: Optional[Dict[str, torch.Tensor]] = None

    def weights(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in self.p.items()}

    def iteration(self, data: Dict[str, torch.Tensor], perms: List[torch.Tensor]):
        """One iteration's updates on ``data`` (T, N, ...): pixels, proprio,
        action, reward, done, log_prob, value, last_value (N,). Returns the
        mean of the minibatch losses and the mean of their scales, the sum
        of their terms' magnitudes."""
        c = self.c
        adv, tgt = gae(data["reward"], data["value"], data["done"], data["last_value"],
                       c["gamma"], c["gae_lambda"])
        n_rows = adv.numel()
        flat = {k: data[k].reshape((n_rows,) + tuple(data[k].shape[2:]))
                for k in ("pixels", "proprio", "action", "log_prob", "value")}
        flat["adv"], flat["tgt"] = adv.reshape(-1), tgt.reshape(-1)
        mb = n_rows // c["num_minibatches"]
        block = c["shuffle_block"] if n_rows % (c["shuffle_block"] * c["num_minibatches"]) == 0 else 1
        losses, scales = [], []
        for perm in perms:
            perm = perm.to(adv.device)
            sh = {k: v.reshape((n_rows // block, block) + tuple(v.shape[1:]))[perm].reshape(v.shape)
                  for k, v in flat.items()}
            for i in range(c["num_minibatches"]):
                b = {k: v[i * mb:(i + 1) * mb] for k, v in sh.items()}
                loss, scale = self._update(b)
                losses.append(loss)
                scales.append(scale)
        return float(torch.stack(losses).mean()), float(torch.stack(scales).mean())

    def _update(self, b):
        c = self.c
        mean, log_std, value = actor(self.p, b["pixels"], b["proprio"], self.patch_in,
                                     self.control)
        ratio = torch.exp(gaussian_log_prob(mean, log_std, b["action"]) - b["log_prob"])
        adv = (b["adv"] - b["adv"].mean()) / (b["adv"].std(correction=0) + 1e-8)
        eps = c["clip_eps"]
        pg = -torch.mean(torch.minimum(ratio * adv, torch.clamp(ratio, 1.0 - eps, 1.0 + eps) * adv))
        v_clip = b["value"] + torch.clamp(value - b["value"], -eps, eps)
        v_loss = 0.5 * torch.mean(torch.maximum((value - b["tgt"]) ** 2, (v_clip - b["tgt"]) ** 2))
        ent = torch.sum(log_std + HALF_LOG_2PIE)
        loss = pg + c["vf_coef"] * v_loss - c["ent_coef"] * ent
        scale = (pg.abs() + c["vf_coef"] * v_loss.abs() + c["ent_coef"] * ent.abs()).detach()
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for p in self.p.values()]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        if norm >= c["max_grad_norm"]:
            for g in grads:
                g.copy_((g / norm) * c["max_grad_norm"])
        if self.first_grad is None:
            self.first_grad = {k: v.grad.detach().clone() for k, v in self.p.items()}
        self.opt.step()
        return loss.detach(), scale
