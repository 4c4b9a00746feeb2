"""Actor-critics for the PPO learner (mirrors ``fpyv_tpu.models.policy``).

:class:`ActorCritic` is the state-observation net of ``train_acro`` and
``train_race``: a tanh (or relu) MLP torso for the Gaussian mean and a
second one for the value (one shared torso with ``shared_torso``), a free,
clipped ``log_std``, orthogonal initial kernels (scale sqrt(2) in the
torsos, 0.01 for ``pi_mean``, 1 for ``v_out``) and zero biases, every layer
float32.

:class:`PixelActorCritic` with the ``"patch"`` torso: the depth image splits
into 8x8 patches, each embeds through one dense layer, optional pooled
mixing of consecutive patch embeddings, the flattened embeddings and the
proprioceptive vector feed the fc stack, then f32 Gaussian-mean and value
heads with a free, clipped ``log_std``. A ``frame_stack`` of K frames folds
into the patch embed: each frame is split into patches and the K frames of a
patch are concatenated, so the embed contracts K*64 pixels (one frame is
the K = 1 case, with the same parameters and outputs).

Layers are ``nn.Linear`` (weight ``(out, in)``; Flax's kernel is ``(in,
out)``, :mod:`fpyv_tpu_torch.interop` transposes). A layer with
``compute_dtype`` follows Flax's ``Dense(dtype=...)`` exactly: parameters
stay float32; the input, weight and bias are cast to the compute type; the
product is rounded to it, then the bias is added in it. Without a compute
type the layer is float32, product then bias. :meth:`init_params` draws
Flax's initial distributions from a ``torch.Generator``.

The conv torso (the scan rollout's) and the GRU (recurrent PPO's) are not
ported yet (ROADMAP queue 1) and raise.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from fpyv_tpu_torch.device import divisor

# Flax's lecun_normal draws a normal truncated at +-2 std, scaled so the
# truncated variable has the asked std (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def dense(layer: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Flax ``Dense(dtype=dtype)`` on ``x``: product rounded to ``dtype``,
    then the bias added in ``dtype`` (float32 without one)."""
    if dtype is None:
        return torch.matmul(x, layer.weight.T) + layer.bias
    return torch.matmul(x.to(dtype), layer.weight.to(dtype).T) + layer.bias.to(dtype)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's default kernel init on an ``(out, in)`` weight: truncated
    normal with std sqrt(1 / fan_in), drawn by the inverse CDF."""
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    u = torch.rand(weight.shape, generator=generator, dtype=torch.float64,
                   device=generator.device)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
    with torch.no_grad():
        weight.copy_((std * z).to(weight.dtype))


def orthogonal_(weight: torch.Tensor, scale: float, generator: torch.Generator) -> None:
    """Flax's ``orthogonal(scale)`` on an ``(out, in)`` weight: QR of a
    normal matrix, columns sign-corrected by R's diagonal."""
    rows, cols = weight.shape[1], weight.shape[0]  # Flax's (in, out) kernel
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=generator,
                    dtype=torch.float64, device=generator.device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    with torch.no_grad():
        weight.copy_((scale * q).T.to(weight.dtype))


class ActorCritic(nn.Module):
    """Gaussian policy and value heads over a shared or separate MLP torso.

    ``obs_dim`` fixes the first layers' width, which Flax infers at its
    first call. ``forward(obs)`` takes obs (..., O) and returns (mean (...,
    A), clipped log_std (A,), value (...,)). Layers keep Flax's names:
    ``pi_dense{i}``, ``v_dense{i}``, ``pi_mean``, ``v_out`` and ``log_std``.
    """

    def __init__(self, action_dim: int, obs_dim: int, hidden: Sequence[int] = (128, 128),
                 activation: str = "tanh", shared_torso: bool = False,
                 log_std_init: float = -0.5, log_std_min: float = -5.0,
                 log_std_max: float = 1.5, device=None):
        super().__init__()
        if activation not in ("tanh", "relu"):
            raise ValueError(f"activation must be 'tanh' or 'relu', got {activation!r}")
        self.action_dim, self.obs_dim, self.hidden = action_dim, obs_dim, tuple(hidden)
        self.activation, self.shared_torso = activation, shared_torso
        self.log_std_init, self.log_std_min, self.log_std_max = (log_std_init, log_std_min,
                                                                  log_std_max)
        kw = dict(dtype=torch.float32, device=device)
        for torso in ("pi",) if shared_torso else ("pi", "v"):
            width = obs_dim
            for i, h in enumerate(self.hidden):
                self.add_module(f"{torso}_dense{i}", nn.Linear(width, h, **kw))
                width = h
        width = self.hidden[-1] if self.hidden else obs_dim
        self.pi_mean = nn.Linear(width, action_dim, **kw)
        self.v_out = nn.Linear(width, 1, **kw)
        self.log_std = nn.Parameter(torch.full((action_dim,), float(log_std_init), **kw))

    def init_params(self, generator: torch.Generator) -> "ActorCritic":
        """Flax's initial parameters: ``orthogonal(sqrt(2))`` torso kernels,
        ``orthogonal(0.01)`` for ``pi_mean``, ``orthogonal(1)`` for
        ``v_out``, zero biases, ``log_std = log_std_init``."""
        for name, layer in self.named_children():
            scale = {"pi_mean": 0.01, "v_out": 1.0}.get(name, math.sqrt(2.0))
            orthogonal_(layer.weight, scale, generator)
            with torch.no_grad():
                layer.bias.zero_()
        with torch.no_grad():
            self.log_std.fill_(float(self.log_std_init))
        return self

    def _torso(self, x: torch.Tensor, name: str) -> torch.Tensor:
        act = torch.tanh if self.activation == "tanh" else torch.relu
        for i in range(len(self.hidden)):
            x = act(dense(getattr(self, f"{name}_dense{i}"), x, None))
        return x

    def forward(self, obs: torch.Tensor):
        pi_x = self._torso(obs, "pi")
        mean = dense(self.pi_mean, pi_x, None)
        log_std = torch.clamp(self.log_std, self.log_std_min, self.log_std_max)
        v_x = pi_x if self.shared_torso else self._torso(obs, "v")
        value = dense(self.v_out, v_x, None)[..., 0]
        return mean, log_std, value


class PixelActorCritic(nn.Module):
    """Patch torso over depth images + Gaussian policy and value heads.

    ``n_patches`` (``(H/8)*(W/8)``), ``proprio_dim`` and ``frame_stack``
    fix the layer widths that Flax infers at its first call.
    ``forward(pixels, proprio)`` takes pixels (..., H, W), a stack
    (..., K, H, W) of ``frame_stack`` frames (newest last), or (...,
    n_patches, K*64) with ``prepatched=True`` (patch-stack-major order, as
    the in-kernel rollouts emit them), in [0, 1] float or as uint8 levels
    (divided by 255 through float32); proprio (..., P). Returns (mean (...,
    A), clipped log_std (A,), value (...,)).
    """

    def __init__(self, action_dim: int, n_patches: int, proprio_dim: int = 5,
                 hidden: Sequence[int] = (256,), log_std_init: float = -0.5,
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16, torso: str = "conv",
                 patch: int = 8, embed: int = 128, prepatched: bool = False,
                 patch_pool: int = 1, gru: int = 0, log_std_min: float = -5.0,
                 log_std_max: float = 1.5, frame_stack: int = 1, device=None):
        super().__init__()
        if torso != "patch":
            raise ValueError(f"torso={torso!r} is not ported yet (ROADMAP queue 1: the conv "
                             "torso rides with the scan rollout); use torso='patch'")
        if gru:
            raise ValueError("gru > 0 is not ported yet (ROADMAP queue 1: recurrent PPO)")
        if patch_pool < 1 or n_patches % patch_pool:
            raise ValueError(f"patch_pool={patch_pool} must divide n_patches={n_patches}")
        self.action_dim, self.n_patches, self.proprio_dim = action_dim, n_patches, proprio_dim
        self.hidden = tuple(hidden)
        self.compute_dtype = compute_dtype
        self.torso, self.patch, self.embed = torso, patch, embed
        self.prepatched, self.patch_pool, self.gru = prepatched, patch_pool, gru
        self.frame_stack = frame_stack
        self.log_std_init, self.log_std_min, self.log_std_max = (log_std_init, log_std_min,
                                                                  log_std_max)
        kw = dict(dtype=torch.float32, device=device)
        self.patch_embed = nn.Linear(frame_stack * patch * patch, embed, **kw)
        if patch_pool > 1:
            self.patch_pool_layer = nn.Linear(patch_pool * embed, embed, **kw)
        width = (n_patches // patch_pool) * embed + proprio_dim
        for i, h in enumerate(self.hidden):
            self.add_module(f"fc{i}", nn.Linear(width, h, **kw))
            width = h
        self.pi_mean = nn.Linear(width, action_dim, **kw)
        self.v_out = nn.Linear(width, 1, **kw)
        self.log_std = nn.Parameter(torch.full((action_dim,), float(log_std_init), **kw))

    # Flax names the pool layer "patch_pool", the config field's name here
    def _named_layers(self):
        yield "patch_embed", self.patch_embed
        if self.patch_pool > 1:
            yield "patch_pool", self.patch_pool_layer
        for i in range(len(self.hidden)):
            yield f"fc{i}", getattr(self, f"fc{i}")
        yield "pi_mean", self.pi_mean
        yield "v_out", self.v_out

    def init_params(self, generator: torch.Generator) -> "PixelActorCritic":
        """Flax's initial parameters: lecun_normal kernels and zero biases,
        ``orthogonal(0.01)`` for ``pi_mean``, ``log_std = log_std_init``."""
        for name, layer in self._named_layers():
            if name == "pi_mean":
                orthogonal_(layer.weight, 0.01, generator)
            else:
                lecun_normal_(layer.weight, generator)
            with torch.no_grad():
                layer.bias.zero_()
        with torch.no_grad():
            self.log_std.fill_(float(self.log_std_init))
        return self

    def patchify(self, pixels: torch.Tensor, stacked: bool = False) -> torch.Tensor:
        """(..., H, W) -> (..., NP, patch^2), patches row-major over the
        (H/p, W/p) grid, pixels row-major within each patch; with
        ``stacked``, (..., K, H, W) -> (..., NP, K*patch^2), a patch's K
        frames concatenated, oldest first."""
        if not stacked:
            pixels = pixels[..., None, :, :]
        p = self.patch
        K, H, W = pixels.shape[-3], pixels.shape[-2], pixels.shape[-1]
        if H % p or W % p:
            raise ValueError(f"patch torso needs H and W divisible by patch={p}, got {H}x{W}")
        lead = pixels.shape[:-3]
        x = pixels.reshape(lead + (K, H // p, p, W // p, p)).movedim(-3, -2)
        x = x.reshape(lead + (K, (H // p) * (W // p), p * p)).movedim(-3, -2)
        return x.reshape(lead + ((H // p) * (W // p), K * p * p))

    def forward(self, pixels: torch.Tensor, proprio: torch.Tensor):
        dt = self.compute_dtype
        if pixels.dtype == torch.uint8:
            # via float32 true division, as the kernel's policy input
            pixels = pixels.to(torch.float32) / divisor(255.0, pixels)
        if self.prepatched:
            x = pixels
        else:
            x = self.patchify(pixels, stacked=pixels.ndim >= 3 and proprio.ndim + 1 < pixels.ndim)
        lead = x.shape[:-2]
        if dt is not None:
            x = x.to(dt)
        x = torch.relu(dense(self.patch_embed, x, dt))
        if self.patch_pool > 1:
            NP = x.shape[-2]
            x = x.reshape(lead + (NP // self.patch_pool, self.patch_pool * self.embed))
            x = torch.relu(dense(self.patch_pool_layer, x, dt))
        x = x.reshape(lead + (-1,))
        x = torch.cat([x, proprio.to(x.dtype)], dim=-1)
        for i in range(len(self.hidden)):
            x = torch.relu(dense(getattr(self, f"fc{i}"), x, dt))
        x = x.to(torch.float32)  # heads in float32
        mean = dense(self.pi_mean, x, None)
        log_std = torch.clamp(self.log_std, self.log_std_min, self.log_std_max)
        value = dense(self.v_out, x, None)[..., 0]
        return mean, log_std, value
