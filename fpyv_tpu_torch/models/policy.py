"""Actor-critics for the PPO learner, and SAC's actor and critic (mirrors
``fpyv_tpu.models.policy``).

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

The ``"conv"`` torso: three 3x3, stride-2 convolutions of ``channels``
(16, 32, 32) with ReLU, a K-frame stack as K input channels, then the same
fc stack and heads. Flax pads ``"SAME"`` asymmetrically at stride 2 (an even
side gets 0 before and 1 after, an odd side 1 on each side), so the pads are
computed per side and applied with ``F.pad``; the features are flattened in
Flax's NHWC order (h, w, c), so fc0's rows follow Flax's.

Flax's layers sum in float32 and round once. On the card the pixel net
runs its forward pass, and the learner its backward pass, inside
:meth:`PixelActorCritic.numerics`: cuBLAS's bf16 reduced-precision
reductions (its default, which lets split-K partial sums round to bf16)
and cuDNN's TF32 (its default for float32 convolutions) are off there, and
only there.

``gru > 0`` puts Flax's ``GRUCell`` between the torso and the heads, in
float32: ``r = sigmoid(W_ir x + b_ir + W_hr h)``, ``z = sigmoid(W_iz x +
b_iz + W_hz h)``, ``n = tanh(W_in x + b_in + r * (W_hn h + b_hn))``, ``h' =
(1 - z) n + z h``. It is six ``nn.Linear``s named as Flax's (``hr`` and
``hz`` without a bias), not ``torch.nn.GRUCell``, which adds biases to the
recurrent gates.

:class:`SquashedGaussianActor` and :class:`TwinQNetwork` are SAC's nets:
ReLU MLPs with Flax's default init (lecun_normal kernels, zero biases), the
actor's ``log_std`` a Dense layer clipped to [-10, 2], the critic two
independent Q heads over ``[obs, action]``. :func:`actor_mean_batched` runs
``ActorCritic``'s mean for a batch of parameter sets at once (the ES
trainer's candidates).

Layers are ``nn.Linear`` (weight ``(out, in)``; Flax's kernel is ``(in,
out)``, :mod:`fpyv_tpu_torch.interop` transposes) and ``nn.Conv2d`` (OIHW;
Flax's HWIO). A layer with ``compute_dtype`` follows Flax's
``Dense(dtype=...)`` and ``Conv(dtype=...)`` exactly: parameters stay
float32; the input, weight and bias are cast to the compute type; the
product is rounded to it, then the bias is added in it. Without a compute
type the layer is float32, product then bias. :meth:`init_params` draws
Flax's initial distributions from a ``torch.Generator``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fpyv_tpu_torch.ops.levels_kernel import levels_as

# Flax's lecun_normal draws a normal truncated at +-2 std, scaled so the
# truncated variable has the asked std (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def dense(layer: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Flax ``Dense(dtype=dtype)`` on ``x``: product rounded to ``dtype``,
    then the bias added in ``dtype`` (float32 without one)."""
    if dtype is None:
        return torch.matmul(x, layer.weight.T) + layer.bias
    return torch.matmul(x.to(dtype), layer.weight.to(dtype).T) + layer.bias.to(dtype)


def same_pads(size: int, kernel: int = 3, stride: int = 2) -> Tuple[int, int]:
    """Flax's (XLA's) ``"SAME"`` padding of one side: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


@contextlib.contextmanager
def flax_reductions():
    """Inside the scope only: cuBLAS sums bf16 products in float32 (no bf16
    reduced-precision split-K reductions) and cuDNN's float32 convolutions
    run without TF32, so a layer rounds once, after a float32 sum, as
    Flax's ``Dense`` and ``Conv`` do."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = (matmul.allow_bf16_reduced_precision_reduction, cudnn.allow_tf32)
    matmul.allow_bf16_reduced_precision_reduction, cudnn.allow_tf32 = False, False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction, cudnn.allow_tf32 = prev


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's default kernel init on an ``(out, in)`` weight, or a conv's
    ``(out, in, kh, kw)`` one: truncated normal with std sqrt(1 / fan_in),
    fan_in = in * kh * kw, drawn by the inverse CDF."""
    fan_in = math.prod(weight.shape[1:])
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
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


class GRUCell(nn.Module):
    """Flax's ``GRUCell`` (flax 0.12.3) in float32: input layers ``ir``,
    ``iz``, ``in`` with biases, recurrent layers ``hr``, ``hz`` without and
    ``hn`` with one (inside ``r * (...)``). ``forward(h, x) -> h'``."""

    def __init__(self, in_dim: int, features: int, device=None):
        super().__init__()
        kw = dict(dtype=torch.float32, device=device)
        for name in ("ir", "iz", "in"):
            self.add_module(name, nn.Linear(in_dim, features, **kw))
        for name in ("hr", "hz"):
            self.add_module(name, nn.Linear(features, features, bias=False, **kw))
        self.hn = nn.Linear(features, features, **kw)

    def init_params(self, generator: torch.Generator) -> None:
        """lecun_normal input kernels, orthogonal recurrent kernels, zero biases."""
        for name, layer in self.named_children():
            if name.startswith("i"):
                lecun_normal_(layer.weight, generator)
            else:
                orthogonal_(layer.weight, 1.0, generator)
            if layer.bias is not None:
                with torch.no_grad():
                    layer.bias.zero_()

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        def lin(name, v):
            layer = getattr(self, name)
            out = torch.matmul(v, layer.weight.T)
            return out if layer.bias is None else out + layer.bias

        r = torch.sigmoid(lin("ir", x) + lin("hr", h))
        z = torch.sigmoid(lin("iz", x) + lin("hz", h))
        n = torch.tanh(lin("in", x) + r * lin("hn", h))
        return (1.0 - z) * n + z * h


class PixelActorCritic(nn.Module):
    """Image torso over depth images (+ an optional GRU) + Gaussian policy
    and value heads.

    ``n_patches`` (``(H/8)*(W/8)``, the patch torso's), ``image_hw`` ((H, W),
    the conv torso's), ``proprio_dim`` and ``frame_stack`` fix the layer
    widths that Flax infers at its first call. ``forward(pixels, proprio)``
    takes pixels (..., H, W), a stack (..., K, H, W) of ``frame_stack``
    frames (newest last), or (..., n_patches, K*64) with ``prepatched=True``
    (patch-stack-major order, as the in-kernel rollouts emit them), in [0, 1]
    float or as uint8 levels (divided by 255 through float32, in one
    levels_lut pass on the card); proprio (...,
    P). Returns (mean (..., A), clipped log_std (A,), value (...,)); with
    ``gru > 0`` ``forward(pixels, proprio, hidden)`` takes hidden (...,
    gru) and returns (mean, log_std, value, hidden').
    """

    def __init__(self, action_dim: int, n_patches: int = 0, proprio_dim: int = 5,
                 hidden: Sequence[int] = (256,), log_std_init: float = -0.5,
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16, torso: str = "conv",
                 patch: int = 8, embed: int = 128, prepatched: bool = False,
                 patch_pool: int = 1, gru: int = 0, log_std_min: float = -5.0,
                 log_std_max: float = 1.5, frame_stack: int = 1,
                 image_hw: Optional[Tuple[int, int]] = None,
                 channels: Sequence[int] = (16, 32, 32), device=None):
        super().__init__()
        if torso not in ("patch", "conv"):
            raise ValueError(f"torso must be 'patch' or 'conv', got {torso!r}")
        if torso == "conv" and (prepatched or image_hw is None):
            raise ValueError("torso='conv' needs image_hw=(H, W) and no prepatched pixels")
        if torso == "patch" and (patch_pool < 1 or n_patches % patch_pool):
            raise ValueError(f"patch_pool={patch_pool} must divide n_patches={n_patches}")
        self.action_dim, self.n_patches, self.proprio_dim = action_dim, n_patches, proprio_dim
        self.hidden = tuple(hidden)
        self.compute_dtype = compute_dtype
        self.torso, self.patch, self.embed = torso, patch, embed
        self.prepatched, self.patch_pool, self.gru = prepatched, patch_pool, gru
        self.frame_stack, self.image_hw, self.channels = frame_stack, image_hw, tuple(channels)
        self.log_std_init, self.log_std_min, self.log_std_max = (log_std_init, log_std_min,
                                                                  log_std_max)
        kw = dict(dtype=torch.float32, device=device)
        if torso == "patch":
            self.patch_embed = nn.Linear(frame_stack * patch * patch, embed, **kw)
            if patch_pool > 1:
                self.patch_pool_layer = nn.Linear(patch_pool * embed, embed, **kw)
            width = (n_patches // patch_pool) * embed + proprio_dim
        else:
            h, w, c = image_hw[0], image_hw[1], frame_stack
            for i, ch in enumerate(self.channels):
                self.add_module(f"conv{i}", nn.Conv2d(c, ch, 3, stride=2, **kw))
                h, w, c = -(-h // 2), -(-w // 2), ch
            width = h * w * c + proprio_dim
        for i, hdim in enumerate(self.hidden):
            self.add_module(f"fc{i}", nn.Linear(width, hdim, **kw))
            width = hdim
        if gru:
            self.gru_cell = GRUCell(width, gru, device=device)
            width = gru
        self.pi_mean = nn.Linear(width, action_dim, **kw)
        self.v_out = nn.Linear(width, 1, **kw)
        self.log_std = nn.Parameter(torch.full((action_dim,), float(log_std_init), **kw))
        # uint8 levels are divided by this float32 255 on the net's device
        # (levels_kernel.levels_as; on the card its table holds the same
        # quotients): a true division (the kernels'; CUDA multiplies by the
        # reciprocal of a Python scalar), made here once, so a forward copies
        # nothing from the host and can be captured in a CUDA graph; not in
        # the state dict
        self.register_buffer("level_scale", torch.tensor(255.0, **kw), persistent=False)

    # Flax names the pool layer "patch_pool" and the cell "gru", the config
    # fields' names here
    def _named_layers(self):
        if self.torso == "patch":
            yield "patch_embed", self.patch_embed
            if self.patch_pool > 1:
                yield "patch_pool", self.patch_pool_layer
        else:
            for i in range(len(self.channels)):
                yield f"conv{i}", getattr(self, f"conv{i}")
        for i in range(len(self.hidden)):
            yield f"fc{i}", getattr(self, f"fc{i}")
        yield "pi_mean", self.pi_mean
        yield "v_out", self.v_out

    def init_params(self, generator: torch.Generator) -> "PixelActorCritic":
        """Flax's initial parameters: lecun_normal kernels and zero biases,
        ``orthogonal(0.01)`` for ``pi_mean``, the GRU's own (lecun_normal
        inputs, orthogonal recurrent kernels), ``log_std = log_std_init``."""
        for name, layer in self._named_layers():
            if name == "pi_mean":
                orthogonal_(layer.weight, 0.01, generator)
            else:
                lecun_normal_(layer.weight, generator)
            with torch.no_grad():
                layer.bias.zero_()
        if self.gru:
            self.gru_cell.init_params(generator)
        with torch.no_grad():
            self.log_std.fill_(float(self.log_std_init))
        return self

    def numerics(self):
        """The scope of the net's layers (:func:`flax_reductions`); the
        forward pass runs in it, and the learner runs the backward pass in
        it too."""
        return flax_reductions()

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

    def _conv_torso(self, pixels: torch.Tensor, dt) -> torch.Tensor:
        """(..., K, H, W) -> the flattened (..., h*w*c) features, NHWC order."""
        lead = pixels.shape[:-3]
        x = pixels.reshape((-1,) + tuple(pixels.shape[-3:]))
        if dt is not None:
            x = x.to(dt)
        for i in range(len(self.channels)):
            layer = getattr(self, f"conv{i}")
            (t, b), (lft, r) = same_pads(x.shape[-2]), same_pads(x.shape[-1])
            x = F.pad(x, (lft, r, t, b))
            w = layer.weight if dt is None else layer.weight.to(dt)
            x = F.conv2d(x, w, stride=2)
            x = x + (layer.bias if dt is None else layer.bias.to(dt))[:, None, None]
            x = torch.relu(x)
        return x.permute(0, 2, 3, 1).reshape(lead + (-1,))

    def forward(self, pixels: torch.Tensor, proprio: torch.Tensor,
                hidden: Optional[torch.Tensor] = None):
        with self.numerics():
            return self.heads(self.features(pixels, proprio), hidden)

    def features(self, pixels: torch.Tensor, proprio: torch.Tensor) -> torch.Tensor:
        """The torso and the fc stack: (..., hidden[-1]) in the compute
        dtype, the heads' input."""
        dt = self.compute_dtype
        if pixels.dtype == torch.uint8:
            # dt(float32(u) / 255), as the kernel's policy input: on the card
            # one levels_lut pass into the dtype the torso reads
            pixels = levels_as(pixels.contiguous(), dt or torch.float32, self.level_scale)
        if self.torso == "conv":
            if pixels.ndim < 3 or proprio.ndim + 1 >= pixels.ndim:
                pixels = pixels[..., None, :, :]  # one frame: K = 1 channel
            x = self._conv_torso(pixels, dt)
        else:
            if self.prepatched:
                x = pixels
            else:
                x = self.patchify(pixels,
                                  stacked=pixels.ndim >= 3 and proprio.ndim + 1 < pixels.ndim)
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
        return x

    def heads(self, x: torch.Tensor, hidden: Optional[torch.Tensor] = None):
        """Flax's ``_heads``: the GRU (with ``gru > 0``) and the Gaussian
        policy and value heads, all in float32."""
        x = x.to(torch.float32)
        if self.gru:
            hidden = self.gru_cell(hidden, x)
            x = hidden
        mean = dense(self.pi_mean, x, None)
        log_std = torch.clamp(self.log_std, self.log_std_min, self.log_std_max)
        value = dense(self.v_out, x, None)[..., 0]
        if self.gru:
            return mean, log_std, value, hidden
        return mean, log_std, value


def _lecun_init(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's default Dense init on every layer: lecun_normal kernels, zero
    biases."""
    for layer in module.children():
        lecun_normal_(layer.weight, generator)
        with torch.no_grad():
            layer.bias.zero_()


class SquashedGaussianActor(nn.Module):
    """SAC's tanh-squashed Gaussian policy: a ReLU MLP (``dense{i}``), then
    a ``mean`` layer and a ``log_std`` layer (a Dense layer here, not a free
    parameter), clipped to [``log_std_min``, ``log_std_max``].
    ``forward(obs)`` takes obs (..., O) and returns (mean, log_std), each
    (..., A)."""

    def __init__(self, action_dim: int, obs_dim: int, hidden: Sequence[int] = (128, 128),
                 log_std_min: float = -10.0, log_std_max: float = 2.0, device=None):
        super().__init__()
        self.action_dim, self.obs_dim, self.hidden = action_dim, obs_dim, tuple(hidden)
        self.log_std_min, self.log_std_max = log_std_min, log_std_max
        kw = dict(dtype=torch.float32, device=device)
        width = obs_dim
        for i, h in enumerate(self.hidden):
            self.add_module(f"dense{i}", nn.Linear(width, h, **kw))
            width = h
        self.mean = nn.Linear(width, action_dim, **kw)
        self.log_std = nn.Linear(width, action_dim, **kw)

    def init_params(self, generator: torch.Generator) -> "SquashedGaussianActor":
        _lecun_init(self, generator)
        return self

    def forward(self, obs: torch.Tensor):
        x = obs
        for i in range(len(self.hidden)):
            x = torch.relu(dense(getattr(self, f"dense{i}"), x, None))
        log_std = torch.clamp(dense(self.log_std, x, None), self.log_std_min, self.log_std_max)
        return dense(self.mean, x, None), log_std


class TwinQNetwork(nn.Module):
    """SAC's critic: two independent ReLU MLPs over ``[obs, action]``
    (``q1_dense{i}``, ``q1_out``; ``q2_dense{i}``, ``q2_out``).
    ``forward(obs, action)`` returns (q1, q2), each (...,)."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: Sequence[int] = (128, 128),
                 device=None):
        super().__init__()
        self.obs_dim, self.action_dim, self.hidden = obs_dim, action_dim, tuple(hidden)
        kw = dict(dtype=torch.float32, device=device)
        for q in ("q1", "q2"):
            width = obs_dim + action_dim
            for i, h in enumerate(self.hidden):
                self.add_module(f"{q}_dense{i}", nn.Linear(width, h, **kw))
                width = h
            self.add_module(f"{q}_out", nn.Linear(width, 1, **kw))

    def init_params(self, generator: torch.Generator) -> "TwinQNetwork":
        _lecun_init(self, generator)
        return self

    def _q(self, x: torch.Tensor, name: str) -> torch.Tensor:
        for i in range(len(self.hidden)):
            x = torch.relu(dense(getattr(self, f"{name}_dense{i}"), x, None))
        return dense(getattr(self, f"{name}_out"), x, None)[..., 0]

    def forward(self, obs: torch.Tensor, action: torch.Tensor):
        x = torch.cat([obs, action], dim=-1)
        return self._q(x, "q1"), self._q(x, "q2")


def actor_mean_batched(params: dict, obs: torch.Tensor, activation: str = "tanh") -> torch.Tensor:
    """``ActorCritic``'s Gaussian mean for B parameter sets at once: the
    Flax tree ``params`` (``pi_dense{i}`` and ``pi_mean``, each ``kernel``
    (B, in, out) and ``bias`` (B, out), as ``interop.unravel_params`` gives
    them) over obs (B, N, O) -> (B, N, A). One batched product a layer, the
    bias added after it, as Flax's Dense."""
    act = torch.tanh if activation == "tanh" else torch.relu
    p = params.get("params", params)
    x, i = obs, 0
    while f"pi_dense{i}" in p:
        layer = p[f"pi_dense{i}"]
        x = act(torch.bmm(x, layer["kernel"]) + layer["bias"][:, None, :])
        i += 1
    return torch.bmm(x, p["pi_mean"]["kernel"]) + p["pi_mean"]["bias"][:, None, :]
