"""Minimal functional NN modules, the successor of the reference's
hand-rolled NumPy micro-framework (src/utils/nn.py: Module/Parameter/
Linear/activations/Attention/Sequential with manual backward passes);
mirrors ``fpyv_tpu.models.nn``.

Modules are (init, apply) pairs over dicts of tensors, as JAX's are over
pytrees; autograd differentiates the forward. The RL networks are
``nn.Module``s (:mod:`fpyv_tpu_torch.models.policy`); this module serves
the terrain generator and is the counterpart of the reference's nn.py.

Parity notes:
- ``linear_init`` matches nn.py:51-52: standard-normal weights AND biases
  (times ``scale``, 1 by default), drawn from a ``torch.Generator`` through
  :func:`linear_draws`: the weight's draw, then the bias's;
- ``attention`` matches nn.py:150-163: softmax(q kᵀ / sqrt(d)) v, returning
  (output, attention weights). Its float32 products reach cuBLAS on the
  card, where PyTorch's default keeps TF32 off
  (``torch.backends.cuda.matmul.allow_tf32``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from fpyv_tpu_torch.device import resolve_device

Params = dict


def linear_draws(generator: torch.Generator, in_features: int, out_features: int, dtype,
                 device):
    """A linear layer's standard normal draws: the weight (in, out), then
    the bias (out,)."""
    w = torch.randn((in_features, out_features), generator=generator, dtype=dtype,
                    device=generator.device)
    b = torch.randn((out_features,), generator=generator, dtype=dtype, device=generator.device)
    return w.to(device), b.to(device)


def linear_init(generator: torch.Generator, in_features: int, out_features: int,
                scale: float = 1.0, dtype=torch.float32, device=None) -> Params:
    """N(0,1)·scale weights and biases (nn.py:51-52 uses scale=1), on
    ``device`` (CUDA unless told)."""
    w, b = linear_draws(generator, in_features, out_features, dtype, resolve_device(device))
    return {"weight": scale * w, "bias": scale * b}


def linear_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["weight"] + params["bias"]


# activations (nn.py:70-147)
relu = torch.relu
sin = torch.sin
cos = torch.cos
tanh = torch.tanh
sigmoid = torch.sigmoid


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Softmax attention (nn.py:150-163). q, k, v: (..., L, D)."""
    d = q.shape[-1]
    logits = (q @ k.transpose(-1, -2)) / torch.sqrt(torch.tensor(d, dtype=q.dtype,
                                                                 device=q.device))
    weights = torch.softmax(logits, dim=-1)
    return weights @ v, weights


def mlp_init(generator: torch.Generator, sizes: Sequence[int], scale: float = 1.0,
             dtype=torch.float32, device=None) -> List[Params]:
    """One :func:`linear_init` a layer, drawn layer by layer."""
    device = resolve_device(device)
    return [linear_init(generator, sizes[i], sizes[i + 1], scale, dtype, device)
            for i in range(len(sizes) - 1)]


def mlp_apply(params: List[Params], x: torch.Tensor, activation: Callable = tanh,
              final_activation: Optional[Callable] = None) -> torch.Tensor:
    """Sequential Linear/activation stack (nn.py:176-200's Sequential), with
    no activation after the last layer (terrainn.py:16 deletes the last one)."""
    for i, p in enumerate(params):
        x = linear_apply(p, x)
        if i < len(params) - 1:
            x = activation(x)
        elif final_activation is not None:
            x = final_activation(x)
    return x


def binarize(w: torch.Tensor) -> torch.Tensor:
    """Sign-binarize weights to ±1 with a straight-through estimator: the
    forward is ±1 (0 maps to +1), the gradient passes through unchanged
    (tests/nn_1bit_weights.py's ±1-weight experiment, made trainable)."""
    binary = torch.where(w >= 0, 1.0, -1.0).to(w.dtype)
    return w + (binary - w).detach()


def binary_linear_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Linear layer with ±1 (binarized) weights, full-precision bias."""
    return x @ binarize(params["weight"]) + params["bias"]
