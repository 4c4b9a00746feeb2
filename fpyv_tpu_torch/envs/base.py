"""Shared helpers for functional envs (mirrors ``fpyv_tpu.envs.base``)."""

from __future__ import annotations

import dataclasses

import torch


def tree_where(pred: torch.Tensor, a, b):
    """Select between two dataclass trees field by field with a (...,)-bool
    predicate that broadcasts against each leaf's leading (env batch) dims;
    used for branch-free auto-reset: ``tree_where(done, reset, live)``."""
    if dataclasses.is_dataclass(a):
        return type(a)(**{f.name: tree_where(pred, getattr(a, f.name), getattr(b, f.name))
                          for f in dataclasses.fields(a)})
    x, y = torch.as_tensor(a), torch.as_tensor(b)
    ndim = max(x.ndim, y.ndim)
    p = pred.reshape(pred.shape + (1,) * (ndim - pred.ndim)) if ndim > pred.ndim else pred
    return torch.where(p, x, y)
