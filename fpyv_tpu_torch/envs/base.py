"""Shared helpers for functional envs (mirrors ``fpyv_tpu.envs.base``)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

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


class Part(NamedTuple):
    """Rows ``[lo, hi)`` of the leading axis of an ``n``-row env bank: one
    rank's slice under ``torch.distributed``. A draw shaped like the bank is
    made at the whole bank's shape and sliced, so a rank consumes its
    generator as one process stepping the whole bank would, and the bank's
    trajectories do not depend on how many ranks share it."""

    lo: int
    hi: int
    n: int


def draw_shape(batch_shape, part: Optional[Part]) -> tuple:
    """The shape a bank-shaped draw is made at: ``batch_shape`` itself, or
    with its leading axis widened to the whole bank under ``part``."""
    batch_shape = tuple(batch_shape)
    return batch_shape if part is None else (part.n,) + batch_shape[1:]


def tree_map_tensors(fn, tree):
    """``fn`` on every tensor of a tree of dataclasses, dicts, lists and
    tuples; other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: tree_map_tensors(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: tree_map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_tensors(fn, v) for v in tree)
    return tree


def take_part(tree, part: Optional[Part]):
    """Every tensor's rows ``[part.lo, part.hi)`` (the whole tree when
    ``part`` is None)."""
    if part is None:
        return tree
    return tree_map_tensors(lambda x: x[part.lo:part.hi], tree)


def default_generator(device: torch.device) -> torch.Generator:
    """The default generator of ``device``: an env's draws when the caller
    passes none."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.default_generators[device.index or 0]
    return torch.default_generator
