"""Numerical-health guards over state trees (mirrors ``fpyv_tpu.utils.debug``).

Use :func:`finite_mask` inside a rollout (per-env health flags with no host
read — a poisoned env can be auto-reset like a crash) and
:func:`assert_finite` on the host at iteration boundaries (raises with the
offending leaves' paths). Trees are the port's dataclasses, dicts, lists
and tuples (``envs.base.tree_map_tensors``' rules); a leaf's path reads as
``jax.tree_util.keystr`` writes it (``.drone.pos``, ``['a']``, ``[0]``, dict
keys sorted), so the messages read the same in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, List, Tuple

import numpy as np
import torch


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) in JAX's flattening order: dataclass fields in order,
    dict keys sorted, sequences by index; None is an empty subtree."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def finite_mask(tree: Any, batch_ndim: int = 1) -> torch.Tensor:
    """(...,)-bool per-env health flags: True where EVERY floating tensor
    leaf is finite. Leaves are reduced over all but their first
    ``batch_ndim`` axes; other leaves count as healthy. Stays on the
    leaves' device."""
    leaves = [l for _, l in _leaves(tree)
              if isinstance(l, torch.Tensor) and l.is_floating_point()]
    if not leaves:
        raise ValueError("tree has no floating leaves")
    ok = torch.ones(leaves[0].shape[:batch_ndim], dtype=torch.bool, device=leaves[0].device)
    for l in leaves:
        fin = torch.isfinite(l)
        ok = ok & (fin.flatten(batch_ndim).all(-1) if l.ndim > batch_ndim else fin)
    return ok


def assert_finite(tree: Any, name: str = "tree") -> None:
    """Host-side check: raises FloatingPointError naming every non-finite
    floating leaf (tensors, numpy arrays and Python floats)."""
    bad: List[Tuple[str, int]] = []
    for path, leaf in _leaves(tree):
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        if arr.dtype.kind == "f":
            n_bad = int((~np.isfinite(arr)).sum())
            if n_bad:
                bad.append((path, n_bad))
    if bad:
        detail = ", ".join(f"{p} ({n} values)" for p, n in bad)
        raise FloatingPointError(f"non-finite values in {name}: {detail}")
