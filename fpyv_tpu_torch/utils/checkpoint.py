"""Checkpoint and resume of the full training state (mirrors
``fpyv_tpu.utils.checkpoint``, with ``torch.save`` in place of orbax).

A state is any tree of dataclasses, dicts, lists and tuples whose leaves are
tensors, numbers, ``nn.Module``s, optimizers and ``torch.Generator``s,
typically a :class:`~fpyv_tpu_torch.rl.ppo.PpoState`: the policy, Adam's
state, the env matrix, the last observation, the update count and the
generator. A module, an optimizer and a generator are saved by their state;
restoring into a template loads them in place, so a resumed run continues
exactly as an unbroken one.

A distributed trainer's state is sharded: each rank saves its own shard,
``step_N.rank{r}of{W}.pt``, where a single process saves ``step_N.pt``. A
step counts once all W shards are there, and resuming needs the world size
the shards were saved at.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Any, Optional, Tuple

import torch


def _to_tree(x):
    if isinstance(x, torch.nn.Module) or isinstance(x, torch.optim.Optimizer):
        return _to_tree(x.state_dict())
    if isinstance(x, torch.Generator):
        return x.get_state()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if dataclasses.is_dataclass(x):
        return {f.name: _to_tree(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _to_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_tree(v) for v in x)
    return x


def _load_into(template, tree):
    if isinstance(template, (torch.nn.Module, torch.optim.Optimizer)):
        template.load_state_dict(tree)
        return template
    if isinstance(template, torch.Generator):
        template.set_state(tree)
        return template
    if isinstance(template, torch.Tensor):
        return tree.to(device=template.device, dtype=template.dtype)
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _load_into(getattr(template, f.name), tree[f.name])
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: _load_into(v, tree[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_load_into(t, v) for t, v in zip(template, tree))
    return tree


_NAME = re.compile(r"step_(\d+)(?:\.rank(\d+)of(\d+))?\.pt")


def _path(directory, step: int, shard: Optional[Tuple[int, int]] = None) -> Path:
    name = f"step_{step:010d}" + ("" if shard is None else ".rank{}of{}".format(*shard))
    return Path(directory).absolute() / f"{name}.pt"


def save_checkpoint(directory, step: int, state: Any,
                    shard: Optional[Tuple[int, int]] = None) -> Path:
    """Save ``state`` as directory/step_{step}.pt, or as rank r's shard of
    W, step_{step}.rank{r}of{W}.pt, with ``shard=(r, W)``. Overwrites."""
    path = _path(directory, step, shard)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    torch.save(_to_tree(state), tmp)
    tmp.replace(path)
    return path


def latest_step(directory, world_size: Optional[int] = None) -> Optional[int]:
    """The latest step saved by one process (``world_size`` None), or the
    latest for which all ``world_size`` shards are there. Raises when the
    directory holds checkpoints saved at another world size."""
    d = Path(directory)
    if not d.exists():
        return None
    shards: dict = {}
    for p in d.glob("step_*.pt"):
        m = _NAME.fullmatch(p.name)
        if m is None:
            continue
        w = None if m.group(3) is None else int(m.group(3))
        if w != world_size:
            raise ValueError(f"{directory} holds checkpoints saved "
                             f"{'by one process' if w is None else f'by {w} ranks'}; "
                             "resuming needs the world size they were saved at")
        shards.setdefault(int(m.group(1)), set()).add(None if w is None else int(m.group(2)))
    whole = set(range(world_size)) if world_size is not None else {None}
    steps = sorted(s for s, ranks in shards.items() if ranks == whole)
    return steps[-1] if steps else None


def restore_checkpoint(directory, step: Optional[int] = None, template: Any = None,
                       shard: Optional[Tuple[int, int]] = None) -> Any:
    """Restore the given (or latest) step, rank r's shard of W with
    ``shard=(r, W)``: into ``template`` (a state of the same structure,
    whose modules, optimizers and generators are loaded in place), or as the
    saved tree of CPU tensors without one."""
    if step is None:
        step = latest_step(directory, None if shard is None else shard[1])
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    tree = torch.load(_path(directory, step, shard), map_location="cpu", weights_only=True)
    return tree if template is None else _load_into(template, tree)
