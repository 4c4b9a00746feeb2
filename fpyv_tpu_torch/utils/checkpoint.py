"""Checkpoint and resume of the full training state (mirrors
``fpyv_tpu.utils.checkpoint``, with ``torch.save`` in place of orbax).

A state is any tree of dataclasses, dicts, lists and tuples whose leaves are
tensors, numbers, ``nn.Module``s, optimizers and ``torch.Generator``s,
typically a :class:`~fpyv_tpu_torch.rl.ppo.PpoState`: the policy, Adam's
state, the env matrix, the last observation, the update count and the
generator. A module, an optimizer and a generator are saved by their state;
restoring into a template loads them in place, so a resumed run continues
exactly as an unbroken one.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Optional

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


def _path(directory, step: int) -> Path:
    return Path(directory).absolute() / f"step_{step:010d}.pt"


def save_checkpoint(directory, step: int, state: Any) -> Path:
    """Save ``state`` as directory/step_{step}.pt. Overwrites that step."""
    path = _path(directory, step)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    torch.save(_to_tree(state), tmp)
    tmp.replace(path)
    return path


def latest_step(directory) -> Optional[int]:
    d = Path(directory)
    if not d.exists():
        return None
    steps = sorted(int(p.stem.split("_")[1]) for p in d.glob("step_*.pt"))
    return steps[-1] if steps else None


def restore_checkpoint(directory, step: Optional[int] = None, template: Any = None) -> Any:
    """Restore the given (or latest) step: into ``template`` (a state of the
    same structure, whose modules, optimizers and generators are loaded in
    place), or as the saved tree of CPU tensors without one."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    tree = torch.load(_path(directory, step), map_location="cpu", weights_only=True)
    return tree if template is None else _load_into(template, tree)
