"""State and worlds to and from plain dicts of numpy arrays, keyed by the
JAX package's field names.

This slice's "weights" are the env state and the world: a caller holding a
``fpyv_tpu`` state turns it into such a dict (``{f.name: np.asarray(...)}``
per flax dataclass, nested dataclasses as nested dicts) and carries it into
the port here, and back (:func:`to_numpy_tree` makes such dicts from
either package's objects). Dtypes are kept (float32, int32, bool). The JAX
state's PRNG ``key`` has no counterpart in the port (it draws from
``torch.Generator``s) and is dropped on the way in.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fpyv_tpu_torch.device import resolve_device
from fpyv_tpu_torch.envs.acro import AcroState
from fpyv_tpu_torch.physics.drone import DomainRand, DroneState
from fpyv_tpu_torch.physics.world import World


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def _from(cls, d: dict, device):
    return cls(**{f.name: _tensor(d[f.name], device) for f in dataclasses.fields(cls)})


def to_numpy_tree(obj) -> dict:
    """Any dataclass tree (the port's, or the JAX package's flax structs)
    -> nested dicts of numpy arrays keyed by field name; ``key`` fields
    (JAX PRNG keys) are left out."""
    out = {}
    for f in dataclasses.fields(obj):
        if f.name == "key":
            continue
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = to_numpy_tree(v)
        elif isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu().numpy()
        else:
            out[f.name] = np.asarray(v)
    return out


def world_from_numpy(d: dict, device=None) -> World:
    return _from(World, d, resolve_device(device))


def world_to_numpy(world: World) -> dict:
    return to_numpy_tree(world)


def drone_state_from_numpy(d: dict, device=None) -> DroneState:
    return _from(DroneState, d, resolve_device(device))


def acro_state_from_numpy(d: dict, device=None) -> AcroState:
    device = resolve_device(device)
    return AcroState(
        drone=drone_state_from_numpy(d["drone"], device),
        domain_rand=_from(DomainRand, d["domain_rand"], device),
        t=_tensor(d["t"], device),
        prev_dist=_tensor(d["prev_dist"], device),
        episode_return=_tensor(d["episode_return"], device),
        wind=_tensor(d["wind"], device),
    )


def acro_state_to_numpy(state: AcroState) -> dict:
    return to_numpy_tree(state)
