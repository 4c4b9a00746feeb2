"""State and worlds to and from plain dicts of numpy arrays, keyed by the
JAX package's field names.

This slice's "weights" are the env state and the world: a caller holding a
``fpyv_tpu`` state turns it into such a dict (``{f.name: np.asarray(...)}``
per flax dataclass, nested dataclasses as nested dicts) and carries it into
the port here, and back (:func:`to_numpy_tree` makes such dicts from
either package's objects). Dtypes are kept (float32, int32, bool). The JAX
state's PRNG ``key`` has no counterpart in the port (it draws from
``torch.Generator``s) and is dropped on the way in.

Batched (per-env) worlds, whose every field carries a leading (N,) axis,
go through :func:`world_from_numpy` and :func:`world_to_numpy` unchanged.
The chase loop's result, (state, world, reward sums, crash counts, contact
counts), goes through :func:`chase_to_numpy` and :func:`chase_from_numpy`.
Race states (``MultiRaceState``, and ``VisionRaceState`` with its frame
history) go through :func:`race_state_from_numpy` and
:func:`race_state_to_numpy`.

Policy weights carry across through :func:`policy_params_from_numpy` and
:func:`policy_params_to_numpy`, for both nets: the Flax tree ``{"params":
{"patch_embed", "patch_pool"? | "conv0".."conv2", "fc0", "gru"?, "pi_mean",
"v_out", "log_std"}}`` of numpy arrays against
:class:`~fpyv_tpu_torch.models.policy.PixelActorCritic`'s ``state_dict`` (a
frame-stacked ``patch_embed`` (K*64, 128) included; ``gru`` nests
``{ir, iz, in, hr, hz, hn}``, ``hr`` and ``hz`` without a bias), and
``{"params": {"pi_dense{i}", "v_dense{i}"?, "pi_mean", "v_out", "log_std"}}``
against :class:`~fpyv_tpu_torch.models.policy.ActorCritic`'s. A PPO state's
checkpoint nests the tree once more (``{"params": {"params": ...}}``, the
state's field around Flax's collection); every level is peeled. A Flax
``kernel`` is ``(in, out)`` and an ``nn.Linear`` weight ``(out, in)``, so
dense kernels are transposed; a conv kernel is HWIO in Flax and OIHW in an
``nn.Conv2d``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fpyv_tpu_torch.device import resolve_device
from fpyv_tpu_torch.envs.acro import AcroState
from fpyv_tpu_torch.envs.multi_race import MultiRaceState
from fpyv_tpu_torch.envs.vision_race import VisionRaceState
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
        out[f.name] = to_numpy_tree(v) if dataclasses.is_dataclass(v) else _numpy(v)
    return out


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


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


def race_state_from_numpy(d: dict, device=None):
    """A ``MultiRaceState`` dict, or a ``VisionRaceState`` one (``race`` and
    ``frames``), -> the port's state on ``device`` (CUDA unless told)."""
    device = resolve_device(device)
    if "frames" in d:
        return VisionRaceState(race=race_state_from_numpy(d["race"], device),
                               frames=_tensor(d["frames"], device))
    return MultiRaceState(drones=drone_state_from_numpy(d["drones"], device),
                          **{f.name: _tensor(d[f.name], device)
                             for f in dataclasses.fields(MultiRaceState) if f.name != "drones"})


def race_state_to_numpy(state) -> dict:
    return to_numpy_tree(state)


CHASE_FIELDS = ("state", "world", "reward_sum", "crashes", "contacts")


def chase_to_numpy(result) -> dict:
    """The 5-tuple of either package's chase rollout
    (``fused_vision_env_rollout`` / ``pallas_vision_env_rollout``) -> a dict
    of numpy arrays, state and world as nested dicts."""
    state, world, *counts = result
    return dict(state=to_numpy_tree(state), world=to_numpy_tree(world),
                **{k: _numpy(v) for k, v in zip(CHASE_FIELDS[2:], counts)})


# Flax layer name <-> the module attribute holding it, where they differ
_MODULE_NAMES = {"patch_pool": "patch_pool_layer", "gru": "gru_cell"}
_FLAX_NAMES = {v: k for k, v in _MODULE_NAMES.items()}


def _weight_from_kernel(kernel) -> np.ndarray:
    k = np.asarray(kernel)
    return k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T  # HWIO -> OIHW; (in, out) -> (out, in)


def _kernel_from_weight(weight: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(weight.transpose(2, 3, 1, 0) if weight.ndim == 4 else weight.T)


def policy_params_from_numpy(tree: dict, device=None) -> dict:
    """A Flax ``PixelActorCritic`` or ``ActorCritic`` parameter tree of
    numpy arrays, bare, under ``"params"`` or under ``"params"`` twice, -> a
    ``state_dict`` on ``device`` (CUDA unless told)."""
    device = resolve_device(device)
    p = tree
    while "params" in p:
        p = p["params"]
    out = {}

    def layer(prefix, leaf):
        out[f"{prefix}.weight"] = _tensor(_weight_from_kernel(leaf["kernel"]), device)
        if "bias" in leaf:
            out[f"{prefix}.bias"] = _tensor(leaf["bias"], device)

    for name, leaf in p.items():
        if name == "log_std":
            out["log_std"] = _tensor(leaf, device)
        elif "kernel" in leaf:
            layer(_MODULE_NAMES.get(name, name), leaf)
        else:  # a cell of layers (the GRU)
            for sub, sub_leaf in leaf.items():
                layer(f"{_MODULE_NAMES.get(name, name)}.{sub}", sub_leaf)
    return out


def policy_params_to_numpy(net) -> dict:
    """A ``PixelActorCritic`` or ``ActorCritic`` (or its ``state_dict``)
    -> the Flax tree ``{"params": {...}}`` of numpy arrays."""
    sd = net.state_dict() if hasattr(net, "state_dict") else net
    params = {}
    for key, value in sd.items():
        if key == "log_std":
            params["log_std"] = _numpy(value)
            continue
        *path, kind = key.split(".")
        node = params
        for i, part in enumerate(path):
            node = node.setdefault(_FLAX_NAMES.get(part, part) if i == 0 else part, {})
        arr = _numpy(value)
        node["kernel" if kind == "weight" else "bias"] = (
            _kernel_from_weight(arr) if kind == "weight" else arr)
    return {"params": params}


def chase_from_numpy(d: dict, device=None):
    """:func:`chase_to_numpy`'s dict -> (AcroState, World, reward sums,
    crash counts, contact counts) on ``device`` (CUDA unless told)."""
    device = resolve_device(device)
    return (acro_state_from_numpy(d["state"], device), world_from_numpy(d["world"], device),
            *(_tensor(d[k], device) for k in CHASE_FIELDS[2:]))
