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
``nn.Conv2d``. A leaf that is an array is a bare parameter, a dict a layer,
so one converter also serves SAC's nets, whose actor's ``log_std`` is a
layer: :func:`sac_params_from_numpy` and :func:`sac_params_to_numpy` carry
the actor and critic trees as a pair.

:func:`ravel_params` and :func:`unravel_params` flatten a tree into ES's
theta and back in ``jax.flatten_util.ravel_pytree``'s order (keys sorted at
every level), so the port's theta has JAX's length and layout.

The secondary paths' states — ``HoverState``, ``SensorAcroState`` (the acro
state and ``prev_action``), ``RacerState``, ``RatesControllerState`` and
``FlightModeState`` — carry across with their ``*_from_numpy`` and
``*_to_numpy`` pairs, and the ``models.nn`` MLP layers (``[{"weight",
"bias"}, ...]``, the JAX package's (in, out) layout in both) with
:func:`mlp_params_from_numpy` and :func:`mlp_params_to_numpy`.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from fpyv_tpu_torch.device import resolve_device
from fpyv_tpu_torch.control.flight_modes import FlightModeState
from fpyv_tpu_torch.control.rates_controller import RatesControllerState
from fpyv_tpu_torch.envs.acro import AcroState
from fpyv_tpu_torch.envs.hover import HoverState
from fpyv_tpu_torch.envs.multi_race import MultiRaceState
from fpyv_tpu_torch.envs.sensor_acro import SensorAcroState
from fpyv_tpu_torch.envs.vision_race import VisionRaceState
from fpyv_tpu_torch.physics.drone import DroneState
from fpyv_tpu_torch.physics.racer import RacerState
from fpyv_tpu_torch.physics.world import World


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def _dataclass_from(cls, d: dict, device):
    """A (nested) dict of arrays -> ``cls``, nested dataclasses by their
    fields' annotations."""
    hints = typing.get_type_hints(cls)
    return cls(**{f.name: (_dataclass_from(hints[f.name], d[f.name], device)
                           if dataclasses.is_dataclass(hints[f.name])
                           else _tensor(d[f.name], device))
                  for f in dataclasses.fields(cls)})


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
    return _dataclass_from(World, d, resolve_device(device))


def world_to_numpy(world: World) -> dict:
    return to_numpy_tree(world)


def drone_state_from_numpy(d: dict, device=None) -> DroneState:
    return _dataclass_from(DroneState, d, resolve_device(device))


def acro_state_from_numpy(d: dict, device=None) -> AcroState:
    return _dataclass_from(AcroState, d, resolve_device(device))


def acro_state_to_numpy(state: AcroState) -> dict:
    return to_numpy_tree(state)


def race_state_from_numpy(d: dict, device=None):
    """A ``MultiRaceState`` dict, or a ``VisionRaceState`` one (``race`` and
    ``frames``), -> the port's state on ``device`` (CUDA unless told)."""
    return _dataclass_from(VisionRaceState if "frames" in d else MultiRaceState, d,
                           resolve_device(device))


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
    """A Flax ``PixelActorCritic``, ``ActorCritic``, ``SquashedGaussianActor``
    or ``TwinQNetwork`` parameter tree of numpy arrays, bare, under
    ``"params"`` or under ``"params"`` twice, -> a ``state_dict`` on
    ``device`` (CUDA unless told). A leaf that is an array is a bare
    parameter (``ActorCritic``'s ``log_std``); a dict is a layer (the SAC
    actor's ``log_std`` is one) or a cell of layers."""
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
        if not isinstance(leaf, dict):  # a bare parameter (ActorCritic's log_std)
            out[name] = _tensor(leaf, device)
        elif "kernel" in leaf:
            layer(_MODULE_NAMES.get(name, name), leaf)
        else:  # a cell of layers (the GRU)
            for sub, sub_leaf in leaf.items():
                layer(f"{_MODULE_NAMES.get(name, name)}.{sub}", sub_leaf)
    return out


def policy_params_to_numpy(net) -> dict:
    """Any of those nets (or its ``state_dict``) -> the Flax tree
    ``{"params": {...}}`` of numpy arrays."""
    sd = net.state_dict() if hasattr(net, "state_dict") else net
    params = {}
    for key, value in sd.items():
        if "." not in key:  # a bare parameter (ActorCritic's log_std)
            params[key] = _numpy(value)
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


def sac_params_from_numpy(trees: dict, device=None):
    """``{"actor": ..., "critic": ...}``, the Flax trees of a
    ``SquashedGaussianActor`` and a ``TwinQNetwork`` -> their two
    ``state_dict``s on ``device`` (CUDA unless told)."""
    return (policy_params_from_numpy(trees["actor"], device),
            policy_params_from_numpy(trees["critic"], device))


def sac_params_to_numpy(actor, critic) -> dict:
    """The SAC actor and critic (or their ``state_dict``s) -> ``{"actor":
    {"params": ...}, "critic": {"params": ...}}`` of numpy arrays."""
    return {"actor": policy_params_to_numpy(actor), "critic": policy_params_to_numpy(critic)}


def _leaves(tree: dict):
    """(path, leaf) pairs in JAX's flattening order: dict keys sorted."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            for path, leaf in _leaves(value):
                yield (key,) + path, leaf
        else:
            yield (key,), value


def ravel_params(tree: dict, device=None) -> torch.Tensor:
    """A nested dict of arrays or tensors -> one flat float32 vector, the
    leaves concatenated in ``jax.flatten_util.ravel_pytree``'s order (keys
    sorted as strings at every level, each leaf in C order). On a Flax tree
    from :func:`policy_params_to_numpy` that is JAX's own theta: kernels in
    the (in, out) layout, ``bias`` before ``kernel``."""
    flat = torch.cat([(leaf if isinstance(leaf, torch.Tensor) else
                       torch.from_numpy(np.array(leaf, np.float32))).to(torch.float32).reshape(-1)
                      for _, leaf in _leaves(tree)])
    return flat if device is None else flat.to(device)


def unravel_params(theta: torch.Tensor, like: dict) -> dict:
    """:func:`ravel_params` undone: theta (..., dim) -> a tree shaped as
    ``like``, each leaf a contiguous (..., *leaf.shape) tensor; leading dims
    batch several parameter sets (a batched product over strided slices of
    theta takes a slow path on the CPU)."""
    leaves = [(path, tuple(np.shape(leaf))) for path, leaf in _leaves(like)]
    sizes = [int(np.prod(shape, dtype=np.int64)) for _, shape in leaves]
    if sum(sizes) != theta.shape[-1]:
        raise ValueError(f"theta has {theta.shape[-1]} entries, the tree {sum(sizes)}")
    lead, out, start = tuple(theta.shape[:-1]), {}, 0
    for (path, shape), size in zip(leaves, sizes):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = theta[..., start:start + size].reshape(lead + shape).contiguous()
        start += size
    return out


def hover_state_from_numpy(d: dict, device=None) -> HoverState:
    return _dataclass_from(HoverState, d, resolve_device(device))


def hover_state_to_numpy(state: HoverState) -> dict:
    return to_numpy_tree(state)


def sensor_acro_state_from_numpy(d: dict, device=None) -> SensorAcroState:
    return _dataclass_from(SensorAcroState, d, resolve_device(device))


def sensor_acro_state_to_numpy(state: SensorAcroState) -> dict:
    return to_numpy_tree(state)


def racer_state_from_numpy(d: dict, device=None) -> RacerState:
    return _dataclass_from(RacerState, d, resolve_device(device))


def racer_state_to_numpy(state: RacerState) -> dict:
    return to_numpy_tree(state)


def rates_controller_state_from_numpy(d: dict, device=None) -> RatesControllerState:
    return _dataclass_from(RatesControllerState, d, resolve_device(device))


def rates_controller_state_to_numpy(state: RatesControllerState) -> dict:
    return to_numpy_tree(state)


def flight_mode_state_from_numpy(d: dict, device=None) -> FlightModeState:
    return _dataclass_from(FlightModeState, d, resolve_device(device))


def flight_mode_state_to_numpy(state: FlightModeState) -> dict:
    return to_numpy_tree(state)


def mlp_params_from_numpy(layers, device=None) -> list:
    """``models.nn`` MLP layers (a list of ``{"weight", "bias"}`` arrays,
    ``nn.mlp_init``'s) -> the same list of tensors on ``device`` (CUDA
    unless told); ``TerrainNet.from_params`` takes it."""
    device = resolve_device(device)
    return [{k: _tensor(v, device) for k, v in layer.items()} for layer in layers]


def mlp_params_to_numpy(layers) -> list:
    return [{k: _numpy(v) for k, v in layer.items()} for layer in layers]
