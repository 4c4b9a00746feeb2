"""Convert the shipped flagship racer's orbax checkpoint into a flat .npz
that the PyTorch port reads with numpy alone.

    JAX_PLATFORMS=cpu python tools/convert_flagship.py

Reads ``runs/flagship/ck/step_0000005600`` (an orbax OCDBT tree, params
only) and writes ``runs/flagship_torch/policy.npz`` (one float32 array per
Flax leaf, keyed ``layer/kernel``, ``layer/bias`` and ``log_std``, equal bit
for bit to the orbax leaves) and ``runs/flagship_torch/meta.json`` (a copy
of ``runs/flagship/meta.json`` that names the source step). Needs JAX and
orbax; the port's loader (``fpyv_tpu_torch.apps.play.load_flagship``) needs
neither.

The restore is built from the checkpoint's own metadata: each leaf is
restored as a numpy array, so no sharding or shape template is needed.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "runs" / "flagship" / "ck" / "step_0000005600"
OUT = REPO / "runs" / "flagship_torch"


def restore_params(path: Path) -> dict:
    """The checkpoint's Flax parameter tree ``{layer: {kernel, bias},
    log_std}`` as numpy arrays, whatever the installed orbax's sharding
    defaults (a template-less restore asks for a concrete sharding)."""
    import jax
    import orbax.checkpoint as ocp

    ckptr = ocp.PyTreeCheckpointer()
    tree = ckptr.metadata(path).item_metadata.tree
    args = jax.tree.map(lambda _: ocp.RestoreArgs(restore_type=np.ndarray), tree)
    raw = ckptr.restore(path, restore_args=args)
    p = raw
    while "params" in p:  # the PpoState field, then Flax's collection
        p = p["params"]
    return p


def flatten(params: dict) -> dict:
    """{layer: {kernel, bias}, log_std} -> {"layer/kernel": ..., "log_std": ...}."""
    out = {}
    for name, leaf in params.items():
        if isinstance(leaf, dict):
            for kind, arr in leaf.items():
                out[f"{name}/{kind}"] = np.asarray(arr)
        else:
            out[name] = np.asarray(leaf)
    return out


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--src", default=str(SRC))
    p.add_argument("--out", default=str(OUT))
    a = p.parse_args()
    src, out = Path(a.src).resolve(), Path(a.out)
    flat = flatten(restore_params(src))
    for k, v in flat.items():
        if v.dtype != np.float32:
            raise ValueError(f"{k}: expected float32, got {v.dtype}")
    out.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out / "policy.npz", **flat)
    meta = json.loads((src.parents[1] / "meta.json").read_text())
    meta["converted_from"] = str(src.relative_to(REPO))
    meta["converted_step"] = int(src.name.split("_")[1])
    (out / "meta.json").write_text(json.dumps(meta, indent=1) + "\n")
    n = sum(v.nbytes for v in flat.values())
    print(f"wrote {out / 'policy.npz'}: {len(flat)} arrays, {n} bytes")
    for k, v in sorted(flat.items()):
        print(f"  {k}: {v.shape} {v.dtype}")


if __name__ == "__main__":
    main()
