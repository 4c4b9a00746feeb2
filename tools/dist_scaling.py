"""The port's multi-GPU training against one process: ``train_acro`` and
``train_es`` with ``distributed=True`` over W ranks, one GPU a rank (NCCL),
and two gloo ranks sharing one card.

    python3 tools/dist_scaling.py                 # on a host with 4 GPUs
    python3 tools/dist_scaling.py --ranks 1,2     # on a host with 2
    python3 tools/dist_scaling.py --device cpu --envs 64 --ranks 1,2,4  # rehearsal

For each world size W (ranks spawned by ``fpyv_tpu_torch.parallel.launch``)
each rank runs, in order:

- a fixed-action rollout of its rows of a ``--envs``-env ``AcroEnv`` bank
  (64 steps, episodes of 16), which the parent holds bit for bit against
  one process's;
- ``train_acro(distributed=True)`` with ``--envs`` envs a rank (weak
  scaling) and with ``--envs`` in all (strong), 6 iterations in chunks of
  2, the first chunk left out: the trained env-steps/s of all ranks
  together (each rank's meter counts the global env-steps); the replicas'
  parameters, compared by the parent;
- 2 more iterations with a spy on ``parallel.mesh.pmean_``: the
  all-reduces' share of those iterations (host clock, the device
  synchronised before each);
- ``train_es(distributed=True)`` at its defaults, 2 generations in chunks
  of 1 (the population split over the ranks): the fitness-rollout
  env-steps/s of the second.

One process (no launch) runs the same trainers first, as the reference.
``--share-card`` adds two gloo ranks on the first device. Each line of the
output is one JSON object; the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fpyv_tpu_torch.apps.train import make_acro_trainer, train_acro, train_es  # noqa: E402
from fpyv_tpu_torch.envs.acro import AcroEnv  # noqa: E402
from fpyv_tpu_torch.envs.base import take_part  # noqa: E402
from fpyv_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from fpyv_tpu_torch.parallel.launch import launch  # noqa: E402
from fpyv_tpu_torch.physics.drone import DroneParams  # noqa: E402
from fpyv_tpu_torch.rl.ppo import scan_train  # noqa: E402
from fpyv_tpu_torch.utils.checkpoint import restore_checkpoint  # noqa: E402

ITERS, CHUNK = 6, 2


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def layout(mesh, n: int, device) -> np.ndarray:
    """64 fixed-action steps of this rank's rows of an n-env bank: reward,
    position and done a step."""
    part = None if mesh is None else mesh.part(n)
    env = AcroEnv(params=DroneParams(att_mode="quat"), max_episode_steps=16)
    world = env.default_world(device)
    gen = torch.Generator().manual_seed(27)
    state = take_part(env.reset(gen, world, (n,))[0], part)
    action = torch.zeros((state.t.shape[0], 4), device=device)
    action[:, 3] = -0.6
    out = []
    for _ in range(64):
        state, _, r, d, _ = env.step(state, action, world, generator=gen, part=part)
        out.append(torch.cat([r[:, None], state.drone.pos, d[:, None].to(r.dtype)], dim=-1))
    return torch.stack(out).cpu().numpy()


def _params_hash(ck: str, step: int, shard) -> str:
    tree = restore_checkpoint(ck, step, shard=shard)
    h = hashlib.sha256()
    for k in sorted(tree["params"]):
        h.update(tree["params"][k].numpy().tobytes())
    return h.hexdigest()[:16]


def learner(n_envs: int, device, root: str, distributed: bool, mesh=None) -> dict:
    """train_acro over the job (or one process): the rate, the replicas'
    hash, and the all-reduces' share of 2 more iterations."""
    res = train_acro(num_envs=n_envs, num_iterations=ITERS, scan_chunk=CHUNK, print_every=0,
                     checkpoint_dir=root, checkpoint_every=ITERS, distributed=distributed,
                     device=device)
    shard = (mesh.rank, mesh.size) if distributed else None
    out = dict(rate=res.steps_per_second, params=_params_hash(root, ITERS, shard))
    trainer = make_acro_trainer(num_envs=n_envs, device=device, mesh=mesh)
    state, _ = scan_train(trainer.train_iteration, trainer.state, 1)  # warm-up
    spans = []
    real = pmesh.pmean_

    def timed(tensors, mesh_):
        _sync(device)
        t = time.perf_counter()
        real(tensors, mesh_)
        spans.append(time.perf_counter() - t)

    pmesh.pmean_ = timed
    try:
        _sync(device)
        t0 = time.perf_counter()
        state, infos = scan_train(trainer.train_iteration, state, 2)
        infos["loss"].cpu()
        wall = time.perf_counter() - t0
    finally:
        pmesh.pmean_ = real
    out.update(allreduce_share=sum(spans) / wall, allreduces=len(spans),
               iteration_ms=wall / 2 * 1e3)
    return out


def es_rate(device, distributed: bool, es_kw: dict) -> float:
    return train_es(num_iterations=2, scan_chunk=1, print_every=0, distributed=distributed,
                    device=device, **es_kw).steps_per_second


def rank_fn(mesh, n_envs: int, root: str, threads: int, es_kw: dict) -> dict:
    if threads:
        torch.set_num_threads(threads)
    device = mesh.device
    return dict(layout=layout(mesh, n_envs, device),
                weak=learner(n_envs * mesh.size, device, f"{root}/weak{mesh.rank}", True, mesh),
                strong=learner(n_envs, device, f"{root}/strong{mesh.rank}", True, mesh),
                es=es_rate(device, True, es_kw), threads=torch.get_num_threads())


def _summary(label: str, outs: list, one: dict, ref_layout: np.ndarray) -> dict:
    equal = np.array_equal(np.concatenate([o["layout"] for o in outs], axis=1), ref_layout)
    row = dict(config=label, ranks=len(outs), threads=outs[0]["threads"],
               layout_equal_to_one_process=bool(equal))
    for kind in ("weak", "strong"):
        rs = [o[kind] for o in outs]
        row[kind] = dict(rate=rs[0]["rate"], x_one_process=rs[0]["rate"] / one["rate"],
                         replicas_equal=len({r["params"] for r in rs}) == 1,
                         allreduce_share=[round(r["allreduce_share"], 6) for r in rs],
                         allreduces=rs[0]["allreduces"],
                         iteration_ms=[round(r["iteration_ms"], 3) for r in rs])
    row["es"] = dict(rate=outs[0]["es"], x_one_process=outs[0]["es"] / one["es"])
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", default="1,2,4")
    ap.add_argument("--envs", type=int, default=4096, help="envs a rank (weak scaling)")
    ap.add_argument("--device", default=None, help="'cpu' for a rehearsal; default CUDA")
    ap.add_argument("--share-card", action="store_true")
    args = ap.parse_args()
    cpu = args.device == "cpu"
    if not cpu:
        if not torch.cuda.is_available():
            print("dist_scaling: needs CUDA (or --device cpu)", file=sys.stderr)
            return 2
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip().splitlines()
        print(json.dumps({"cards": smi, "torch": torch.__version__}), flush=True)
    device = "cpu" if cpu else "cuda"
    # the ES trainer's defaults on the card; a small population on the CPU
    es_kw = dict(num_envs=8, n_perturbations=4, num_steps=5) if cpu else {}
    root = tempfile.mkdtemp(prefix="dist_scaling_")
    try:
        ref_layout = layout(None, args.envs, device)
        one = dict(learner(args.envs, device, f"{root}/one", False),
                   es=es_rate(device, False, es_kw))
        print(json.dumps({"config": "one process", **one}), flush=True)
        configs = [(f"{w} ranks, one GPU each", w, None, None, 0)
                   for w in (int(x) for x in args.ranks.split(","))]
        if args.share_card:
            configs.append(("2 gloo ranks on one card", 2, "cpu" if cpu else "cuda:0", "gloo",
                            0))
        for label, w, dev, backend, threads in configs:
            if cpu:
                dev, backend = "cpu", "gloo"
            t0 = time.perf_counter()
            outs = launch(rank_fn, w, (args.envs, f"{root}/{w}{backend}", threads, es_kw),
                          device=dev, backend=backend, deadline=900.0)
            row = _summary(label, outs, one, ref_layout)
            row["seconds"] = time.perf_counter() - t0
            print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
