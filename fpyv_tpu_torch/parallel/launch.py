"""Spawn W ranks of one program on this host (what JAX's virtual CPU
devices give its tests for free).

:func:`launch` starts ``world_size`` processes with the ``spawn`` start
method (never ``fork``: the parent may hold CUDA state), joins them into one
process group through a ``file://`` store in a temporary directory (no TCP
port to race for), runs ``fn(mesh, *args)`` in each and returns each rank's
result. A rank's exception is raised again in the parent; past the
``deadline`` every rank is killed and the call raises, so a hung collective
fails instead of hanging. Each rank takes one intra-op thread unless
``OMP_NUM_THREADS`` says otherwise, as torchrun sets it: W processes that
each start a team as wide as the host oversubscribe it (every rank draws
the whole bank's resets on the host, and past ~32k elements torch's CPU
draws run in parallel).

torchrun, not this, starts a job over several hosts or GPUs; the trainers'
``distributed=True`` joins either (:func:`fpyv_tpu_torch.parallel.mesh.make_mesh`).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.distributed as dist

from fpyv_tpu_torch.parallel.mesh import make_mesh


def _rank_main(fn, args, rank, world_size, init_method, backend, device, results) -> None:
    try:
        if "OMP_NUM_THREADS" not in os.environ:
            torch.set_num_threads(1)
        mesh = make_mesh(init_method=init_method, rank=rank, world_size=world_size,
                         backend=backend, device=device)
        out = fn(mesh, *args)
        results.put((rank, True, pickle.dumps(out)))
    except Exception as e:  # noqa: BLE001 -- the rank's failure goes to the parent
        tb = traceback.format_exc()
        try:
            payload = pickle.dumps(e)
        except Exception:  # noqa: BLE001 -- an unpicklable exception travels as text
            payload = None
        results.put((rank, False, (payload, tb)))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, world_size: int, args: tuple = (), *, device: Optional[str] = "cpu",
           backend: Optional[str] = None, deadline: float = 120.0) -> list:
    """Run ``fn(mesh, *args)`` in ``world_size`` spawned ranks joined into
    one group; returns the ranks' results, by rank.

    ``fn`` and ``args`` must pickle (``fn`` a module-level function), and so
    must the results (return numpy or CPU tensors). ``device`` is every
    rank's device (None: ``cuda:<rank>``); ``backend`` as in
    :func:`~fpyv_tpu_torch.parallel.mesh.make_mesh` (gloo on the CPU, NCCL
    on CUDA by default; ranks sharing one card need ``backend="gloo"``).
    The ranks load the kernel library the parent built (``build/kernels/``,
    named by its sources' hash) instead of building it again."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="fpyv_launch_")
    init_method = (Path(tmp) / "store").absolute().as_uri()
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, args, r, world_size, init_method, backend, device, results))
             for r in range(world_size)]
    end = time.monotonic() + deadline
    out = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > end:
                    raise TimeoutError(f"launch: {world_size} ranks of {fn.__name__} passed "
                                       f"the {deadline} s deadline; killed") from None
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"launch: rank {dead[0][0]} of {fn.__name__} died with "
                                       f"exit code {dead[0][1]}")
                continue
            if not ok:
                exc_bytes, tb = payload
                exc = pickle.loads(exc_bytes) if exc_bytes is not None else RuntimeError(tb)
                if exc_bytes is not None:
                    exc.add_note(f"in rank {rank} of {world_size}:\n{tb}")
                raise exc
            out[rank] = pickle.loads(payload)
        return [out[r] for r in range(world_size)]
    finally:
        for p in procs:
            p.join(timeout=5.0 if len(out) == world_size else 0.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
