"""Multi-GPU training (mirrors ``fpyv_tpu.parallel``): one process per GPU
under ``torch.distributed``.

- data parallelism over *environments*: each rank steps its contiguous
  slice of the env bank; the rollout needs no communication;
- the PPO learner is data-parallel: each rank computes gradients on its
  local minibatch and one all-reduce averages them before the clip;
- ES splits its population over the ranks and gathers the fitness with one
  all-reduce;
- :mod:`fpyv_tpu_torch.parallel.launch` spawns W ranks on one host (the
  tests, and the one-card checks over gloo); torchrun starts them on many.
"""

from fpyv_tpu_torch.parallel.mesh import ENV_AXIS, make_mesh, shard_leading_axis  # noqa: F401
from fpyv_tpu_torch.parallel.train import make_distributed_ppo  # noqa: F401
