"""parallel — data parallelism: DDP training over one process per device,
and predict over replicas on one process's devices.

Port of ``myria3d_tpu/parallel`` (``mesh.py``): the JAX package shards a
batch over a device mesh, the port runs ``torch.distributed`` process groups
(NCCL on GPUs, gloo on the CPU) and ``DistributedDataParallel``.
"""

from myria3d_tpu_torch.parallel.ddp import (  # noqa: F401
    ParallelSteps,
    auto_parallel,
    pad_rows,
    spawn,
)
