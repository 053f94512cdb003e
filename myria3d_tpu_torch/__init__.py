"""myria3d_tpu_torch — training, full-cloud test and tile prediction of
the model zoo's two families, RandLA-Net and PointNet++, in PyTorch on
NVIDIA Hopper.

A port of ``myria3d_tpu`` (JAX/Pallas) that mirrors its module names and
imports nothing of it. Every Pallas kernel of the JAX package has a
hand-written CUDA C++ counterpart for ``sm_90a`` under ``csrc/``, built at
first use (``_ext.py``); each has a plain PyTorch version beside it that
CPU tensors take. The host code the JAX package runs in numpy (LAS I/O, the
data layer ``pctl``, the full-tile ``Interpolator``, the config system, the
checkpoint callbacks and the JAX-to-torch weight mapping) is copied into
the port under the same module paths.

Layers: ``ops`` (neighbour search, interpolation, decimation, fused LFA,
farthest-point sampling), ``models`` (RandLA-Net and PointNet++ in f32,
bfloat16 or float16 compute, the train/eval/predict steps), ``parallel``
(DDP), ``pctl`` (LAS I/O, datasets, transforms, padded batching),
``callbacks``, ``utils`` (config, checkpoints), ``train`` / ``predict`` /
``run`` (fit and test, the tile pipeline, the CLI). Entry points run on the
first CUDA device unless the caller asks for the CPU.
"""

from myria3d_tpu_torch._version import __version__  # noqa: F401
