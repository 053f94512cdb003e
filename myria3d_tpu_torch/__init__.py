"""myria3d_tpu_torch — RandLA-Net training, full-cloud test and tile
prediction in PyTorch on NVIDIA Hopper.

A port of ``myria3d_tpu`` (JAX/Pallas) that mirrors its module names and
imports nothing of it. Every Pallas kernel of the JAX package has a
hand-written CUDA C++ counterpart for ``sm_90a`` under ``csrc/``, built at
first use (``_ext.py``); each has a plain PyTorch version beside it that
CPU tensors take. The host code the JAX package runs in numpy (LAS I/O, the
data layer ``pctl``, the full-tile ``Interpolator``, the config system, the
checkpoint callbacks and the JAX-to-torch weight mapping) is copied into
the port under the same module paths.

Layers: ``ops`` (neighbour search, interpolation, decimation, fused LFA),
``models`` (RandLA-Net, the train/eval/predict steps), ``pctl`` (LAS I/O,
datasets, transforms, padded batching), ``callbacks``, ``utils`` (config,
checkpoints), ``train`` / ``predict`` / ``run`` (fit and test, the tile
pipeline, the CLI). Entry points run on the first CUDA device unless the
caller asks for the CPU.
"""
