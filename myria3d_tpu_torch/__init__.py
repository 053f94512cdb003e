"""myria3d_tpu_torch — the RandLA-Net predict path in PyTorch on NVIDIA Hopper.

A port of ``myria3d_tpu`` (JAX/Pallas) that mirrors its module names. The
three Pallas kernels of the predict path are hand-written CUDA C++ for
``sm_90a`` under ``csrc/``, built at first use (``_ext.py``); each has a
plain PyTorch version beside it that CPU tensors take. The host data layer
(``myria3d_tpu.pctl``), the full-tile ``Interpolator`` and the checkpoint
key mapping (``myria3d_tpu.utils.torch_ckpt``) are reused unchanged — none
of them needs JAX.

Layers: ``ops`` (neighbour search, interpolation, decimation, fused LFA),
``models`` (RandLA-Net eval forward, the predict step), ``utils``
(checkpoints), ``predict`` / ``run`` (the tile pipeline and its CLI).
"""
