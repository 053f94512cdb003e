"""pctl — host-side point-cloud data layer.

TPU re-design of the reference's ``myria3d/pctl`` ("PointCloud-TorchLoader",
reference ``myria3d/pctl/__init__.py:1``): LAS I/O, tiling, feature
engineering, transforms, HDF5 cache and fixed-shape padded batching feeding
the JAX device pipeline.

Copied from ``myria3d_tpu/pctl/__init__.py``; imports point at the port.
"""
