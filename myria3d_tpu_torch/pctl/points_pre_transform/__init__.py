"""Copied from ``myria3d_tpu/pctl/points_pre_transform/__init__.py``; imports point at the port."""
