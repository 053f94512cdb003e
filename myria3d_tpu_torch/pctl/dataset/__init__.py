"""Copied from ``myria3d_tpu/pctl/dataset/__init__.py``; imports point at the port."""
