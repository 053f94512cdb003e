"""Copied from ``myria3d_tpu/pctl/transforms/__init__.py``; imports point at the port."""
