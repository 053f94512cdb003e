"""Copied from ``myria3d_tpu/pctl/io/__init__.py``; imports point at the port."""
