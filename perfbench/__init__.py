"""The benchmark of the PyTorch / CUDA port: ``python3 perfbench/run.py --help``."""
