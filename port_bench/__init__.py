"""The benchmark of the PyTorch/CUDA port: see ``harness.py``; run with ``python3 -m port_bench``."""
