"""The benchmark of bossruns_torch on one NVIDIA H100: ``python -m benchmark``.

Measures the PyTorch and CUDA port only; nothing here imports JAX or the
JAX package. See ``harness.py`` for how a cell is found and run.
"""
