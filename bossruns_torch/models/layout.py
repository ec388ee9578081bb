"""Genome layout of the port: the JAX package's layout, which is NumPy only.

``bossruns_tpu.models.layout`` imports no JAX, so the port shares it rather
than keeping a copy. The port's modules (and callers of the port) reach it
through this module path.
"""
from bossruns_tpu.models.layout import BUCKET, DS, FHAT_WINDOW, GenomeLayout, build_layout

__all__ = ["BUCKET", "DS", "FHAT_WINDOW", "GenomeLayout", "build_layout"]
