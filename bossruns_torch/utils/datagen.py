"""Synthetic corpora for the port: the JAX package's writer, which is NumPy only.

``write_corpus`` writes a reference FASTA, reads as FASTQ and their full and
truncated PAFs, the inputs ``models.runs_sim.BossRunsSim`` takes. It imports
no JAX, so the port shares it rather than keeping a copy.
"""
from bossruns_tpu.utils.datagen import write_corpus

__all__ = ["write_corpus"]
