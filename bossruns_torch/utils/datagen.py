"""Synthetic corpora for the port: the JAX package's writer, which is NumPy only.

``write_corpus`` writes a reference FASTA, reads as FASTQ and their full and
truncated PAFs, the inputs ``models.runs_sim.BossRunsSim`` takes;
``random_genome`` and ``simulate_reads`` make the genomes and noisy reads
the AEONS checks draw from. They import no JAX, so the port shares them
rather than keeping copies.
"""
from bossruns_tpu.utils.datagen import random_genome, simulate_reads, write_corpus

__all__ = ["random_genome", "simulate_reads", "write_corpus"]
