"""Tetranucleotide composition statistics for the AEONS metagenomic gate.

In AEONS, overlaps between reads are vetoed when the two sequences'
tetramer-frequency profiles are too distant (different species sharing a
repeat). Semantics follow the reference's boss/aeons/kmer.py: k-mers are
counted over seq + reverse complement, the intra/inter-species decision is a
Euclidean distance between normalised tetramer frequency vectors with the
empirically derived threshold 0.036 (kmer.py:218), and TETRA-style z-scores
(observed vs Markov-expected tetramer counts) are available for analysis.

Implementation is 2-bit-code vectorised: a k-mer index array is built with
shifts and counted with one bincount — no per-kmer dicts.
"""
from __future__ import annotations

import numpy as np

EUCLIDEAN_THRESHOLD = 0.036

_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
    _CODE[_b + 32] = _i


def _codes_with_rc(seq: str) -> np.ndarray:
    c = _CODE[np.frombuffer(seq.encode(), dtype=np.uint8)]
    rc = (3 - c[::-1].astype(np.int16)).astype(np.uint8)  # invalid stays >= 4
    return np.concatenate([c, np.full(1, 255, np.uint8), rc])


def kmer_counts(seq: str, k: int) -> np.ndarray:
    """Counts of all 4**k k-mers over seq + its reverse complement."""
    c = _codes_with_rc(seq)
    n = c.shape[0] - k + 1
    if n <= 0:
        return np.zeros(4**k, dtype=np.int64)
    idx = np.zeros(n, dtype=np.int64)
    valid = np.ones(n, dtype=bool)
    for j in range(k):
        cj = c[j : j + n]
        idx = (idx << 2) | (cj & 3)
        valid &= cj < 4
    return np.bincount(idx[valid], minlength=4**k)


def tetramer_freqs(seq: str) -> np.ndarray:
    """Normalised tetramer frequency vector [256]."""
    counts = kmer_counts(seq, 4)
    tot = counts.sum()
    return counts / tot if tot else counts.astype(np.float64)


def tetramer_zscores(seq: str) -> np.ndarray:
    """TETRA z-scores: observed vs 3rd-order-Markov-expected tetramer counts
    (kmer.py:108-141). Returns [256] array indexed by packed tetramer code."""
    c2 = kmer_counts(seq, 2).astype(np.float64)
    c3 = kmer_counts(seq, 3).astype(np.float64)
    c4 = kmer_counts(seq, 4).astype(np.float64)
    t = np.arange(256)
    left3 = t >> 2          # first 3 bases
    right3 = t & 0x3F       # last 3 bases
    mid2 = (t >> 2) & 0xF   # middle 2 bases
    den = c2[mid2]
    with np.errstate(divide="ignore", invalid="ignore"):
        exp = np.where(den > 0, c3[left3] * c3[right3] / den, 0.0)
        var = np.where(
            den > 0, exp * (den - c3[left3]) * (den - c3[right3]) / (den * den), 0.0
        )
        sd = np.sqrt(np.maximum(var, 0.0))
        z = np.where(sd > 0, (c4 - exp) / sd, c4 - exp)
    return z


def euclidean_dist(freq1: np.ndarray, freq2: np.ndarray) -> float:
    """Euclidean distance between two tetramer frequency vectors."""
    d = freq1 - freq2
    return float(np.sqrt(np.sum(d * d)))


def is_intra(freq1: np.ndarray, freq2: np.ndarray, threshold: float = EUCLIDEAN_THRESHOLD) -> bool:
    """True when two profiles look intra-species (overlap allowed)."""
    return euclidean_dist(freq1, freq2) < threshold
