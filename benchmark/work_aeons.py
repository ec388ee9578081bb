"""The bytes one call of the AEONS kernels needs: H6 (the overlap search's
seeding) and H7 (the contig strategy).

H6 takes a call's reads packed 4 bits a base (``rows`` reads of length
bucket ``L``: rows x L / 8 int32 words), looks up each read's first
``budget(L)`` minimizers in the pool's index (a sorted key, int32, and its
OCC_CAP packed occurrences, int32 each) and writes 6 int32 fields for each
of NCAND clusters of each of the two strand spaces of a read. Its least
time counts each of these once a call, over the HBM rate: of the index,
the key and occurrences of each minimizer the call can look up, at most
the whole index, so that the bytes follow the call's work and not the
number of calls.

H7 reads each chunk's coverage mean (uint8), each contig's chunk-count
prefix sum (int64) and end flags (uint8) and the 101 float32 scores, and
writes the mask (uint8, two strands a chunk): its least bytes, once. The
window sums, the benefit and the bins it keeps between its launches are
intermediate and not counted.
"""
from __future__ import annotations

from .reference.aeons import W, budget
from .work import HBM_BYTES_PER_S

OCC_CAP = 4
NCAND = 4
CAND_FIELDS = 6


def cand_call_bytes(rows: int, L: int, n_keys: int) -> int:
    lookups = min(rows * budget(L, W), n_keys)
    return 4 * (rows * (L // 8) + lookups * (1 + OCC_CAP) + CAND_FIELDS * 2 * NCAND * rows)


def cand_least_s(calls) -> float:
    """Least seconds of the H6 calls among ``calls`` = (rows, L, index
    keys, "H6" or "host")."""
    return sum(cand_call_bytes(int(r), int(L), int(nk)) for r, L, nk, where in calls
               if where == "H6") / HBM_BYTES_PER_S


def strategy_bytes(chunks: int, contigs: int) -> int:
    return chunks + contigs * (8 + 1) + 101 * 4 + 2 * chunks


def strategy_least_s(sizes) -> float:
    """Least seconds of the H7 calls of ``sizes`` = (chunks, contigs)."""
    return sum(strategy_bytes(int(n), int(c)) for n, c in sizes if n) / HBM_BYTES_PER_S
