"""The bytes one call of the aligner's seeding kernel (H5) needs.

H5 takes a call's reads packed 4 bits a base (``rows`` reads of length
bucket ``L``: rows x L / 8 int32 words), looks their minimizers up in the
index (the sorted keys, int32 each, and each key's OCC_CAP packed
occurrences, int32 each) and writes 6 int32 fields for each of NCAND
candidates a read. Its least time counts each of these once a call, over
the HBM rate: the count of the kernel's own inputs and outputs that the
port's kernel table gives H5 (``chip_smoke.py``'s bound), the whole index
read once a call although a call touches only the keys its minimizers hit.
"""
from __future__ import annotations

from .work import HBM_BYTES_PER_S

OCC_CAP = 4
NCAND = 4
SEED_FIELDS = 6


def seed_call_bytes(rows: int, L: int, n_keys: int) -> int:
    return 4 * (rows * (L // 8) + n_keys * (1 + OCC_CAP) + SEED_FIELDS * NCAND * rows)


def seed_least_s(calls, n_keys: int) -> float:
    """Least seconds of the calls ``(rows, L)`` against an index of
    ``n_keys`` keys."""
    return sum(seed_call_bytes(int(r), int(L), n_keys) for r, L in calls) / HBM_BYTES_PER_S
