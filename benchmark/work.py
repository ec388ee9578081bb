"""The bytes and operations one RUNS update needs, and the card's peaks.

One update is the state transition

    (coverage, zeroed, bucket_on, read_starts, strat; batch; params)
        -> (coverage', zeroed', bucket_on', read_starts', strat'; aux)

and its least time on the card is the larger of the bytes it must move
over the HBM rate and the arithmetic it must do over the arithmetic peaks,
whatever kernels implement it (a fusion of two kernels leaves the count
valid):

* Bytes read once: the whole state (coverage [nb, 5, G] uint16, zeroed
  [nb, G] bool, bucket_on [nb, NBk] bool, read_starts [Wf, 2] float32,
  strat [nb, Gd, 2] bool); the per-site constants the scores need (the
  reference symbol, int8, and the site's validity, bool: 2 B a site); the
  per-row tables of the benefit, bucket and read-start stages (contig id,
  segment start and end, read-start window, bucket, bucket window, int32
  each, and the strategy row's validity: 25 B a row of 100 sites); and
  the batch as uploaded (every field of its wire once).
* Bytes written once: each coverage entry the batch changes (2 B; the
  update is in place, so the rest need not be written), the strategy, the
  bucket switches, the read starts. The dropout zeros are written where
  they change, which depends on the data and is counted as none: the
  count is a floor, so the share it gives is too.
* Scores, coverage sums and benefits are intermediate and not counted:
  an implementation may keep them on chip.
* Arithmetic: the per-site score of every valid, unfrozen site with a
  count among the model's symbols (the others score one of a few
  constants): 2 (2 LB LG + LG + LB) float32 operations (the two
  contractions, the k and q log q sums, as FMAs) and LG + LB + 2
  special-function results (an exponential per genotype for the
  log-sum-exp, a log per symbol, the log of the sum and its reciprocal),
  LB symbols and LG genotypes. The rest of the update is a few operations
  a byte. (The arithmetic of ``chip_smoke.py``'s ``score_bound``.)

The peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit:
3.35 TB/s of HBM, 67 TFLOP/s of float32 outside the tensor cores, and 16
special-function results per SM and clock on 132 SMs at the 1980 MHz
maximum SM clock.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
SFU_PER_S = 16 * 132 * 1980e6


def update_bytes(G: int, nb: int, Gd: int, n_buckets: int, n_fhat: int, batch_bytes: int,
                 changed_entries: int) -> int:
    read = (10 * nb * G + nb * G + nb * n_buckets + 8 * n_fhat + 2 * nb * Gd
            + 2 * G + 25 * Gd + batch_bytes)
    write = 2 * changed_entries + 2 * nb * Gd + nb * n_buckets + 8 * n_fhat
    return read + write


def score_ops(contracted_sites: int, len_b: int, len_g: int) -> tuple[int, int]:
    """(float32 operations, special-function results) of the scores."""
    return (2 * (2 * len_b * len_g + len_g + len_b) * contracted_sites,
            (len_g + len_b + 2) * contracted_sites)


def least_time_s(n_bytes: int, flops: int, sfu: int) -> tuple[float, str]:
    """(the least time in seconds, what bounds it)."""
    parts = {"bytes": n_bytes / HBM_BYTES_PER_S, "float32": flops / F32_FLOP_PER_S,
             "special functions": sfu / SFU_PER_S}
    by = max(parts, key=parts.get)
    return parts[by], by


def batch_bytes(batch: dict) -> int:
    """Bytes of a host batch's fields, each padded to 4 as the wire packs them."""
    return sum((v.nbytes + 3) // 4 * 4 for v in batch.values())
