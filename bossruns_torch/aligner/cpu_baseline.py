"""CPU baseline aligner: host seed + extend with a worker thread pool.

A copy of ``bossruns_tpu.aligner.cpu_baseline`` on the port's classes.
The stand-in for the reference's mapper — mappy (minimap2's C library)
batch-mapped over a ThreadPoolExecutor of 4 workers. mappy is not
available, so the baseline walks the SAME minimizer index on the host
(host_seed.py, vectorised NumPy + the native C k-mer scan) and extends with
the SAME native banded DP, pinned to 4 threads by default like the
reference's pool. Its seeding equals H5's on every voted candidate, so
``CpuAligner`` and ``TorchAligner`` emit byte-identical records and differ
ONLY in where the seeding runs.

Drop-in for TorchAligner: same constructor shape (no device), same
map_sequences contract.
"""
from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import _ENC, TorchAligner, bucket_of
from .host_seed import host_seed_topn
from .seed import NCAND

logger = logging.getLogger("boss_torch")


class CpuAligner(TorchAligner):
    """TorchAligner with the seeding stage replaced by the host mirror.

    Reuses map_sequences' bucket pipeline and _extend_bucket's candidate
    planning + native DP verbatim; only _encode / _seed_bucket_dispatch /
    _pull_seeds change (NumPy's encode and thread-pool futures instead of
    the staged payload and device launches — the same overlap: bucket i
    extends on the main thread while bucket i+1 seeds on the pool).
    """

    def __init__(
        self,
        layout,
        k: int | None = None,
        w: int | None = None,
        max_occ: int = 64,
        min_votes: int = 4,
        max_divergence: float = 0.35,
        mu: int = 400,
        threads: int = 4,
        source: str | None = None,
    ):
        self._init_host(layout, k, w, max_occ, min_votes, max_divergence, mu, threads,
                        source)
        self._pool = ThreadPoolExecutor(max_workers=threads)

    def _rebuild_kw(self) -> dict:
        """No device; load_index's __init__ starts a new pool, so the old
        one is shut down here."""
        self._pool.shutdown(wait=True)
        return {}

    def _encode(self, text: bytes, offs: np.ndarray, groups: list[np.ndarray]) -> tuple:
        """The batch's int8 codes; nothing is staged (the seeding is host)."""
        return _ENC[np.frombuffer(text, np.uint8)], None

    def _seed_bucket_dispatch(self, codes: np.ndarray, offs: np.ndarray,
                              groups: list[np.ndarray], staged) -> list:
        """Submit every bucket to the worker pool, one handle a bucket (read
        i is ``codes[offs[i]:offs[i + 1]]``)."""
        return [self._submit_bucket([codes[offs[i]: offs[i + 1]] for i in group])
                for group in groups]

    def _submit_bucket(self, enc_reads: list[np.ndarray]):
        """Split the bucket over the worker pool (the reference splits its
        read batch over its mappy workers the same way)."""
        L = bucket_of(max((e.shape[0] for e in enc_reads), default=0))
        reads = [e[:L] for e in enc_reads]
        nchunk = min(self.threads, max(len(reads), 1))
        bounds = np.linspace(0, len(reads), nchunk + 1).astype(int)
        return [
            self._pool.submit(host_seed_topn, reads[a:b], self.index, L, NCAND)
            for a, b in zip(bounds[:-1], bounds[1:])
            if b > a
        ]

    @staticmethod
    def _pull_seeds(out_dev, n: int):
        parts = [f.result() for f in out_dev]
        if len(parts) == 1:
            return parts[0]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
