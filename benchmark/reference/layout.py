"""The genome axis the reference works on, worked out from the contigs.

The update's semantics are defined over one padded site axis (the JAX
engine's layout, which the port keeps): contigs of at least 100 kb,
each padded to a multiple of 102,400 sites, so that window sums clamp at
a contig's padded block end, padding rows join the threshold scan with
zero read-start weight, and dropout means run over a contig's block.
This is a copy of that construction's arithmetic (bossruns_torch's
``models/layout.build_layout``), so the reference derives every table
from the contig lengths and sequences itself and takes none from the
program.
"""
from __future__ import annotations

import numpy as np

CHUNK = 102_400      # sites per padded chunk
DS = 100             # strategy rows: 100 sites
FHAT_WINDOW = 2000   # read-start windows
BUCKET = 20_000      # activation buckets
MIN_CONTIG_LEN = 100_000


class Genome:
    """Tables of the padded axis for {name: uint8 codes 0..3}."""

    def __init__(self, contigs: dict[str, np.ndarray], n_barcodes: int = 1,
                 min_len: int = MIN_CONTIG_LEN):
        self.names = [n for n, s in contigs.items() if len(s) >= min_len]
        seqs = [np.asarray(contigs[n], np.uint8) for n in self.names]
        self.nb = n_barcodes
        L = np.array([len(s) for s in seqs], np.int64)
        self.lengths = L
        blk = (L + CHUNK - 1) // CHUNK * CHUNK
        self.offsets = np.concatenate([[0], np.cumsum(blk)[:-1]]).astype(np.int64)
        self.G = int(blk.sum())
        self.Gd = self.G // DS
        G, Gd = self.G, self.Gd
        self.seq = np.zeros(G, np.uint8)
        self.site_valid = np.zeros(G, bool)
        self.cid_ds = np.full(Gd, len(L), np.int64)    # padding -> a pseudo-contig
        self.seg_start = np.zeros(Gd, np.int64)
        self.seg_end = np.zeros(Gd, np.int64)
        self.strat_valid = np.zeros(Gd, bool)
        self.fhat_idx = np.full(Gd, -1, np.int64)
        self.bucket_idx = np.full(Gd, -1, np.int64)
        wf = L // FHAT_WINDOW
        self.fhat_offsets = np.concatenate([[0], np.cumsum(wf)[:-1]]).astype(np.int64)
        self.n_fhat = int(wf.sum())
        nbk = L // BUCKET + 1
        boff = np.concatenate([[0], np.cumsum(nbk)[:-1]]).astype(np.int64)
        self.n_buckets = int(nbk.sum())
        self.bucket_lo = np.full(self.n_buckets, -1, np.int64)
        for c, s in enumerate(seqs):
            n, off = int(L[c]), int(self.offsets[c])
            self.seq[off:off + n] = s
            self.site_valid[off:off + n] = True
            r0, r1 = off // DS, (off + int(blk[c])) // DS
            local = np.arange(r1 - r0)
            self.cid_ds[r0:r1] = c
            self.seg_start[r0:r1] = r0
            self.seg_end[r0:r1] = r1
            self.strat_valid[r0:r1] = local < n // DS
            if wf[c] > 0:
                sel = local < -(-n // DS)
                w = np.minimum(local // (FHAT_WINDOW // DS), wf[c] - 1)
                self.fhat_idx[r0:r1][sel] = self.fhat_offsets[c] + w[sel]
            sel = local < n // DS
            b = np.minimum(local // (BUCKET // DS), nbk[c] - 1)
            self.bucket_idx[r0:r1][sel] = boff[c] + b[sel]
            nfull = n // BUCKET
            if nfull > 0:
                src = np.minimum(np.arange(nbk[c]), nfull - 1)
                self.bucket_lo[boff[c]:boff[c] + nbk[c]] = r0 + src * (BUCKET // DS)

    def strat_rows(self, c: int) -> tuple[int, int]:
        """(first row, rows) of contig c's published strategy."""
        return int(self.offsets[c]) // DS, int(self.lengths[c]) // DS

    def fhat_row(self, c: np.ndarray, start: np.ndarray) -> np.ndarray:
        """Global read-start window of a read starting at ``start`` on
        contig ``c``, or -1 where the start lies past the last whole window
        (np.histogram's edges: a start exactly on the last edge counts)."""
        wf = self.lengths[c] // FHAT_WINDOW
        ok = (wf > 0) & (start <= FHAT_WINDOW * wf)
        w = np.minimum(start // FHAT_WINDOW, np.maximum(wf - 1, 0))
        return np.where(ok, self.fhat_offsets[c] + w, -1)
