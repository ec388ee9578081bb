"""Empirical read-length distribution and its piecewise-constant CCL approx.

Host-side control-plane state (a 1M-bin histogram updated per batch and a
10-piece approximation of the complementary cumulative length distribution).
Semantics follow the reference's boss/readlengthdist.py: truncated-normal
prior (lambda=6000, sd=4000), reads shorter than 2*mu ignored, lengths capped
at 1M, eta=11 pieces, time_cost = lambda - mu - rho.
"""
from __future__ import annotations

import numpy as np

MAX_LEN = 1_000_000


class ReadLengthDist:
    def __init__(self, mu: int = 400, sd: int = 4000, lam: float = 6000.0, eta: int = 11):
        self.mu = mu
        self.sd = sd
        self.lam = lam
        self.eta = eta
        self.hist = np.zeros(MAX_LEN, dtype=np.int64)
        # truncated-normal prior density over plausible lengths
        x = np.arange(int(lam + 10 * sd), dtype=np.float64)
        dens = np.exp(-((x - lam + 1) ** 2) / (2.0 * sd**2))
        self.L = dens / dens.sum()
        self.approx_ccl = self._approx_ccl()
        self.time_cost = float(lam) - 400.0 - 300.0

    def update(self, lengths) -> None:
        """Record new (accepted) read lengths and refresh lambda/CCL/time_cost.

        lengths: iterable of ints or int array.
        """
        arr = np.asarray(list(lengths) if not isinstance(lengths, np.ndarray) else lengths)
        arr = arr[arr > self.mu * 2]
        if arr.size:
            np.add.at(self.hist, np.minimum(arr, MAX_LEN - 1), 1)
        nz = np.flatnonzero(self.hist)
        if nz.size == 0:
            return
        counts = self.hist[nz]
        self.lam = float((nz * counts).sum() / counts.sum())
        longest = int(nz[-1])
        self.L = self.hist[: longest + 1].astype(np.float64)
        self.L /= self.L.sum()
        self.approx_ccl = self._approx_ccl()
        self.time_cost = self.lam - 400.0 - 300.0

    def _approx_ccl(self) -> np.ndarray:
        """eta-1 piecewise-constant pieces of the complementary CDF.

        approx_ccl[p] is the length l such that P(read length >= l) first
        drops to 1 - (p + 0.5)/(eta - 1) (readlengthdist.py:72-97).
        """
        ccl = np.empty(self.L.shape[0] + 1)
        ccl[0] = 1.0
        ccl[1:-1] = 1.0 - np.cumsum(self.L[1:])
        ccl[-1] = 0.0
        ccl[ccl < 1e-6] = 0.0
        # trim trailing zeros but keep one
        last = np.flatnonzero(ccl)
        ccl = np.append(ccl[: last[-1] + 1], 0.0) if last.size else np.zeros(2)
        probs = 1.0 - (np.arange(self.eta - 1) + 0.5) / (self.eta - 1)
        # first index where ccl <= prob (ccl is non-increasing)
        out = np.searchsorted(-ccl, -probs, side="left")
        return out.astype(np.int32)
