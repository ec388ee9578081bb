"""Contig scoring, expected benefit and strategy threshold for BOSS-AEONS.

The port of ``bossruns_tpu.aeons.benefit`` (K10). Per batch, over the
current contigs (the reference's aeons/sequences.py semantics):

  * sigmoid low-coverage score 1/(exp(cov_mean - lowcov) + 1) per 100-site
    chunk, cov capped at 100 (Benefit.init_scoring_vec/score_array), with
    uncapped low-coverage contig ends set to 1 ("nodes of interest");
  * S_mu and the CCL-weighted benefit as segment-clamped window sums with
    virtual unit-score mass beyond uncapped ends;
  * the unweighted exponent-bin threshold scan, cs_u = cumsum(bin * count)
    + Σsmu, cs_t = cumsum(tc * count) + tbar0 with alpha = 200.

``contig_strategies`` builds the descriptor table on the host exactly as
the JAX function does (including the exact-chunk-sum end test) and then
runs one of two backends:

  * 'device' (and 'auto'): ``strategy`` — kernel H7
    (``csrc/aeons_strategy.cu``) on a CUDA device, or its plain PyTorch
    version ``strategy_plain`` on a CPU device the caller asked for;
  * 'host': ``_strategy_host``, a copy of the JAX package's production
    backend (per-contig NumPy, f64 sums), kept as the f64 reference.

Both sum in f64 per contig. The JAX device kernel ``_strategy_jit`` sums in
f32 over the whole flat pool, which moves mask bits when chunk means sit
near lowcov (ROADMAP Queue 3, F7); the port follows the host path, and its
masks equal ``_strategy_host``'s bit for bit. Scores come from a 101-entry
f32 table built with ``_strategy_host``'s own NumPy expression, so they are
bit-identical to the host path on every device.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..device import as_device
from ..ops import kernels as K

NODE = 100
NBINS = 192
#: CCL window weights, heaviest first (benefit.py's np.arange(0.1, 1.1, 0.1)[::-1])
AEONS_WEIGHTS = tuple(float(x) for x in np.arange(0.1, 1.1, 0.1)[::-1])
#: per-block Σsmu partials of H7's window launch (bk_grid's block cap)
SMU_PARTS = 132 * 32


def score_table(lowcov: float) -> np.ndarray:
    """f32 sigmoid scores of chunk means 0..100, by ``_strategy_host``'s
    expression (exp overflows to inf at large means: the score is then 0)."""
    cov = np.arange(101, dtype=np.uint8)
    with np.errstate(over="ignore"):
        return (1.0 / (np.exp(cov.astype(np.float32) - np.float32(lowcov)) + 1.0)).astype(
            np.float32)


def _threshold_scan(counts: list[int], norm: float, smu_sum: float, tc: float,
                    tbar0: float) -> float:
    """The 192-bin scan of ``_strategy_host`` in sequential f64."""
    su = st = 0.0
    best, kmax, used = -math.inf, -1, []
    for k, ck in enumerate(counts):
        su += math.ldexp(1.0, -k) * norm * ck
        st += tc * ck
        if ck <= 0:
            continue
        peak = (su + smu_sum) / (st + tbar0)
        if kmax < 0 or peak > best:
            best, kmax = peak, k
        used.append(k)
    after = [k for k in used if k > kmax]
    thr_idx = after[0] if after else used[-1]
    return math.ldexp(1.0, -thr_idx) * norm


def strategy_plain(cov: torch.Tensor, ends: torch.Tensor, flags: torch.Tensor,
                   table: torch.Tensor, wins: tuple, weights: tuple, tc: float,
                   tbar0: float):
    """Plain PyTorch version of H7 on any device.

    cov [n] uint8 chunk means; ends [C] int64 chunk-count prefix sums;
    flags [C] uint8 (bit 0 NOI left, 1 NOI right, 2 uncapped left, 3
    uncapped right); table [101] f32 scores; wins: the mu window and the 10
    CCL windows in chunks; weights: the 10 CCL weights. Returns (mask [n, 2]
    bool, threshold float, benefit [n, 2] f64). The per-contig prefix sums
    and the 192-bin scan run sequentially on the host, in ``np.cumsum``'s
    order (torch's CUDA cumsum is a parallel scan that rounds otherwise).
    """
    dev = cov.device
    n, C = cov.shape[0], ends.shape[0]
    f64 = torch.float64
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    rows = torch.arange(n, device=dev)
    cid = torch.searchsorted(ends, rows, right=True)
    i = rows - starts[cid]
    nc = (ends - starts)[cid]
    f = flags.to(torch.int64)[cid]
    sc = table[cov.to(torch.int64).clamp_max(100)]
    sc = torch.where((((f & 1) > 0) & (i == 0)) | (((f & 2) > 0) & (i == nc - 1)),
                     torch.ones_like(sc), sc)
    sc64 = sc.to(f64).cpu()
    cs = torch.zeros(n + C, dtype=f64)
    for c, (s0, s1) in enumerate(zip(starts.tolist(), ends.tolist())):
        if s1 > s0:
            cs[s0 + c + 1: s1 + c + 1] = torch.cumsum(sc64[s0:s1], 0)
    cs = cs.to(dev)
    base = (starts + torch.arange(C, device=dev))[cid]   # contig c's cs_c[0]
    el, er = (f & 4) > 0, (f & 8) > 0

    def fwd(w):
        v = cs[base + torch.clamp(i + w, max=nc)] - cs[base + i]
        return torch.where(er, v + (i + w - nc).clamp(0, w).to(f64), v)

    def rev(w):
        v = cs[base + i + 1] - cs[base + (i + 1 - w).clamp_min(0)]
        return torch.where(el, v + (w - 1 - i).clamp(0, w).to(f64), v)

    sf, sr = fwd(wins[0]), rev(wins[0])
    ef = torch.zeros(n, dtype=f64, device=dev)
    eb = torch.zeros(n, dtype=f64, device=dev)
    for wt, w in zip(weights, wins[1:]):
        ef = ef + wt * fwd(w)
        eb = eb + wt * rev(w)
    benefit = torch.stack([ef - sf, eb - sr], dim=1).clamp_min(0.0)
    b = benefit.reshape(-1)
    nz = b > 0
    if not bool(nz.any()):
        return torch.ones((n, 2), dtype=torch.bool, device=dev), 0.0, benefit
    norm = b.max()
    e = torch.frexp(b[nz] / norm).exponent
    counts = torch.bincount(e.abs().clamp_max(NBINS - 1).to(torch.int64), minlength=NBINS)
    # Σsmu in torch's order: differs from the host's pairwise sum in the
    # last bits only, which moves the threshold only on an exact tie
    thr = _threshold_scan(counts.tolist(), float(norm), float((sf + sr).sum()), tc, tbar0)
    return benefit >= thr, thr, benefit


def strategy(cov: torch.Tensor, ends: torch.Tensor, flags: torch.Tensor,
             table: torch.Tensor, wins: tuple, weights: tuple, tc: float, tbar0: float):
    """H7: the contig strategy mask, threshold and benefit (as
    ``strategy_plain``). A CPU tensor takes the plain version; a CUDA
    tensor launches csrc/aeons_strategy.cu (four launches) or raises."""
    if cov.device.type == "cpu":
        return strategy_plain(cov, ends, flags, table, wins, weights, tc, tbar0)
    dev = cov.device
    n, C = cov.shape[0], ends.shape[0]
    K.check(cov, "cov", torch.uint8, (n,))
    K.check(ends, "ends", torch.int64, (C,), dev)
    K.check(flags, "flags", torch.uint8, (C,), dev)
    K.check(table, "table", torch.float32, (101,), dev)
    wins = [int(w) for w in wins]
    if n == 0 or C == 0 or len(wins) != 11 or len(weights) != 10 or min(wins) < 1 \
            or max(wins) > 2**31 - 1:
        raise ValueError(f"aeons strategy: unsupported n={n} C={C} wins={wins}")
    f64 = torch.float64
    benefit = torch.empty((n, 2), dtype=f64, device=dev)
    mask = torch.empty((n, 2), dtype=torch.uint8, device=dev)
    threshold = torch.empty(1, dtype=f64, device=dev)
    scratch = dict(
        cs=torch.empty(n + C, dtype=f64, device=dev),
        smu_part=torch.empty(SMU_PARTS, dtype=f64, device=dev),
        norm_bits=torch.empty(1, dtype=torch.int64, device=dev),
        any_nz=torch.empty(1, dtype=torch.int32, device=dev),
        counts=torch.empty(NBINS, dtype=torch.int32, device=dev),
        tickets=torch.empty(2, dtype=torch.int32, device=dev),
        smu_sum=torch.empty(1, dtype=f64, device=dev),
    )
    a = K.AeonsArgs(
        n=n, C=C, win=(ctypes.c_int32 * 11)(*wins),
        weight=(ctypes.c_double * 10)(*weights), tc=float(tc), tbar0=float(tbar0),
        cov=cov.data_ptr(), ends=ends.data_ptr(), flags=flags.data_ptr(),
        table=table.data_ptr(), benefit=benefit.data_ptr(), threshold=threshold.data_ptr(),
        mask=mask.data_ptr(), **{k: v.data_ptr() for k, v in scratch.items()},
    )
    K.KERNELS["aeons_strategy"](a, K.stream_ptr(cov))
    return mask.bool(), float(threshold.item()), benefit


def _strategy_host(cov_mean_u8, nd, noi_l, noi_r, e_lc, e_rc,
                   lowcov, ccl_ds, mu_ds, tc, tbar0):
    """Vectorised NumPy path over the real chunk axis: sigmoid scores,
    virtual end mass, per-contig f64 cumsum windows, exponent-bin scan.
    Returns (mask [n,2] bool, thr). A copy of the JAX package's
    ``_strategy_host``: the f64 reference of H7."""
    n = cov_mean_u8.shape[0]
    nd = np.asarray(nd, np.int64)
    ends = np.cumsum(nd)
    starts = ends - nd
    wins = np.concatenate([[mu_ds], np.maximum(ccl_ds, 1)]).astype(np.int64)  # [11]
    wmax = int(wins.max())
    weights = np.arange(0.1, 1.1, 0.1)[::-1]
    smu = np.empty((n, 2))
    eb = np.zeros((n, 2))
    # per-contig blocks: each contig's cumsum + 22 shifted-slice windows stay
    # cache-resident; the clamped boundary windows come free from padding
    # the per-contig cumsum
    for ci in range(nd.shape[0]):
        s0, s1 = int(starts[ci]), int(ends[ci])
        nc = s1 - s0
        if nc <= 0:
            continue
        sc = (1.0 / (np.exp(cov_mean_u8[s0:s1].astype(np.float32)
                            - np.float32(lowcov)) + 1.0)).astype(np.float32)
        if noi_l[ci]:
            sc[0] = 1.0
        if noi_r[ci]:
            sc[-1] = 1.0
        cs = np.empty(nc + 1 + wmax, np.float64)
        cs[0] = 0.0
        np.cumsum(sc, dtype=np.float64, out=cs[1 : nc + 1])
        cs[nc + 1 :] = cs[nc]                      # right clamp
        cs_lo = np.concatenate([np.zeros(wmax), cs[: nc + 1]])  # left clamp
        r = np.arange(nc, dtype=np.int64)
        for j, w in enumerate(wins):
            f = cs[w : w + nc] - cs[:nc]
            rv = cs[1 : nc + 1] - cs_lo[wmax + 1 - w : wmax + 1 - w + nc]
            if e_rc[ci]:
                f = f + np.clip(r + w - nc, 0, w)
            if e_lc[ci]:
                rv = rv + np.clip(w - 1 - r, 0, w)
            if j == 0:
                smu[s0:s1, 0], smu[s0:s1, 1] = f, rv
            else:
                eb[s0:s1, 0] += weights[j - 1] * f
                eb[s0:s1, 1] += weights[j - 1] * rv
    benefit = np.maximum(eb - smu, 0.0)

    b = benefit.ravel()
    nzv = b[b > 0]
    if nzv.size == 0:
        return np.ones((n, 2), bool), 0.0
    norm = float(b.max())
    _m, e = np.frexp(nzv / norm)
    idx = np.minimum(np.abs(e), NBINS - 1)
    counts = np.bincount(idx, minlength=NBINS).astype(np.float64)
    used = counts > 0
    bin_ids = np.arange(NBINS)
    bbin = np.exp2(-bin_ids.astype(np.float64)) * norm
    cs_u = np.cumsum(bbin * counts) + float(smu.sum())
    cs_t = np.cumsum(tc * counts) + tbar0
    peak = np.where(used, cs_u / cs_t, -np.inf)
    kmax = int(np.argmax(peak))
    after = np.flatnonzero(used & (bin_ids > kmax))
    thr_idx = int(after[0]) if after.size else int(np.max(bin_ids[used]))
    thr = float(bbin[thr_idx])
    return benefit >= thr, thr


@dataclass
class StrategyInputs:
    """The host-side descriptor of a contig set, as the JAX function builds
    it: per-chunk means, chunk counts, end flags, windows and scan constants."""

    offsets: dict[str, tuple[int, int]]  # contig -> (first chunk, chunk count)
    cov: np.ndarray     # [n] uint8 min(floor(chunk sum / 100), 100)
    nd: np.ndarray      # [C] int64 chunk counts
    noi_l: np.ndarray   # [C] bool: uncapped low-coverage left end
    noi_r: np.ndarray   # [C] bool
    ccl_ds: np.ndarray  # [10] int32 CCL windows in chunks
    mu_ds: int
    lowcov: float
    tc: float
    tbar0: int

    @classmethod
    def build(cls, contigs, ccl, lam, lowcov=10.0, mu=400, end_lim=50) -> StrategyInputs:
        names = list(contigs)
        nd = np.array([-(-len(contigs[h].seq) // NODE) for h in names], np.int64)
        cov = np.zeros(int(nd.sum()), np.uint8)
        noi_l, noi_r = np.zeros(len(names), bool), np.zeros(len(names), bool)
        offsets = {}
        off = 0
        for ci, (h, ndch) in enumerate(zip(names, nd.tolist())):
            s = contigs[h]
            cc = np.add.reduceat(s.cov, np.arange(0, len(s.cov), NODE))
            cov[off : off + ndch] = np.minimum(cc // NODE, 100).astype(np.uint8)
            # contig-end nodes of interest (set_contig_ends): the end test
            # uses the EXACT chunk sum, so it stays host-side
            noi_l[ci] = not s.cap_l and cc[0] <= end_lim * NODE
            noi_r[ci] = not s.cap_r and cc[-1] <= end_lim * NODE
            offsets[h] = (off, ndch)
            off += ndch
        alpha, rho = 200 // NODE, 300 // NODE
        return cls(
            offsets=offsets, cov=cov, nd=nd, noi_l=noi_l, noi_r=noi_r,
            ccl_ds=np.maximum(np.asarray(ccl) // NODE, 1).astype(np.int32), mu_ds=mu // NODE,
            lowcov=lowcov, tc=max((lam - mu - 300) // NODE, 1.0), tbar0=alpha + rho + mu // NODE,
        )

    def device_args(self, device) -> tuple:
        """The arguments of ``strategy``/``strategy_plain`` on ``device``. An
        uncapped low-coverage end is both a node of interest and the start of
        virtual unit mass (the JAX descriptor's e_lc/e_rc equal noi_l/noi_r)."""
        flags = (self.noi_l | (self.noi_r << 1) | (self.noi_l << 2) | (self.noi_r << 3))
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        wins = (self.mu_ds, *np.maximum(self.ccl_ds, 1).tolist())
        return (up(self.cov), up(np.cumsum(self.nd)), up(flags.astype(np.uint8)),
                up(score_table(self.lowcov)), wins, AEONS_WEIGHTS, self.tc, self.tbar0)

    def run_host(self):
        """(mask [n, 2] bool, threshold) of ``_strategy_host``."""
        return _strategy_host(self.cov, self.nd, self.noi_l, self.noi_r, self.noi_l,
                              self.noi_r, self.lowcov, self.ccl_ds, self.mu_ds, self.tc,
                              self.tbar0)


def contig_strategies(
    contigs,  # dict[str, Sequence]
    ccl: np.ndarray,
    lam: float,
    lowcov: float = 10.0,
    mu: int = 400,
    end_lim: int = 50,
    *,
    device,
    backend: str = "auto",
) -> tuple[dict[str, np.ndarray], float]:
    """Per-contig strategy masks [(ceil(len/100), 2) bool] + threshold.

    backend: 'auto' or 'device' (H7 on a CUDA ``device``, the plain version
    on a CPU one) | 'host' (``_strategy_host``, whatever the device)."""
    if backend not in ("auto", "device", "host"):
        raise ValueError(f"unknown strategy backend {backend!r}")
    if not contigs:
        return {}, 0.0
    inp = StrategyInputs.build(contigs, ccl, lam, lowcov, mu, end_lim)
    if backend == "host":
        mask, thr = inp.run_host()
    else:
        mask_t, thr, _ = strategy(*inp.device_args(as_device(device)))
        mask = mask_t.cpu().numpy()
    return {h: mask[o : o + k] for h, (o, k) in inp.offsets.items()}, thr
