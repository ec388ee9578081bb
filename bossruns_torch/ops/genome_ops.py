"""Genome-axis ops of the update step: plain PyTorch versions and kernels.

The counterpart of ``bossruns_tpu/ops/genome_ops.py`` (scatter, window sums,
fhat, threshold scan) plus the coverage and row stages that the JAX package
keeps inline in ``models/runs.py``. Three wrappers here launch hand-written
CUDA kernels for CUDA tensors (``ops/kernels.py`` builds them):

  * ``coverage_update``  -> csrc/coverage.cu (H1)
  * ``row_stage``        -> csrc/rows.cu     (H3)
  * ``benefit_strategy`` -> csrc/strategy.cu (H4)

Each has a ``*_plain`` twin with the same signature, written in plain
PyTorch, which a wrapper takes only for CPU tensors. A CUDA tensor launches
the kernel or raises. The plain versions run on either device, so the
kernels can be held against them on the card.

Decision-path arithmetic is f64 and follows the JAX package's order of
operations, with its reduction-order-invariance contract: sums of
integer-valued or f32-rounded summands are exact in any order, so atomics
are used only for those.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..models.layout import BUCKET, DS
from . import kernels as K

EX_PAD = 0xFFFFFFFF
NBINS = 192

#: the 10 CCL piece weights 0.95..0.05, as the JAX package builds them
CCL_WEIGHTS = tuple(float(w) for w in np.arange(0.05, 1.0, 0.1)[::-1])


def widen(t: torch.Tensor) -> torch.Tensor:
    """uint16 -> int32 and uint32 -> int64 through a signed view (CUDA has
    no arithmetic on unsigned 16/32-bit tensors); other dtypes unchanged."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to(torch.int32) & 0xFFFF
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return t


# ----------------------------------------------------------------- scatter --

def scatter_add_3d(target, idx0, idx1, idx2, w):
    """target[idx0, idx1, idx2] += w with out-of-range entries dropped."""
    i = [widen(x).long() for x in (idx0, idx1, idx2)]
    ok = torch.ones_like(i[0], dtype=torch.bool)
    for ax, x in enumerate(i):
        ok &= (x >= 0) & (x < target.shape[ax])
    out = target.clone()
    out.index_put_(tuple(x[ok] for x in i), w.to(target.dtype)[ok], accumulate=True)
    return out


def scatter_add_2d(target, idx0, idx1, w):
    """target[idx0, idx1] += w with out-of-range entries dropped."""
    i0, i1 = widen(idx0).long(), widen(idx1).long()
    ok = (i0 >= 0) & (i0 < target.shape[0]) & (i1 >= 0) & (i1 < target.shape[1])
    out = target.clone()
    out.index_put_((i0[ok], i1[ok]), w.to(target.dtype)[ok], accumulate=True)
    return out


# ------------------------------------------------------------- window sums --

def _csum(x):
    """[..., N] -> [..., N+1] exclusive-prefix cumulative sum (>= f32)."""
    dt = torch.promote_types(x.dtype, torch.float32)
    cs = torch.cumsum(x, dim=-1, dtype=dt)
    return torch.cat([torch.zeros((*cs.shape[:-1], 1), dtype=dt, device=cs.device), cs], dim=-1)


def windowed_sums_fwd(cs, w, seg_end, rows):
    """out[..., r] = sum(x[r : min(r+w, seg_end[r])]) from cs = _csum(x)."""
    n = rows.shape[0]
    hi = torch.minimum(rows + w, seg_end.long())
    return cs[..., hi] - cs[..., :n]


def windowed_sums_rev(cs, w, seg_start, rows):
    """out[..., r] = sum(x[max(r+1-w, seg_start[r]) : r+1]) from cs = _csum(x)."""
    n = rows.shape[0]
    lo = torch.maximum(rows + 1 - w, seg_start.long())
    return cs[..., 1 : n + 1] - cs[..., lo]


def expected_benefit(scores_ds, approx_ccl_ds, seg_start, seg_end, mu_ds: int = 4):
    """(smu, benefit), both [..., N, 2], from downsampled scores [..., N].

    benefit = sum_i weight_i * window_sum(ccl_i) - smu, clipped >= 0, with
    the 10 CCL piece weights 0.95..0.05, accumulated as an unrolled
    sequential chain in the reference order (genome_ops.py:121-128).
    """
    n = scores_ds.shape[-1]
    rows = torch.arange(n, device=scores_ds.device)
    cs = _csum(scores_ds)
    wins = [max(int(w), 1) for w in approx_ccl_ds]

    def fwd(w):
        return windowed_sums_fwd(cs, w, seg_end, rows)

    def rev(w):
        return windowed_sums_rev(cs, w, seg_start, rows)

    smu = torch.stack([fwd(mu_ds), rev(mu_ds)], dim=-1)
    ebf = CCL_WEIGHTS[0] * fwd(wins[0])
    ebr = CCL_WEIGHTS[0] * rev(wins[0])
    for k in range(1, 10):
        ebf = ebf + CCL_WEIGHTS[k] * fwd(wins[k])
        ebr = ebr + CCL_WEIGHTS[k] * rev(wins[k])
    eb = torch.stack([ebf, ebr], dim=-1)
    return smu, torch.clamp_min(eb - smu, 0.0)


# ------------------------------------------------------------------- fhat ---

def fhat_pointmass(read_starts, row_valid, n_windows: int, alpha: float = 1.0, p0: float = 0.1):
    """Posterior-mean read-start probability per (window, strand), with a
    point mass at zero for unobserved windows (readstartdist.py:86-117).

    The port implements the production prior alpha == 1, where the beta
    function closes to B(1, z) = 1/z; a general alpha needs betaln."""
    if alpha != 1.0:
        raise NotImplementedError("fhat_pointmass: the port implements alpha == 1 only")
    csum = read_starts.sum()
    denom = 2.0 * n_windows * alpha + csum
    beta_num = 1.0 / ((2.0 * n_windows - 1.0) + csum)
    beta_denom = 1.0 / (2.0 * n_windows - 1.0)
    if beta_denom == 0:
        beta_denom = 1e-20
    p0_bit = p0 / (p0 + (1.0 - p0))
    expected_post = (1.0 - p0_bit * (beta_num / beta_denom)) * (alpha / denom)
    fh = torch.where(read_starts > 0, (alpha + read_starts) / denom, expected_post)
    return torch.where(row_valid[:, None], fh, 0.0)


# -------------------------------------------------------- threshold scan ----

def frexp_abs_exponent(x, nbins: int):
    """|numpy.frexp exponent| of positive floats, clamped to [0, nbins-1].

    Exact: torch.frexp on the value itself, f64 included. Zero and
    subnormal inputs go to the top bin, as in the JAX package (their
    benefit is ~0 and never near the threshold).
    """
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(x.dtype)
    _, e = torch.frexp(x)
    a = torch.clamp_max(e.abs(), nbins - 1)
    below = x.abs() < torch.finfo(x.dtype).tiny
    return torch.where(below, nbins - 1, a).long()


class ThresholdResult(NamedTuple):
    strat: torch.Tensor       # bool, same shape as benefit
    threshold: torch.Tensor   # 0-d
    any_nonzero: torch.Tensor  # 0-d bool


def bin_benefit(benefit, fhat, norm, nbins: int):
    """(counts, fsum) [nbins] exponent bins of benefit / norm. Counts are
    integers and fsum sums f32-rounded fhat weights: exact in any order."""
    dtype = benefit.dtype
    b = benefit.reshape(-1)
    f = fhat.reshape(-1).to(dtype)
    nz = b > 0
    norm_safe = torch.where(norm > 0, norm, 1.0)
    idx = frexp_abs_exponent(torch.where(nz, b / norm_safe, 1.0), nbins)
    counts = torch.zeros(nbins, dtype=torch.int64, device=b.device)
    counts.index_add_(0, idx, nz.long())
    fsum = torch.zeros(nbins, dtype=dtype, device=b.device)
    fsum.index_add_(0, idx, f * nz.to(dtype))
    return counts.to(dtype), fsum


def ubar0_partial(fhat, smu, dtype):
    """Sum of f32-rounded fhat*smu products (exact in any order)."""
    return (fhat.to(dtype) * smu.to(dtype)).float().to(dtype).sum()


def threshold_from_bins(counts, fsum, norm, ubar0, time_cost: float, nbins: int,
                        window: int = 100):
    """Threshold scan over exponent bins (sequences.py:565-649)."""
    dtype, dev = counts.dtype, counts.device
    alpha_t, rho_t, mu_t = 300 // window, 300 // window, 400 // window
    tc = float(time_cost) // window
    norm_safe = torch.where(norm > 0, norm, 1.0)
    used = counts > 0
    f_mean = torch.where(used, fsum / torch.clamp_min(counts, 1.0), 0.0)
    bin_ids = torch.arange(nbins, device=dev)
    # exact 2^-k from the exponent field (k <= 191, always a normal f64)
    pow2 = ((1023 - bin_ids) << 52).view(torch.float64).to(dtype)
    benefit_bin = pow2 * norm_safe
    tbar0 = float(alpha_t + rho_t + mu_t)
    cs_u = torch.cumsum(benefit_bin * f_mean * counts, 0) + ubar0
    cs_t = torch.cumsum(tc * counts * f_mean, 0) + tbar0
    peak = torch.where(used, cs_u / cs_t, -torch.inf)
    kmax = torch.argmax(peak)
    after = used & (bin_ids > kmax)
    nxt = torch.where(after, bin_ids, nbins).min()
    last_used = torch.where(used, bin_ids, -1).max()
    thr_idx = torch.where(nxt < nbins, nxt, last_used)
    return benefit_bin[torch.clamp_min(thr_idx, 0)]


def find_strategy(benefit, smu, fhat, time_cost: float, nbins: int = NBINS,
                  window: int = 100) -> ThresholdResult:
    """Global accept/reject threshold via binary-exponent binning."""
    dtype = benefit.dtype
    any_nz = (benefit > 0).any()
    norm = benefit.max()
    counts, fsum = bin_benefit(benefit, fhat, norm, nbins)
    ubar0 = ubar0_partial(fhat, smu, dtype)
    threshold = threshold_from_bins(counts, fsum, norm, ubar0, time_cost, nbins, window)
    return ThresholdResult(strat=benefit >= threshold, threshold=threshold, any_nonzero=any_nz)


# ====================================================== H1: coverage_update ==

class CovRows(NamedTuple):
    """One family of coverage rows: match runs and explicit observations.

    The read indices are needed only in the gated flow, where a row's read
    bit decides whether it survives."""

    mr_bc: torch.Tensor      # [RM] uint8
    mr_g: torch.Tensor       # [RM] uint32
    mr_len: torch.Tensor     # [RM] uint16, 0 = padding
    ex_bcsym: torch.Tensor   # [ME] uint16 bc*5 + sym
    ex_g: torch.Tensor       # [ME] uint32, EX_PAD = padding
    mr_read: torch.Tensor | None = None  # [RM] uint32
    ex_read: torch.Tensor | None = None  # [ME] uint32


def _gate(read, bits, want_on: bool):
    """True where bits[read] is set (== want_on); a read index outside
    [0, len(bits)) counts as unset."""
    r = widen(read).long()
    n = bits.shape[0]
    on = (r >= 0) & (r < n) & (bits[torch.clamp(r, 0, max(n - 1, 0))] != 0)
    return on == want_on


def _families(full, trunc, bits):
    if bits is None:
        return [(full, True)]
    if full.mr_read is None or full.ex_read is None or trunc is None \
            or trunc.mr_read is None or trunc.ex_read is None:
        raise ValueError("the gated flow needs both row families with read indices")
    return [(full, True), (trunc, False)]


#: sites per tile flag of the coverage kernels (TILE in csrc/coverage.cu)
COVERAGE_TILE = 4096


def coverage_update_plain(coverage, seq, full: CovRows, trunc: CovRows | None = None,
                          bits=None):
    """Plain version of H1: updates ``coverage`` [nb, 5, G] uint16 in place
    and returns changed [G] bool. Index math in int64 with explicit range
    masks; the uint16 store happens last (CPU torch has no uint16 adds)."""
    nb, _, G = coverage.shape
    dev = coverage.device
    nbG = nb * G
    bounds = torch.zeros(nbG + 1, dtype=torch.int64, device=dev)
    ex = torch.zeros(nb * 5 * G, dtype=torch.int64, device=dev)
    for rows, want in _families(full, trunc, bits):
        ln = widen(rows.mr_len).long()
        keep = ln > 0
        if bits is not None:
            keep &= _gate(rows.mr_read, bits, want)
        flat = rows.mr_bc.long() * G + widen(rows.mr_g)
        keep &= flat < nbG
        start, end = flat[keep], torch.clamp_max(flat + ln, nbG)[keep]
        bounds.index_add_(0, start, torch.ones_like(start))
        bounds.index_add_(0, end, -torch.ones_like(end))
        g = widen(rows.ex_g)
        keep = g != EX_PAD
        if bits is not None:
            keep &= _gate(rows.ex_read, bits, want)
        f = widen(rows.ex_bcsym).long() * G + g
        keep &= f < nb * 5 * G
        ex.index_add_(0, f[keep], torch.ones_like(f[keep]))
    match = torch.cumsum(bounds[:nbG], 0).reshape(nb, G)
    ex = ex.reshape(nb, 5, G)
    onehot = seq.long()[None, :] == torch.arange(5, device=dev)[:, None]  # [5, G]
    new = torch.clamp_max(widen(coverage).long() + ex + onehot[None] * match[:, None, :], 65535)
    coverage.view(torch.int16).copy_((new - 65536 * (new > 32767)).to(torch.int16))
    return (ex != 0).any(dim=1).any(dim=0) | (match != 0).any(dim=0)


def _check_coverage(coverage, seq) -> None:
    """Raise unless coverage [nb, 5, G] uint16 and seq [G] int8 are what the
    coverage kernels take (G % 4 == 0: combine works on quads of sites)."""
    nb, _, G = coverage.shape
    K.check(coverage, "coverage", torch.uint16, (nb, 5, G))
    K.check(seq, "seq", torch.int8, (G,), coverage.device)
    if G % 4 or coverage.data_ptr() % 8 or seq.data_ptr() % 4:
        raise ValueError(f"coverage kernels need G % 4 == 0, an 8-byte aligned coverage and a "
                         f"4-byte aligned seq, got G={G}")


def _coverage_call(kernel: str, coverage, args) -> torch.Tensor:
    """Launch a coverage entry point with ``args(changed, match, tiles)``
    (the call's own int32 match scratch, any contents, and zeroed tile
    flags, one per COVERAGE_TILE sites) and return changed [G] bool."""
    nb, _, G = coverage.shape
    dev = coverage.device
    changed = torch.empty(G, dtype=torch.bool, device=dev)
    match = torch.empty(nb * G, dtype=torch.int32, device=dev)
    tiles = torch.zeros(-(-G // COVERAGE_TILE), dtype=torch.uint8, device=dev)
    K.KERNELS[kernel](*args(changed, match, tiles), K.stream_ptr(coverage))
    return changed


def coverage_update(coverage, seq, full: CovRows, trunc: CovRows | None = None, bits=None):
    """H1: add one batch's coverage rows into ``coverage`` in place and
    return the per-site changed flag. Ungated: ``full`` alone. Gated
    (``bits`` given): a full row survives iff bits[read] == 1, a trunc row
    iff bits[read] == 0 (models/runs.py:409-460)."""
    if coverage.device.type == "cpu":
        return coverage_update_plain(coverage, seq, full, trunc, bits)
    nb, _, G = coverage.shape
    dev = coverage.device
    _check_coverage(coverage, seq)
    fams = _families(full, trunc, bits)
    for rows, _ in fams:
        n_mr, n_ex = rows.mr_len.shape[0], rows.ex_g.shape[0]
        K.check(rows.mr_bc, "mr_bc", torch.uint8, (n_mr,), dev)
        K.check(rows.mr_g, "mr_g", torch.uint32, (n_mr,), dev)
        K.check(rows.mr_len, "mr_len", torch.uint16, (n_mr,), dev)
        K.check(rows.ex_bcsym, "ex_bcsym", torch.uint16, (n_ex,), dev)
        K.check(rows.ex_g, "ex_g", torch.uint32, (n_ex,), dev)
        if bits is not None:
            K.check(rows.mr_read, "mr_read", torch.uint32, (n_mr,), dev)
            K.check(rows.ex_read, "ex_read", torch.uint32, (n_ex,), dev)
    if bits is not None:
        K.check(bits, "bits", torch.uint8, None, dev)
    f = full
    t = trunc if bits is not None else None
    p = K.ptr

    def fam_args(r, mr: bool):
        if r is None:
            return [None, None, None, 0] if not mr else [None, None, None, None, 0]
        if mr:
            return [p(r.mr_bc), p(r.mr_g), p(r.mr_len), p(r.mr_read), r.mr_len.shape[0]]
        return [p(r.ex_bcsym), p(r.ex_g), p(r.ex_read), r.ex_g.shape[0]]

    return _coverage_call("coverage_update", coverage, lambda changed, match, tl: (
        *fam_args(f, True), *fam_args(t, True), *fam_args(f, False), *fam_args(t, False),
        p(bits), 0 if bits is None else bits.shape[0], p(seq), p(coverage), p(changed),
        p(match), p(tl), nb, G))


# ============================================================ H3: row_stage ==

def row_stage_plain(*, scores, covsum, changed, zeroed, bucket_on, read_starts, aux,
                    rs_row, rs_strand, rs_w=None, rs_read=None, bits=None,
                    site_valid, contig_id_ds, contig_denom, win_id_ds, n_win_pad: int,
                    bucket_src, bucket_valid, fhat_idx, fhat_valid, fhat_rows, n_fhat: int,
                    n_real_sites: float, freeze_cov: int, dropout_mod: int,
                    dropout_min_mean: float, bucket_threshold: float, fhat_alpha: float,
                    fhat_p0: float, on_target: float):
    """Plain version of H3 (models/runs.py:592-663).

    In place: scores (dropout/sticky zeros), zeroed, bucket_on, read_starts,
    aux[0] (any bucket on) and aux[3] (mean coverage). Returns
    (scores_ds f64 [nb, Gd], fhat_exp f64 [Gd, 2])."""
    f64 = torch.float64
    nb, G = scores.shape
    Gd = G // DS
    dev = scores.device
    covsum_f = covsum.float()
    covsum_ds = covsum_f.reshape(nb, Gd, DS).sum(dim=2, dtype=f64)
    cid = contig_id_ds.long()
    per_contig = torch.zeros(contig_denom.shape[0], dtype=f64, device=dev)
    per_contig.index_add_(0, cid, covsum_ds.sum(dim=0))
    contig_mean = (per_contig / contig_denom).float()
    thr_ds = torch.floor(contig_mean / dropout_mod)[cid]
    active_ds = (contig_mean > dropout_min_mean)[cid]
    low = (covsum_f.reshape(nb, Gd, DS) <= thr_ds[None, :, None]).any(dim=0)
    drop_site = (low & active_ds[:, None]).reshape(G) & site_valid
    recomputed = changed[None, :] & ~(covsum >= freeze_cov)
    zero = (zeroed & ~recomputed) | drop_site[None, :]
    scores.masked_fill_(zero, 0.0)
    zeroed.copy_(zero)

    win = win_id_ds.long()
    row_off = torch.arange(nb, device=dev)[:, None] * n_win_pad
    win_idx = torch.where((win >= 0)[None, :], win[None, :] + row_off, nb * n_win_pad)
    winsums = torch.zeros(nb * n_win_pad + 1, dtype=f64, device=dev)
    winsums.index_add_(0, win_idx.reshape(-1), covsum_ds.reshape(-1))
    winsums = winsums[:-1].reshape(nb, n_win_pad)
    src = bucket_src.long()
    wsum = winsums[:, torch.clamp_min(src, 0)]
    bucket_mean = torch.where((src >= 0)[None, :], wsum / BUCKET, 0.0).float()
    bucket_on |= (bucket_mean >= bucket_threshold) & bucket_valid[None, :]
    aux[0] = bucket_on.any().float()

    # gated flow: a read start counts iff its read was accepted
    w = rs_w if rs_read is None else _gate(rs_read, bits, True).to(torch.float32)
    row, st = rs_row.long(), rs_strand.long()
    ok = (row >= 0) & (row < read_starts.shape[0]) & (st >= 0) & (st < 2)
    read_starts.view(-1).index_add_(0, (row * 2 + st)[ok], w[ok])
    fhat_w = fhat_pointmass(read_starts.to(f64), fhat_valid, n_fhat, fhat_alpha, fhat_p0)
    tot = torch.sum(fhat_w * fhat_rows[:, None])
    fidx = fhat_idx.long()
    fhat_exp = torch.where((fidx >= 0)[:, None], fhat_w[torch.clamp_min(fidx, 0)], 0.0)
    fhat_exp = fhat_exp * torch.where(tot > 0, on_target / tot, 0.0)
    fhat_exp = fhat_exp.float().to(f64)

    scores_ds = scores.reshape(nb, Gd, DS).sum(dim=2, dtype=f64)
    aux[3] = (covsum_ds.sum() / n_real_sites).float()
    return scores_ds, fhat_exp


def _check_rows(kw) -> None:
    """Raise unless the arguments of an H3 launch are the tensors it takes."""
    scores = kw["scores"]
    if kw["fhat_alpha"] != 1.0:
        raise NotImplementedError("the row_stage kernel implements fhat_alpha == 1 only")
    dev = scores.device
    nb, G = scores.shape
    Gd = G // DS
    c = K.check
    c(scores, "scores", torch.float32, (nb, G))
    c(kw["covsum"], "covsum", torch.int32, (nb, G), dev)
    c(kw["changed"], "changed", torch.bool, (G,), dev)
    c(kw["zeroed"], "zeroed", torch.bool, (nb, G), dev)
    c(kw["site_valid"], "site_valid", torch.bool, (G,), dev)
    n_c1 = kw["contig_denom"].shape[0]
    c(kw["contig_denom"], "contig_denom", torch.float64, (n_c1,), dev)
    c(kw["contig_id_ds"], "contig_id_ds", torch.int32, (Gd,), dev)
    c(kw["win_id_ds"], "win_id_ds", torch.int32, (Gd,), dev)
    nbk = kw["bucket_src"].shape[0]
    c(kw["bucket_src"], "bucket_src", torch.int32, (nbk,), dev)
    c(kw["bucket_valid"], "bucket_valid", torch.bool, (nbk,), dev)
    c(kw["bucket_on"], "bucket_on", torch.bool, (nb, nbk), dev)
    wf = kw["read_starts"].shape[0]
    c(kw["read_starts"], "read_starts", torch.float32, (wf, 2), dev)
    c(kw["fhat_valid"], "fhat_valid", torch.bool, (wf,), dev)
    c(kw["fhat_rows"], "fhat_rows", torch.float64, (wf,), dev)
    c(kw["fhat_idx"], "fhat_idx", torch.int32, (Gd,), dev)
    c(kw["aux"], "aux", torch.float32, (4,), dev)
    n_rs = kw["rs_row"].shape[0]
    c(kw["rs_row"], "rs_row", torch.int32, (n_rs,), dev)
    c(kw["rs_strand"], "rs_strand", torch.int32, (n_rs,), dev)
    if kw.get("rs_read") is not None:
        c(kw["rs_read"], "rs_read", torch.int32, (n_rs,), dev)
        c(kw["bits"], "bits", torch.uint8, None, dev)
    else:
        c(kw["rs_w"], "rs_w", torch.float32, (n_rs,), dev)
    # the kernels read per-site arrays as aligned quads of four sites
    if G % 4:
        raise ValueError(f"row kernels need G % 4 == 0, got G={G}")
    for k, align in (("covsum", 16), ("scores", 16), ("zeroed", 4), ("changed", 4),
                     ("site_valid", 4)):
        if kw[k].data_ptr() % align:
            raise ValueError(f"{k}: row kernels need a {align}-byte aligned base")


#: normaliser entries per block of H3's posterior launch (TAB_CHUNK in csrc/rows.cu)
ROW_TABLE_CHUNK = 256
#: keys of ``row_workspace`` that only the kernels' table launches use (no
#: plain version reads or writes them)
ROW_SCRATCH = ("tab", "slots")


def row_workspace(scores, contig_denom, n_win_pad: int, read_starts, low: bool = False) -> dict:
    """Outputs and scratch of H3 for ``scores`` [nb, G]: scores_ds, fhat_exp
    and the per-contig, per-window and fhat tables; ``low`` adds the
    per-site mask of the sharded step's low phase. ``tab`` (the read-start
    total, the any-bucket flag and the finished-block count) and ``slots``
    (one partial sum of the normaliser per posterior block) are the table
    launches' scratch."""
    nb, G = scores.shape
    dev, i64 = scores.device, torch.int64
    n_c1, wf = contig_denom.shape[0], read_starts.shape[0]
    return dict(
        scores_ds=torch.empty((nb, G // DS), dtype=torch.float64, device=dev),
        fhat_exp=torch.empty((G // DS, 2), dtype=torch.float64, device=dev),
        per_contig=torch.empty(n_c1, dtype=i64, device=dev),
        winsums=torch.empty(nb * n_win_pad, dtype=i64, device=dev),
        total=torch.empty(1, dtype=i64, device=dev),
        thr_c=torch.empty(n_c1, dtype=torch.float32, device=dev),
        active_c=torch.empty(n_c1, dtype=torch.uint8, device=dev),
        fhat_w=torch.empty(wf * 2, dtype=torch.float64, device=dev),
        scale=torch.empty(1, dtype=torch.float64, device=dev),
        low=torch.empty(G, dtype=torch.uint8, device=dev) if low else None,
        tab=torch.empty(4, dtype=i64, device=dev),
        slots=torch.empty(max(1, -(-2 * wf // ROW_TABLE_CHUNK)), dtype=torch.float64, device=dev),
    )


def _row_struct(kw, ws) -> K.RowArgs:
    nb, G = kw["scores"].shape
    n = kw["n_fhat"]
    alpha, p0 = kw["fhat_alpha"], kw["fhat_p0"]
    beta_denom = 1.0 / (2.0 * n - 1.0)
    bits = kw.get("bits")
    return K.RowArgs(
        nb=nb, G=G, n_c1=kw["contig_denom"].shape[0], nw_pad=kw["n_win_pad"],
        nbk=kw["bucket_src"].shape[0], n_bits=0 if bits is None else bits.shape[0],
        n_rs=kw["rs_row"].shape[0], wf=kw["read_starts"].shape[0],
        freeze_cov=kw["freeze_cov"], gated=int(kw.get("rs_read") is not None),
        dropout_mod=float(kw["dropout_mod"]), dropout_min_mean=kw["dropout_min_mean"],
        bucket_threshold=kw["bucket_threshold"], pad0=0.0,
        c_denom0=2.0 * n * alpha, c_bn0=2.0 * n - 1.0,
        beta_denom=beta_denom if beta_denom != 0 else 1e-20,
        p0_bit=p0 / (p0 + (1.0 - p0)), alpha=alpha, on_target=kw["on_target"],
        n_real_sites=kw["n_real_sites"],
        **{k: K.ptr(kw.get(k)) for k in (
            "covsum", "changed", "site_valid", "contig_id_ds", "contig_denom",
            "win_id_ds", "bucket_src", "bucket_valid", "rs_row", "rs_strand", "rs_w",
            "rs_read", "bits", "fhat_valid", "fhat_rows", "fhat_idx", "scores",
            "zeroed", "bucket_on", "read_starts", "aux")},
        **{k: K.ptr(v) for k, v in ws.items()},
        n_slots=ws["slots"].numel(),
    )


def row_stage(**kw):
    """H3: dropout, sticky zeroing, buckets and the read-start posterior.
    Same arguments, in-place updates and results as ``row_stage_plain``."""
    scores = kw["scores"]
    if scores.device.type == "cpu":
        return row_stage_plain(**kw)
    _check_rows(kw)
    ws = row_workspace(scores, kw["contig_denom"], kw["n_win_pad"], kw["read_starts"])
    K.KERNELS["row_stage"](_row_struct(kw, ws), K.stream_ptr(scores))
    return ws["scores_ds"], ws["fhat_exp"]


# ===================================================== H4: benefit_strategy ==

def benefit_strategy_plain(*, scores_ds, seg_start, seg_end, fhat_exp, bucket_on,
                           bucket_idx, strat_valid, strat, aux, mu_ds: int, windows,
                           time_cost: float, reference_quirks: bool = False):
    """Plain version of H4 (models/runs.py:666-687).

    windows: the 10 CCL windows in ds rows (>= 1). In place: strat (where
    the bucket gate is open and the step updates), aux[1] (updated) and
    aux[2] (threshold as f32); aux[0] (any bucket on) is read. Returns
    (smu, benefit) [nb, Gd, 2] f64 and the f64 threshold (0-d)."""
    smu, benefit = expected_benefit(scores_ds, windows, seg_start, seg_end, mu_ds=mu_ds)
    fhat_b = fhat_exp[None].expand_as(benefit)
    res = find_strategy(benefit, benefit if reference_quirks else smu, fhat_b, time_cost)
    bidx = bucket_idx.long()
    gate = bucket_on[:, torch.clamp_min(bidx, 0)] & (bidx >= 0)[None, :]
    do_update = (aux[0] > 0) & res.any_nonzero
    write = do_update & gate & strat_valid[None, :]
    strat.copy_(torch.where(write[:, :, None], res.strat, strat))
    aux[1] = do_update.float()
    aux[2] = res.threshold.float()
    return smu, benefit, res.threshold


def _check_benefit(kw) -> tuple[int, list[int]]:
    """Raise unless the arguments of an H4 launch are the tensors it takes;
    returns the bucket count and the 10 CCL windows (>= 1)."""
    scores_ds = kw["scores_ds"]
    dev = scores_ds.device
    nb, Gd = scores_ds.shape
    c = K.check
    c(scores_ds, "scores_ds", torch.float64, (nb, Gd))
    for k in ("seg_start", "seg_end", "bucket_idx"):
        c(kw[k], k, torch.int32, (Gd,), dev)
    c(kw["strat_valid"], "strat_valid", torch.bool, (Gd,), dev)
    c(kw["fhat_exp"], "fhat_exp", torch.float64, (Gd, 2), dev)
    nbk = kw["bucket_on"].shape[1]
    c(kw["bucket_on"], "bucket_on", torch.bool, (nb, nbk), dev)
    c(kw["strat"], "strat", torch.bool, (nb, Gd, 2), dev)
    c(kw["aux"], "aux", torch.float32, (4,), dev)
    windows = [max(int(w), 1) for w in kw["windows"]]
    if len(windows) != 10:
        raise ValueError("expected 10 CCL windows")
    return nbk, windows


def benefit_strategy(**kw):
    """H4: benefit windows, exponent-binned threshold and the gated strategy
    write. Same arguments, in-place updates and results as
    ``benefit_strategy_plain``."""
    scores_ds = kw["scores_ds"]
    if scores_ds.device.type == "cpu":
        return benefit_strategy_plain(**kw)
    dev = scores_ds.device
    nb, Gd = scores_ds.shape
    nbk, windows = _check_benefit(kw)

    f64 = torch.float64
    smu = torch.empty((nb, Gd, 2), dtype=f64, device=dev)
    benefit = torch.empty((nb, Gd, 2), dtype=f64, device=dev)
    threshold = torch.empty((), dtype=f64, device=dev)
    n_tiles = -(-Gd // 4096)
    scratch = dict(
        cs=torch.empty(nb * (Gd + 1), dtype=f64, device=dev),
        tile_sums=torch.empty(nb * n_tiles, dtype=f64, device=dev),
        norm_bits=torch.empty(1, dtype=torch.int64, device=dev),
        any_nz=torch.empty(1, dtype=torch.int32, device=dev),
        counts=torch.empty(NBINS, dtype=torch.int32, device=dev),
        fsum=torch.empty(NBINS, dtype=f64, device=dev),
        ubar0=torch.empty(1, dtype=f64, device=dev),
    )
    a = K.StratArgs(
        nb=nb, Gd=Gd, nbk=nbk, mu_ds=int(kw["mu_ds"]),
        quirks=int(kw.get("reference_quirks", False)),
        win=(ctypes.c_int32 * 10)(*windows),
        weight=(ctypes.c_double * 10)(*CCL_WEIGHTS),
        tc=float(kw["time_cost"]) // 100,
        smu=smu.data_ptr(), benefit=benefit.data_ptr(), threshold=threshold.data_ptr(),
        **{k: kw[k].data_ptr() for k in (
            "scores_ds", "seg_start", "seg_end", "fhat_exp", "bucket_on", "bucket_idx",
            "strat_valid", "strat", "aux")},
        **{k: v.data_ptr() for k, v in scratch.items()},
        row0=0, halo=0, cs_stride=Gd + 1, n_tiles_g=n_tiles, tile0=0,
        ext=scratch["cs"].data_ptr(), tiles_g=scratch["tile_sums"].data_ptr(),
    )
    K.KERNELS["benefit_strategy"](a, K.stream_ptr(scores_ds))
    return smu, benefit, threshold


# ================================== H8: one shard of the sharded update step ==
#
# The sharded step (parallel/mesh.py) splits H1, H3 and H4 at the
# collectives of bossruns_tpu/parallel/mesh.py:209 (K11). Each wrapper below
# runs one shard, one phase per call, on the shard's blocks: coverage
# [nb_l, 5, Gl], scores [nb_l, Gl], ds rows [nb_l, Gdl], with b0, g0 and row0
# the shard's global barcode, site and ds-row offsets. Phases keep their
# outputs in a workspace dict that the caller reduces across shards in
# between. CPU tensors take the plain versions, CUDA tensors the kernels.

ROW_PHASES = ("sums", "tables", "low", "apply")
BENEFIT_PHASES = ("scan", "prefix", "windows", "bins", "threshold")
#: rows per tile of H4's scan; the plain version scans a shard as one tile
SCAN_TILE = 4096


def local_run_indices(mr_bc, mr_g, mr_len, b0: int, g0: int, nb_l: int, Gl: int):
    """Shard-local flat indices of the match-run start and end markers
    (int64), with nb_l*Gl marking rows whose marker lies outside the shard.
    Positions wrap in uint32 as in bossruns_tpu.parallel.mesh: a position
    left of the shard wraps to a huge value and fails the ``< Gl`` test."""
    oob = nb_l * Gl
    bc_l = mr_bc.long() - b0
    ln = widen(mr_len).long()
    on_row = (bc_l >= 0) & (bc_l < nb_l) & (ln > 0)
    g = widen(mr_g).long()
    st_u = (g - g0) & 0xFFFFFFFF
    en_u = (g + ln - g0) & 0xFFFFFFFF
    idx_s = torch.where(on_row & (st_u < Gl), bc_l * Gl + st_u, oob)
    idx_e = torch.where(on_row & (en_u < Gl), bc_l * Gl + en_u, oob)
    return idx_s, idx_e


def local_ex_indices(ex_bcsym, ex_g, b0: int, g0: int, nb_l: int, Gl: int):
    """Shard-local flat indices ((bc_l*5 + sym)*Gl + g_l) of explicit
    observations (int64), with nb_l*5*Gl marking rows outside the shard;
    EX_PAD rows wrap to a huge local position and fail the ``< Gl`` test."""
    oob = nb_l * 5 * Gl
    bsym = widen(ex_bcsym).long()
    bc_e = bsym // 5 - b0
    g_ue = (widen(ex_g).long() - g0) & 0xFFFFFFFF
    ok = (bc_e >= 0) & (bc_e < nb_l) & (g_ue < Gl)
    return torch.where(ok, (bc_e * 5 + bsym % 5) * Gl + g_ue, oob)


def shard_coverage_plain(coverage, seq, full: CovRows, b0: int, g0: int):
    """Plain version of H8's coverage entry: ``coverage_update`` of one
    shard (ungated), rows in global barcodes and positions. The markers of
    ``local_run_indices`` plus a carry at the shard's first site: the runs
    that start left of it and end in it or right of it, which the
    replicated batch gives each shard directly (the JAX step all-gathers
    the shards' net marker counts instead)."""
    nb, _, G = coverage.shape
    dev = coverage.device
    oob = nb * G
    idx_s, idx_e = local_run_indices(full.mr_bc, full.mr_g, full.mr_len, b0, g0, nb, G)
    bounds = torch.zeros(oob + 1, dtype=torch.int64, device=dev)
    bounds.index_add_(0, idx_s, torch.ones_like(idx_s))
    bounds.index_add_(0, idx_e, -torch.ones_like(idx_e))
    bounds = bounds[:oob].reshape(nb, G)
    bc_l = full.mr_bc.long() - b0
    g = widen(full.mr_g).long()
    ln = widen(full.mr_len).long()
    carried = (bc_l >= 0) & (bc_l < nb) & (ln > 0) & (g < g0) & (g + ln >= g0)
    bounds[:, 0] += torch.bincount(bc_l[carried], minlength=nb)[:nb]
    match = torch.cumsum(bounds, dim=1)
    idx = local_ex_indices(full.ex_bcsym, full.ex_g, b0, g0, nb, G)
    ex = torch.zeros(nb * 5 * G + 1, dtype=torch.int64, device=dev)
    ex.index_add_(0, idx, torch.ones_like(idx))
    ex = ex[:-1].reshape(nb, 5, G)
    onehot = seq.long()[None, :] == torch.arange(5, device=dev)[:, None]
    new = torch.clamp_max(widen(coverage).long() + ex + onehot[None] * match[:, None, :], 65535)
    coverage.view(torch.int16).copy_((new - 65536 * (new > 32767)).to(torch.int16))
    return (ex != 0).any(dim=1).any(dim=0) | (match != 0).any(dim=0)


def shard_coverage(coverage, seq, full: CovRows, b0: int, g0: int):
    """H8, coverage: add the batch's rows that fall in this shard's window
    (barcodes [b0, b0+nb_l), sites [g0, g0+Gl)) into its coverage block in
    place and return its changed [Gl] flags. Runs are clipped to the
    window; per-base adds need no carry across shards."""
    if coverage.device.type == "cpu":
        return shard_coverage_plain(coverage, seq, full, b0, g0)
    nb, _, G = coverage.shape
    dev = coverage.device
    _check_coverage(coverage, seq)
    n_mr, n_ex = full.mr_len.shape[0], full.ex_g.shape[0]
    K.check(full.mr_bc, "mr_bc", torch.uint8, (n_mr,), dev)
    K.check(full.mr_g, "mr_g", torch.uint32, (n_mr,), dev)
    K.check(full.mr_len, "mr_len", torch.uint16, (n_mr,), dev)
    K.check(full.ex_bcsym, "ex_bcsym", torch.uint16, (n_ex,), dev)
    K.check(full.ex_g, "ex_g", torch.uint32, (n_ex,), dev)
    p = K.ptr
    return _coverage_call("shard_coverage", coverage, lambda changed, match, tl: (
        p(full.mr_bc), p(full.mr_g), p(full.mr_len), n_mr, p(full.ex_bcsym), p(full.ex_g), n_ex,
        p(seq), p(coverage), p(changed), p(match), p(tl), int(b0), int(g0), nb, G))


def shard_rows_plain(phase: str, ws: dict, **kw) -> None:
    """Plain version of H8's row entry: one phase of ``row_stage_plain`` on
    one shard (arguments as row_stage's), its outputs in ``ws``
    (``row_workspace``). sums: per_contig, winsums and total in int64;
    tables: the dropout and fhat tables, bucket switches, read starts,
    aux[0] and aux[3]; low: the any-barcode low mask; apply: the zeroing,
    scores_ds and fhat_exp (reading ws["low"] when it exists)."""
    f64 = torch.float64
    scores, covsum = kw["scores"], kw["covsum"]
    nb, G = scores.shape
    Gd = G // DS
    dev = scores.device
    cid = kw["contig_id_ds"].long()
    if phase == "sums":
        covsum_ds = covsum.long().reshape(nb, Gd, DS).sum(dim=2)
        ws["per_contig"].zero_().index_add_(0, cid, covsum_ds.sum(dim=0))
        nw = kw["n_win_pad"]
        win = kw["win_id_ds"].long()
        row_off = torch.arange(nb, device=dev)[:, None] * nw
        win_idx = torch.where((win >= 0)[None, :], win[None, :] + row_off, nb * nw)
        sums = torch.zeros(nb * nw + 1, dtype=torch.int64, device=dev)
        sums.index_add_(0, win_idx.reshape(-1), covsum_ds.reshape(-1))
        ws["winsums"].copy_(sums[:-1])
        ws["total"].copy_(covsum_ds.sum().reshape(1))
    elif phase == "tables":
        contig_mean = (ws["per_contig"].to(f64) / kw["contig_denom"]).float()
        ws["thr_c"].copy_(torch.floor(contig_mean / kw["dropout_mod"]))
        ws["active_c"].copy_(contig_mean > kw["dropout_min_mean"])
        winsums = ws["winsums"].to(f64).reshape(nb, kw["n_win_pad"])
        src = kw["bucket_src"].long()
        wsum = winsums[:, torch.clamp_min(src, 0)]
        bucket_mean = torch.where((src >= 0)[None, :], wsum / BUCKET, 0.0).float()
        bucket_on = kw["bucket_on"]
        bucket_on |= (bucket_mean >= kw["bucket_threshold"]) & kw["bucket_valid"][None, :]
        aux = kw["aux"]
        aux[0] = bucket_on.any().float()
        read_starts = kw["read_starts"]
        rs_read = kw.get("rs_read")
        w = kw["rs_w"] if rs_read is None else _gate(rs_read, kw["bits"], True).float()
        row, st = kw["rs_row"].long(), kw["rs_strand"].long()
        ok = (row >= 0) & (row < read_starts.shape[0]) & (st >= 0) & (st < 2)
        read_starts.view(-1).index_add_(0, (row * 2 + st)[ok], w[ok])
        fhat_w = fhat_pointmass(read_starts.to(f64), kw["fhat_valid"], kw["n_fhat"],
                                kw["fhat_alpha"], kw["fhat_p0"])
        tot = torch.sum(fhat_w * kw["fhat_rows"][:, None])
        ws["fhat_w"].copy_(fhat_w.reshape(-1))
        ws["scale"].copy_(torch.where(tot > 0, kw["on_target"] / tot, 0.0).reshape(1))
        aux[3] = (ws["total"].to(f64)[0] / kw["n_real_sites"]).float()
    elif phase == "low":
        thr_ds = ws["thr_c"][cid]
        low = (covsum.float().reshape(nb, Gd, DS) <= thr_ds[None, :, None]).any(dim=0)
        ws["low"].copy_(low.reshape(G))
    elif phase == "apply":
        if ws.get("low") is not None:
            low = ws["low"].bool().reshape(Gd, DS)
        else:
            thr_ds = ws["thr_c"][cid]
            low = (covsum.float().reshape(nb, Gd, DS) <= thr_ds[None, :, None]).any(dim=0)
        active_ds = ws["active_c"].bool()[cid]
        drop_site = (low & active_ds[:, None]).reshape(G) & kw["site_valid"]
        recomputed = kw["changed"][None, :] & ~(covsum >= kw["freeze_cov"])
        zeroed = kw["zeroed"]
        zero = (zeroed & ~recomputed) | drop_site[None, :]
        scores.masked_fill_(zero, 0.0)
        zeroed.copy_(zero)
        ws["scores_ds"].copy_(scores.reshape(nb, Gd, DS).sum(dim=2, dtype=f64))
        fidx = kw["fhat_idx"].long()
        fhat_w = ws["fhat_w"].reshape(-1, 2)
        fhat_exp = torch.where((fidx >= 0)[:, None], fhat_w[torch.clamp_min(fidx, 0)], 0.0)
        ws["fhat_exp"].copy_((fhat_exp * ws["scale"]).float().to(f64))
    else:
        raise ValueError(f"unknown row phase {phase!r}")


def shard_rows(phase: str, ws: dict, **kw) -> None:
    """H8, rows: one phase (``ROW_PHASES``) of H3 on one shard. Same
    arguments, in-place updates and workspace as ``shard_rows_plain``."""
    scores = kw["scores"]
    if scores.device.type == "cpu":
        return shard_rows_plain(phase, ws, **kw)
    if phase not in ROW_PHASES:
        raise ValueError(f"unknown row phase {phase!r}")
    if phase == "low" and ws.get("low") is None:
        raise ValueError("the low phase needs a workspace made with low=True")
    _check_rows(kw)
    K.KERNELS["shard_rows"](_row_struct(kw, ws), ROW_PHASES.index(phase), K.stream_ptr(scores))
    return None


def benefit_workspace(scores_ds) -> dict:
    """Outputs and scratch of H8's benefit entry for scores_ds [nb_l, Gdl]:
    the tile-local cumsum and its tile totals (H4's 4096-row tiles), smu,
    benefit, the norm (f64, reduced as a max), any-nonzero,
    the bins, ubar0 and the threshold. The caller adds ``tiles_g`` (the
    gathered tile totals), ``tile0`` (this shard's first tile in it) and
    ``ext`` (the halo-extended cumsum)."""
    nb, Gd = scores_ds.shape
    dev, f64 = scores_ds.device, torch.float64
    n_tiles = -(-Gd // SCAN_TILE)
    return dict(
        cs=torch.empty((nb, Gd + 1), dtype=f64, device=dev),
        tile_sums=torch.empty((nb, n_tiles), dtype=f64, device=dev),
        smu=torch.empty((nb, Gd, 2), dtype=f64, device=dev),
        benefit=torch.empty((nb, Gd, 2), dtype=f64, device=dev),
        norm=torch.empty(1, dtype=f64, device=dev),
        any_nz=torch.empty(1, dtype=torch.int32, device=dev),
        counts=torch.empty(NBINS, dtype=torch.int32, device=dev),
        fsum=torch.empty(NBINS, dtype=f64, device=dev),
        ubar0=torch.empty(1, dtype=f64, device=dev),
        threshold=torch.empty((), dtype=f64, device=dev),
        tiles_g=None, tile0=0, ext=None,
    )


def shard_benefit_plain(phase: str, ws: dict, *, scores_ds, seg_start, seg_end, fhat_exp,
                        bucket_on, bucket_idx, strat_valid, strat, aux, mu_ds: int, windows,
                        time_cost: float, row0: int, halo: int,
                        reference_quirks: bool = False) -> None:
    """Plain version of H8's benefit entry: one phase of
    ``benefit_strategy_plain`` on one shard, its outputs in ``ws``
    (``benefit_workspace``). seg_start/seg_end hold global ds rows; windows
    are at most ``halo`` rows. scan: the cumsum of each SCAN_TILE-row tile
    from zero, and the tile totals; prefix: add each tile's exclusive
    prefix over the gathered totals (global tile order, summed
    sequentially); windows: smu, benefit,
    norm, any-nonzero and ubar0 from the halo-extended cumsum; bins: counts
    and fsum against the (reduced) norm; threshold: the threshold scan and
    the gated strategy write."""
    f64 = torch.float64
    nb, Gd = scores_ds.shape
    n_tiles = ws["tile_sums"].shape[1]
    if phase == "scan":
        x = torch.zeros((nb, n_tiles * SCAN_TILE), dtype=f64, device=scores_ds.device)
        x[:, :Gd] = scores_ds
        cs = torch.cumsum(x.reshape(nb, n_tiles, SCAN_TILE), dim=2)
        ws["cs"][:, 1:] = cs.reshape(nb, -1)[:, :Gd]  # column 0 is set by the prefix
        ws["tile_sums"].copy_(cs[:, :, -1])
        for k in ("norm", "any_nz", "counts", "fsum", "ubar0"):  # as the kernel's memsets
            ws[k].zero_()
    elif phase == "prefix":
        # in place, as the kernel: the gathered totals become their
        # exclusive prefix, summed sequentially in global tile order
        tiles, t0 = ws["tiles_g"], ws["tile0"]
        run = torch.zeros(nb, dtype=f64, device=tiles.device)
        for t in range(tiles.shape[1]):
            total = tiles[:, t].clone()
            tiles[:, t] = run
            run = run + total
        pre = tiles[:, t0: t0 + n_tiles]
        ws["cs"][:, 1:] += pre.repeat_interleave(SCAN_TILE, dim=1)[:, :Gd]
        ws["cs"][:, 0] = pre[:, 0]
    elif phase == "windows":
        ext = ws["ext"]
        dev = ext.device
        rows_g = row0 + torch.arange(Gd, device=dev)
        seg_s, seg_e = seg_start.long(), seg_end.long()
        # a segment bound beyond the halo is never selected (a window stops
        # inside the halo), so its clamped gather is a placeholder
        off, last = halo - row0, ext.shape[1] - 1
        cs_end = ext[:, torch.clamp(seg_e + off, 0, last)]
        cs_start = ext[:, torch.clamp(seg_s + off, 0, last)]
        base = ext[:, halo: halo + Gd]
        base1 = ext[:, halo + 1: halo + 1 + Gd]

        def fwd(w):
            shifted = ext[:, halo + w: halo + w + Gd]
            return torch.where(rows_g + w <= seg_e, shifted, cs_end) - base

        def rev(w):
            shifted = ext[:, halo + 1 - w: halo + 1 - w + Gd]
            return base1 - torch.where(rows_g + 1 - w >= seg_s, shifted, cs_start)

        smu = torch.stack([fwd(mu_ds), rev(mu_ds)], dim=-1)
        ebf = CCL_WEIGHTS[0] * fwd(windows[0])
        ebr = CCL_WEIGHTS[0] * rev(windows[0])
        for k in range(1, 10):
            ebf = ebf + CCL_WEIGHTS[k] * fwd(windows[k])
            ebr = ebr + CCL_WEIGHTS[k] * rev(windows[k])
        benefit = torch.clamp_min(torch.stack([ebf, ebr], dim=-1) - smu, 0.0)
        ws["smu"].copy_(smu)
        ws["benefit"].copy_(benefit)
        ws["norm"].copy_(benefit.max().reshape(1))
        ws["any_nz"].copy_((benefit > 0).any().reshape(1))
        fhat_b = fhat_exp[None].expand_as(benefit)
        ws["ubar0"].copy_(ubar0_partial(fhat_b, benefit if reference_quirks else smu, f64)
                          .reshape(1))
    elif phase == "bins":
        benefit = ws["benefit"]
        counts, fsum = bin_benefit(benefit, fhat_exp[None].expand_as(benefit), ws["norm"][0],
                                   NBINS)
        ws["counts"].copy_(counts)
        ws["fsum"].copy_(fsum)
    elif phase == "threshold":
        threshold = threshold_from_bins(ws["counts"].to(f64), ws["fsum"], ws["norm"][0],
                                        ws["ubar0"][0], time_cost, NBINS)
        bidx = bucket_idx.long()
        gate = bucket_on[:, torch.clamp_min(bidx, 0)] & (bidx >= 0)[None, :]
        do_update = (aux[0] > 0) & (ws["any_nz"][0] > 0)
        write = do_update & gate & strat_valid[None, :]
        strat.copy_(torch.where(write[:, :, None], ws["benefit"] >= threshold, strat))
        aux[1] = do_update.float()
        aux[2] = threshold.float()
        ws["threshold"].copy_(threshold)
    else:
        raise ValueError(f"unknown benefit phase {phase!r}")


def shard_benefit(phase: str, ws: dict, **kw) -> None:
    """H8, benefit: one phase (``BENEFIT_PHASES``) of H4 on one shard.
    Same arguments, in-place updates and workspace as
    ``shard_benefit_plain``."""
    scores_ds = kw["scores_ds"]
    if scores_ds.device.type == "cpu":
        return shard_benefit_plain(phase, ws, **kw)
    if phase not in BENEFIT_PHASES:
        raise ValueError(f"unknown benefit phase {phase!r}")
    dev = scores_ds.device
    nb, Gd = scores_ds.shape
    nbk, windows = _check_benefit(kw)
    halo = int(kw["halo"])
    if max(windows + [int(kw["mu_ds"])]) > max(halo, 1):
        raise ValueError("the CCL windows must be at most halo rows")
    ext, tiles = ws["ext"], ws["tiles_g"]
    if phase == "prefix":
        K.check(tiles, "tiles_g", torch.float64, (nb, tiles.shape[1]), dev)
    if phase == "windows":
        K.check(ext, "ext", torch.float64, (nb, Gd + 1 + 2 * halo), dev)
    a = K.StratArgs(
        nb=nb, Gd=Gd, nbk=nbk, mu_ds=int(kw["mu_ds"]),
        quirks=int(kw.get("reference_quirks", False)),
        win=(ctypes.c_int32 * 10)(*windows),
        weight=(ctypes.c_double * 10)(*CCL_WEIGHTS),
        tc=float(kw["time_cost"]) // 100,
        **{k: kw[k].data_ptr() for k in (
            "scores_ds", "seg_start", "seg_end", "fhat_exp", "bucket_on", "bucket_idx",
            "strat_valid", "strat", "aux")},
        **{k: ws[k].data_ptr() for k in (
            "smu", "benefit", "threshold", "cs", "tile_sums", "any_nz", "counts", "fsum",
            "ubar0")},
        norm_bits=ws["norm"].data_ptr(),
        row0=int(kw["row0"]), halo=halo, cs_stride=Gd + 1 + 2 * halo,
        n_tiles_g=0 if tiles is None else tiles.shape[1], tile0=int(ws["tile0"]),
        ext=K.ptr(ext), tiles_g=K.ptr(tiles),
    )
    K.KERNELS["shard_benefit"](a, BENEFIT_PHASES.index(phase), K.stream_ptr(scores_ds))
    return None


# ------------------------------------------------------------- host helper --

def estimate_fhat_priors(read_starts: np.ndarray) -> tuple[float, float]:
    """Method-of-moments estimate of the Dirichlet concentration alpha and
    the zero-window point mass p0 from accumulated read-start counts
    (readstartdist.py:156-178). NumPy, copied from the JAX package's
    genome_ops, whose module imports JAX."""
    merged = np.asarray(read_starts, np.float64)
    n_windows = merged.shape[0]
    p0 = np.count_nonzero(merged == 0) / (n_windows * 2)
    csum = np.sum(merged) or 1e-30
    fhat = merged / csum
    vhat = np.var(fhat, ddof=0) or 1e-30
    lhs = (2 * n_windows - 1) / (vhat * 8 * (n_windows**3))
    alpha = float(lhs - 1 / (2 * n_windows))
    return alpha, float(p0)
