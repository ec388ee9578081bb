"""Per-site expected-information scores (PyTorch port of ``ops/scores.py``).

The score of a site is the mutual information between the next observed
symbol and the genotype, in the closed form of ``bossruns_tpu.ops.scores``:

    score = sum_g p[g] * k[g]  -  sum_b q[b] * log q[b]
    k[g]  = sum_b phi[b,g] * log phi[b,g],   q = phi @ p

``site_scores_t`` is the plain PyTorch version (genome on the last axis).
``site_scores`` adds the engine's masking (max(.,0), site validity, the
freeze at ``freeze_cov``) and launches kernel H2 (csrc/scores.cu) for CUDA
tensors. The JAX package's ``site_scores_t_scan`` block loop is not ported:
it only capped [genotypes, G] temporaries, which a per-site kernel never
creates. Counts are clipped at 990 like the reference (sequences.py:493).

With f16 tables (``RunsConfig(dtype="float16")``) the plain version
follows the JAX engine's f16 program as XLA compiles it on the CPU, which
rounds to f16 after every op: each contraction (an f16 dot) is an f32 sum
of exact products, rounded once, in the addition tree of XLA's CPU dot
(``_contract_lanes``; pinned with cancelling pairs of +-2^30 terms, which
show where each pair of terms first meets, at 4, 5, 10 and 15 terms); each
elementwise op and each exp/log is an f32 op rounded to f16; each
reduction over genotypes or symbols (jnp.sum of f16) is an f32 sum in
index order, rounded once (``_scores_h16``). Against JAX 0.9 on the CPU
the 15-term dot equals XLA's f32 sum bit for bit at 5M entries of random
posteriors, and the f16 scores equal JAX's at every site measured
(tests/test_torch_f16.py); an f32 score rounded to f16 once differs at
~97% of them.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .model import ObservationModel

from . import kernels as K
from .genome_ops import widen

COUNT_CLIP = 990


#: numpy's dtype of each table dtype: the f64 model tables are rounded to
#: the table dtype once, by numpy, as the JAX package rounds them (torch
#: rounds f64 to f16 through f32, which differs at ties of the f32 value)
NP_DTYPES = {torch.float16: np.float16, torch.float32: np.float32, torch.float64: np.float64}


class ScoreTables(nn.Module):
    """The observation model's tables as tensors (buffers) on ``device``."""

    def __init__(self, model: ObservationModel, dtype=torch.float32, *, device):
        super().__init__()
        self.model = model
        self.dtype = dtype
        self.len_b = model.len_b
        self.len_g = model.len_g
        phi = model.phi
        with np.errstate(divide="ignore", invalid="ignore"):
            k = np.where(phi > 0, phi * np.log(np.where(phi > 0, phi, 1.0)), 0.0).sum(0)
        t = lambda a: torch.from_numpy(
            np.asarray(a, np.float64).astype(NP_DTYPES[dtype])).to(device)
        self.register_buffer("phi", t(phi))
        self.register_buffer("log_phi", t(model.log_phi))
        self.register_buffer("log_prior", t(model.log_prior))
        self.register_buffer("k", t(k))
        # the kernel's flat table: log_phi | phi | log_prior | k
        self.register_buffer("packed", torch.cat([
            self.log_phi.reshape(-1), self.phi.reshape(-1),
            self.log_prior.reshape(-1), self.k,
        ]).contiguous())


def _contract(w, x):
    """out[..., m, n] = sum_k w[k, m] * x[..., k, n], as elementwise
    multiply-adds over the small k axis (no matmul, so no TF32 anywhere)."""
    out = w[0][:, None] * x[..., 0:1, :]
    for j in range(1, w.shape[0]):
        out = out + w[j][:, None] * x[..., j : j + 1, :]
    return out


def _contract_lanes(w, x):
    """``_contract``'s sums in f32 in the order XLA's CPU dot takes for the
    engine's batched [nb, B, N] operands (pinned, module docstring): four
    lane sums over k = l, l+4, l+8, ... below the last whole group of four,
    added as (l0 + l1) + (l2 + l3), plus the remaining k summed in order on
    their own (15 genotypes: main + ((t12 + t13) + t14)). Every product of
    two f16 values is exact in f32, so only this order rounds."""
    K = w.shape[0]
    n4 = K // 4 * 4
    term = lambda j: w[j][:, None] * x[..., j: j + 1, :]
    out = None
    if n4:
        lanes = [term(j) for j in range(4)]
        for j in range(4, n4):
            lanes[j % 4] = lanes[j % 4] + term(j)
        out = (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])
    if n4 < K:
        tail = term(n4)
        for j in range(n4 + 1, K):
            tail = tail + term(j)
        out = tail if out is None else out + tail
    return out


def _h(x):
    """An f32 tensor rounded to f16 and held in f32: the rounding XLA's CPU
    program makes after each f16 op (every f16 value is exact in f32)."""
    return x.to(torch.float16).float()


def _seq_sum(x):
    """Sum over axis -2 in index order, in x's dtype."""
    acc = x[..., 0, :]
    for j in range(1, x.shape[-2]):
        acc = acc + x[..., j, :]
    return acc


def _scores_h16(counts_t, ref_base, tables: ScoreTables):
    """(score, entropy) f16 of ``site_scores_t`` with f16 tables, in the op
    sequence of bossruns_tpu/ops/scores.py:102-150 as XLA's CPU backend
    runs it (module docstring): f32 arithmetic rounded to f16 (``_h``)
    where that program rounds."""
    f = lambda t: t.float()
    c = torch.clamp(widen(counts_t[..., : tables.len_b, :]), 0, COUNT_CLIP).float()
    ll = _h(_contract_lanes(f(tables.log_phi), c))            # f16 dot
    lp = _h(ll + f(tables.log_prior).T[:, ref_base.long()])   # + the exact prior selection
    m = lp.max(dim=-2, keepdim=True).values
    msafe = torch.where(torch.isfinite(m), m, 0.0)
    se = _h(_seq_sum(_h(torch.exp(_h(lp - msafe)))))
    lse = _h(_h(torch.log(se.abs())) + msafe[..., 0, :])[..., None, :]
    log_post = _h(lp - lse)
    post = _h(torch.exp(log_post))
    entropy = -_h(_seq_sum(_h(post * log_post)))
    q = _h(_contract_lanes(f(tables.phi).T, post))            # f16 dot
    qlogq = torch.where(q > 0, _h(q * _h(torch.log(torch.where(q > 0, q, 1.0)))), 0.0)
    t1 = _h(_seq_sum(_h(post * f(tables.k)[:, None])))
    score = _h(t1 - _h(_seq_sum(qlogq)))
    return score.half(), entropy.half()


def site_scores_t(counts_t, ref_base, tables: ScoreTables):
    """(score, entropy) with the genome on the last axis: counts_t [..., B, N],
    ref_base [N] in 0..3 -> [..., N] each (plain PyTorch)."""
    dtype = tables.dtype
    if dtype == torch.float16:
        return _scores_h16(counts_t, ref_base, tables)
    c = torch.clamp(widen(counts_t[..., : tables.len_b, :]), 0, COUNT_CLIP).to(dtype)
    ll = _contract(tables.log_phi, c)                    # [..., G, N]
    prior_n = tables.log_prior.T[:, ref_base.long()]     # [G, N] exact selection
    lp = ll + prior_n
    lse = torch.logsumexp(lp, dim=-2, keepdim=True)
    log_post = lp - lse
    post = torch.exp(log_post)
    entropy = -torch.sum(post * log_post, dim=-2)
    q = _contract(tables.phi.T, post)                    # [..., B, N]
    qlogq = torch.where(q > 0, q * torch.log(torch.where(q > 0, q, 1.0)), 0.0)
    score = torch.sum(post * tables.k[:, None], dim=-2) - torch.sum(qlogq, dim=-2)
    return score, entropy


def prior_score(model: ObservationModel, dtype=torch.float64, *, device) -> tuple[float, float]:
    """(score0, entropy0) of a zero-coverage site (Scoring.score0/ent0)."""
    t = ScoreTables(model, dtype, device=device)
    c = torch.zeros((model.len_b, 1), dtype=dtype, device=device)
    r = torch.zeros(1, dtype=torch.int64, device=device)
    s, e = site_scores_t(c, r, t)
    return float(s[0]), float(e[0])


def site_scores_plain(coverage, seq, site_valid, tables: ScoreTables, freeze_cov: int,
                      tiny: float):
    """Plain version of H2: (scores [nb, G] in the tables' dtype, covsum
    int32 [nb, G]) from coverage uint16 [nb, 5, G], with the masking of
    models/runs.py:577-590."""
    fresh = site_scores_t(coverage, seq, tables)[0]
    covsum = torch.sum(widen(coverage), dim=1, dtype=torch.int32)
    scores = torch.where(site_valid[None, :], torch.clamp_min(fresh, 0.0), 0.0)
    scores = torch.where(covsum >= freeze_cov, tiny, scores)
    return scores, covsum


def site_scores(coverage, seq, site_valid, tables: ScoreTables, freeze_cov: int, tiny: float):
    """H2: per-site scores and coverage sums; same results as
    ``site_scores_plain`` (in the tables' dtype, summed in another order;
    the posterior is exp(lp - lse), a second exponential pass, as the plain
    version forms it). f32 tables launch ``site_scores``, f64 tables
    ``site_scores_s64``, f16 tables ``site_scores_h16`` (f32 arithmetic
    rounded to f16 where the plain version rounds). Any G and base
    alignment: the kernel takes 16-byte accesses where G % 4 == 0 and the
    bases are aligned, scalar ones otherwise."""
    if coverage.device.type == "cpu":
        return site_scores_plain(coverage, seq, site_valid, tables, freeze_cov, tiny)
    nb, _, G = coverage.shape
    dev = coverage.device
    dt = tables.packed.dtype
    if dt not in K.SCORE_SUFFIX:
        raise ValueError(f"H2 takes float16, float32 or float64 tables, got {dt}")
    K.check(coverage, "coverage", torch.uint16, (nb, 5, G))
    K.check(seq, "seq", torch.int8, (G,), dev)
    K.check(site_valid, "site_valid", torch.bool, (G,), dev)
    K.check(tables.packed, "tables", dt, None, dev)
    scores = torch.empty((nb, G), dtype=dt, device=dev)
    covsum = torch.empty((nb, G), dtype=torch.int32, device=dev)
    K.KERNELS["site_scores" + K.SCORE_SUFFIX[dt]](
        coverage.data_ptr(), seq.data_ptr(), site_valid.data_ptr(), tables.packed.data_ptr(),
        tables.len_b, tables.len_g, nb, G, freeze_cov, tiny,
        scores.data_ptr(), covsum.data_ptr(), K.stream_ptr(coverage),
    )
    return scores, covsum
