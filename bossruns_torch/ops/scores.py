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
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from bossruns_tpu.ops.model import ObservationModel

from . import kernels as K
from .genome_ops import widen

COUNT_CLIP = 990


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
        t = lambda a: torch.tensor(np.asarray(a, np.float64), dtype=dtype, device=device)
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


def site_scores_t(counts_t, ref_base, tables: ScoreTables):
    """(score, entropy) with the genome on the last axis: counts_t [..., B, N],
    ref_base [N] in 0..3 -> [..., N] each (plain PyTorch)."""
    dtype = tables.dtype
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
    """Plain version of H2: (scores f32 [nb, G], covsum int32 [nb, G]) from
    coverage uint16 [nb, 5, G], with the masking of models/runs.py:577-590."""
    fresh = site_scores_t(coverage, seq, tables)[0]
    covsum = torch.sum(widen(coverage), dim=1, dtype=torch.int32)
    scores = torch.where(site_valid[None, :], torch.clamp_min(fresh, 0.0), 0.0)
    scores = torch.where(covsum >= freeze_cov, tiny, scores)
    return scores, covsum


def site_scores(coverage, seq, site_valid, tables: ScoreTables, freeze_cov: int, tiny: float):
    """H2: per-site scores and coverage sums; same results as
    ``site_scores_plain`` (f32, summed in another order)."""
    if coverage.device.type == "cpu":
        return site_scores_plain(coverage, seq, site_valid, tables, freeze_cov, tiny)
    nb, _, G = coverage.shape
    dev = coverage.device
    K.check(coverage, "coverage", torch.uint16, (nb, 5, G))
    K.check(seq, "seq", torch.int8, (G,), dev)
    K.check(site_valid, "site_valid", torch.bool, (G,), dev)
    K.check(tables.packed, "tables", torch.float32, None, dev)
    scores = torch.empty((nb, G), dtype=torch.float32, device=dev)
    covsum = torch.empty((nb, G), dtype=torch.int32, device=dev)
    K.KERNELS["site_scores"](
        coverage.data_ptr(), seq.data_ptr(), site_valid.data_ptr(), tables.packed.data_ptr(),
        tables.len_b, tables.len_g, nb, G, freeze_cov, tiny,
        scores.data_ptr(), covsum.data_ptr(), K.stream_ptr(coverage),
    )
    return scores, covsum
