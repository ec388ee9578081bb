"""Plain float64 reference of one BOSS-RUNS update, in PyTorch.

The update's mathematics as the upstream defines it (boss/runs/
sequences.py: posterior and score, threshold scan; reference.py: S_mu and
the expected-benefit windows, dropout, buckets; readstartdist.py: the
read-start posterior), in the order of the f64 NumPy oracle that the
port's decisions are specified against (bossruns_torch/oracle.py,
``full_update``), written again in plain torch so that it runs in blocks
on the card at chromosome scale. Every step is float64; the per-site
score is the closed form (mutual information of genotype and observed
symbol) that the oracle holds equal to the upstream's product form to
about 1e-13. Frozen sites (coverage sum >= 30) score the smallest normal
number of the configuration's score dtype, as the engine's contract
states.

``score_dtype`` other than float64 computes the per-site scores in that
dtype (tables, contraction, exponentials and logs) and the rest in
float64: the control, the reference one precision below the float32
scores the configuration states.
"""
from __future__ import annotations

import numpy as np
import torch

from .layout import BUCKET, DS, Genome
from .model import make_tables

FREEZE_COV = 30
DROPOUT_MOD = 8
DROPOUT_MIN_MEAN = 5.0
BUCKET_THRESHOLD = 5.0
FHAT_P0 = 0.1
MU = 400
CCL_CLAMP_DS = 4096
#: sites scored per block (float64 temporaries of ~360 B a site)
SCORE_BLOCK = 1 << 23
F64 = torch.float64


class Reference:
    """The update on ``genome`` (a ``layout.Genome``) at ``ploidy``."""

    def __init__(self, genome: Genome, ploidy: int, device, score_dtype=torch.float64,
                 tiny_dtype=np.float32):
        self.g = genome
        self.dev = torch.device(device)
        self.score_dtype = score_dtype
        self.tiny = float(np.finfo(tiny_dtype).tiny)
        phi, prior = make_tables(ploidy)
        t = lambda a, dt=F64: torch.as_tensor(np.asarray(a), dtype=dt, device=self.dev)
        self.phi = t(phi)
        self.log_phi = torch.log(self.phi)
        self.log_prior = t(np.log(prior))
        self.k = (self.phi * self.log_phi).sum(0)
        self.len_b = phi.shape[0]
        g = genome
        self.seq = t(g.seq, torch.int64)
        self.site_valid = t(g.site_valid, torch.bool)
        self.cid_ds = t(g.cid_ds, torch.int64)
        self.seg_start = t(g.seg_start, torch.int64)
        self.seg_end = t(g.seg_end, torch.int64)
        self.strat_valid = t(g.strat_valid, torch.bool)
        self.fhat_idx = t(g.fhat_idx, torch.int64)
        self.bucket_idx = t(g.bucket_idx, torch.int64)
        self.bucket_lo = t(g.bucket_lo, torch.int64)
        self.denom = t(np.append(g.lengths * g.nb, 1).astype(np.float64))
        fr = g.fhat_idx[g.fhat_idx >= 0]
        self.fhat_rows = t(np.bincount(fr, minlength=g.n_fhat).astype(np.float64))
        #: the last update's per-site scores; ``step`` keeps them, so one
        #: Reference follows one state from ``init_state`` or a state set
        #: before its first step
        self._scores = None

    # ---------------------------------------------------------------- state --

    def init_state(self) -> dict:
        g, dev = self.g, self.dev
        return dict(
            coverage=torch.zeros((g.nb, 5, g.G), dtype=torch.int32, device=dev),
            zeroed=torch.zeros((g.nb, g.G), dtype=torch.bool, device=dev),
            bucket_on=torch.zeros((g.nb, g.n_buckets), dtype=torch.bool, device=dev),
            read_starts=torch.zeros((g.n_fhat, 2), dtype=F64, device=dev),
            strat=self.strat_valid[None, :, None].expand(g.nb, g.Gd, 2).clone(),
        )

    def strat_dict(self, state: dict) -> dict[str, np.ndarray]:
        """The published form: per contig (length // 100, 2, barcodes) bool."""
        s = state["strat"].cpu().numpy()
        out = {}
        for c, name in enumerate(self.g.names):
            r0, n = self.g.strat_rows(c)
            out[name] = np.ascontiguousarray(s[:, r0:r0 + n, :].transpose(1, 2, 0))
        return out

    # --------------------------------------------------------------- scores --

    def scores(self, cov: torch.Tensor, sites: torch.Tensor | None = None) -> torch.Tensor:
        """[nb, n] float64 per-site scores of coverage [nb, 5, G] at
        ``sites`` (int64 indices; all G sites when None)."""
        nb, _, G = cov.shape
        n = G if sites is None else sites.shape[0]
        out = torch.empty((nb, n), dtype=F64, device=self.dev)
        lb, dt = self.len_b, self.score_dtype
        log_phi, log_prior, phi, k = (x.to(dt) for x in (self.log_phi, self.log_prior,
                                                           self.phi, self.k))
        for b in range(nb):
            for s in range(0, n, SCORE_BLOCK):
                e = min(s + SCORE_BLOCK, n)
                at = slice(s, e) if sites is None else sites[s:e]
                c = cov[b, :lb, at].T.clamp(max=990).to(dt)
                ll = c @ log_phi + log_prior[self.seq[at]]
                ll -= ll.max(dim=1, keepdim=True).values
                post = torch.exp(ll)
                post /= post.sum(dim=1, keepdim=True)
                q = post @ phi.T
                out[b, s:e] = (post @ k - (q * torch.log(q)).sum(dim=1)).to(F64)
        return out

    def site_scores(self, cov: torch.Tensor, changed: torch.Tensor) -> torch.Tensor:
        """The scores of every site after an update that changed the
        coverage at ``changed`` ([G] bool): a site's score depends on its
        own counts alone, so only those sites are scored again; the first
        update scores all."""
        if self._scores is None:
            self._scores = self.scores(cov)
        else:
            at = torch.nonzero(changed).squeeze(1)
            self._scores[:, at] = self.scores(cov, at)
        return self._scores

    # ----------------------------------------------------------------- step --

    @torch.no_grad()
    def step(self, state: dict, obs: torch.Tensor, rs_row, rs_strand, rs_w,
             approx_ccl, time_cost: float) -> float:
        """One update of ``state`` in place. ``obs``: int64 flat indices
        ((barcode * 5 + symbol) * G + site) of the batch's observations;
        ``rs_*``: read-start windows (global), strands and weights of the
        accepted reads; ``approx_ccl`` the 10 CCL pieces, ``time_cost`` as the
        engine receives it (rounded to float32). Returns the threshold."""
        g, dev = self.g, self.dev
        nb, G, Gd = g.nb, g.G, g.Gd
        cov = state["coverage"]
        flat = cov.view(-1)
        flat.scatter_add_(0, obs, torch.ones_like(obs, dtype=torch.int32))
        flat.clamp_(max=65535)
        changed = torch.zeros(G, dtype=torch.bool, device=dev)
        changed[obs % G] = True

        covsum = cov.sum(dim=1)                                  # [nb, G] int64
        maxed = covsum >= FREEZE_COV
        scores = self.site_scores(cov, changed)
        scores = torch.where(self.site_valid[None], scores, 0.0)
        scores = torch.where(maxed, self.tiny, scores)

        covsum_ds = covsum.view(nb, Gd, DS).sum(dim=2).to(F64)
        per_contig = torch.zeros(len(g.names) + 1, dtype=F64, device=dev)
        per_contig.index_add_(0, self.cid_ds, covsum_ds.sum(dim=0))
        mean_c = per_contig / self.denom
        thr = torch.floor(mean_c / DROPOUT_MOD)
        active = mean_c > DROPOUT_MIN_MEAN
        site_cid = self.cid_ds.repeat_interleave(DS)
        drop_now = (active[site_cid] & self.site_valid
                    & (covsum.to(F64) <= thr[site_cid][None]).any(dim=0))[None]
        recomputed = changed[None] & ~maxed
        hold_zero = state["zeroed"] & ~recomputed
        scores = torch.where(hold_zero | drop_now, 0.0, scores)
        state["zeroed"] = (drop_now | hold_zero).expand(nb, G).clone()

        cc = torch.cat([torch.zeros((nb, 1), dtype=F64, device=dev),
                        torch.cumsum(covsum_ds, dim=1)], dim=1)
        lo = self.bucket_lo.clamp(min=0)
        wsum = cc[:, lo + BUCKET // DS] - cc[:, lo]
        bmean = torch.where(self.bucket_lo >= 0, wsum / BUCKET, 0.0)
        state["bucket_on"] |= bmean >= BUCKET_THRESHOLD
        any_on = bool(state["bucket_on"].any())

        rs = state["read_starts"]
        keep = rs_row >= 0
        rs.index_put_((rs_row[keep], rs_strand[keep]), rs_w[keep].to(F64), accumulate=True)
        fh = fhat_pointmass(rs, FHAT_P0)
        fidx = self.fhat_idx
        fhat_exp = torch.where((fidx >= 0)[:, None], fh[fidx.clamp(min=0)], 0.0)
        tot = float((fh * self.fhat_rows[:, None]).sum())
        if tot > 0:
            fhat_exp = fhat_exp * (1.0 / tot)
        fhat_exp = fhat_exp.to(torch.float32).to(F64)

        scores_ds = scores.view(nb, Gd, DS).sum(dim=2)
        ccl_ds = np.clip(np.asarray(approx_ccl, np.int64) // DS, 1, CCL_CLAMP_DS)
        rows = torch.arange(Gd, device=dev)
        weights = np.arange(0.05, 1, 0.1)[::-1]
        mu_ds = MU // DS
        smu = torch.zeros((nb, Gd, 2), dtype=F64, device=dev)
        ben = torch.zeros((nb, Gd, 2), dtype=F64, device=dev)
        for b in range(nb):
            cs = torch.cat([torch.zeros(1, dtype=F64, device=dev), torch.cumsum(scores_ds[b], 0)])

            def fwd(w):
                return cs[torch.minimum(rows + w, self.seg_end)] - cs[rows]

            def rev(w):
                return cs[rows + 1] - cs[torch.maximum(rows + 1 - w, self.seg_start)]

            smu[b, :, 0], smu[b, :, 1] = fwd(mu_ds), rev(mu_ds)
            for i in range(10):
                w = int(ccl_ds[i])
                ben[b, :, 0] += float(weights[i]) * fwd(w)
                ben[b, :, 1] += float(weights[i]) * rev(w)
        ben = torch.clamp(ben - smu, min=0.0)

        cand, threshold = find_strategy(ben, smu, fhat_exp[None].expand_as(ben), time_cost)
        bidx = self.bucket_idx
        gate = state["bucket_on"][:, bidx.clamp(min=0)] & (bidx >= 0)[None]
        if any_on and bool((ben > 0).any()):
            write = gate & self.strat_valid[None]
            state["strat"] = torch.where(write[:, :, None], cand, state["strat"])
        return threshold


def fhat_pointmass(read_starts: torch.Tensor, p0: float) -> torch.Tensor:
    """Posterior mean read-start probability per (window, strand), alpha 1
    (readstartdist.py:86-117); B(1, z) = 1 / z."""
    n = read_starts.shape[0]
    csum = float(read_starts.sum())
    denom = 2.0 * n + csum
    fhat = (1.0 + read_starts) / denom
    ratio = (1.0 / ((2.0 * n - 1.0) + csum)) / (1.0 / (2.0 * n - 1.0))
    expected = (1.0 - p0 / (p0 + (1 - p0)) * ratio) * (1.0 / denom)
    return torch.where(read_starts > 0, fhat, expected)


def find_strategy(benefit, smu, fhat, time_cost: float):
    """The exponent-binned threshold scan (sequences.py:565-649): bins of
    the non-zero benefits by binary exponent below the largest, then the
    strategy size that maximises cumulative benefit over cumulative time.
    Returns (benefit >= threshold, threshold)."""
    alpha, rho, mu = 3, 3, 4
    tc = time_cost // DS
    flat = benefit.reshape(-1)
    nz = torch.nonzero(flat).squeeze(1)
    if nz.numel() == 0:
        return torch.ones_like(benefit, dtype=torch.bool), 0.0
    bnz = flat[nz]
    norm = bnz.max()
    _, e = torch.frexp(bnz / norm)
    expo = e.abs().to(torch.int64)
    counts_all = torch.bincount(expo).to(F64)
    f_all = torch.bincount(expo, weights=fhat.reshape(-1)[nz])
    used = torch.nonzero(counts_all).squeeze(1)
    counts = counts_all[used]
    f_mean = f_all[used] / counts
    bbin = torch.pow(2.0, -used.to(F64)) * norm
    ubar0 = float((fhat * smu).to(torch.float32).to(F64).sum())
    cs_u = torch.cumsum(bbin * f_mean * counts, 0) + ubar0
    cs_t = torch.cumsum(tc * counts * f_mean, 0) + (alpha + rho + mu)
    size = int(torch.argmax(cs_u / cs_t)) + 1
    threshold = float(bbin[size] if size < bbin.shape[0] else bbin[-1])
    return benefit >= threshold, threshold
