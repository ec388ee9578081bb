"""Genotype observation model for BOSS-RUNS-style Bayesian scoring.

Builds the conditional observation probabilities phi[b, g] = P(observe base b |
true genotype g) and the genotype priors prior[r, g] = P(genotype g | reference
base r) for haploid/diploid organisms, with or without a deletion "base".

Semantics mirror the reference implementation's model construction
(the reference's boss/runs/sequences.py:38-326) but are built here as small
dense NumPy tables (they are tiny: at most 5x15) that are then shipped to the
device as constants. The device kernels consume ``log_phi``/``log_prior``
because posteriors are computed in log-space (see ops/scores.py) rather than
via the reference's phi**k lookup tables (sequences.py:159-168), which exist
only to make Python loops fast and are pointless on an accelerator.
"""
from __future__ import annotations

import dataclasses
from itertools import combinations_with_replacement

import numpy as np

BASES = "ACGT"
GAP = "-"


def _diploid_genotypes(with_del: bool) -> list[str]:
    gts = ["".join(p) for p in combinations_with_replacement(BASES, 2)]
    if with_del:
        gts += [b + GAP for b in BASES] + [GAP + GAP]
    return gts


def _p_homo(popsize: int = 1000) -> float:
    """Coalescent-derived prior proportion of hom-alt sites among non-ref sites.

    Matches reference sequences.py:255-264.
    """
    i = np.arange(1, popsize + 1, dtype=np.float64)
    a_n = np.sum(1.0 / i)
    homo = np.sum((1.0 / (i * a_n)) * (i * i / popsize**2))
    hetero = np.sum((1.0 / (i * a_n)) * 2.0 * ((popsize - i) * i / popsize**2))
    return float(homo / (homo + hetero))


@dataclasses.dataclass(frozen=True)
class ObservationModel:
    """Immutable container for the genotype observation model tables.

    Attributes
    ----------
    phi:    [len_b, len_g] f64 — P(observed symbol | genotype)
    prior:  [4, len_g] f64 — P(genotype | reference base); always 4 reference
            bases (deletions cannot be a reference symbol).
    len_b:  number of observable symbols (4 or 5, 5th = deletion)
    len_g:  number of genotypes
    """

    ploidy: int
    phi: np.ndarray
    prior: np.ndarray

    @property
    def len_b(self) -> int:
        return self.phi.shape[0]

    @property
    def len_g(self) -> int:
        return self.phi.shape[1]

    @property
    def log_phi(self) -> np.ndarray:
        with np.errstate(divide="ignore"):
            return np.where(self.phi > 0, np.log(self.phi), -np.inf)

    @property
    def log_prior(self) -> np.ndarray:
        with np.errstate(divide="ignore"):
            return np.where(self.prior > 0, np.log(self.prior), -np.inf)


def make_phi(
    ploidy: int = 1,
    deletion_error: float = 0.03,
    err_missed_deletion: float = 0.1,
    substitution_error: float = 0.04,
) -> np.ndarray:
    """Observation probabilities phi[b, g].

    Reference: sequences.py:38-155. ``deletion_error`` falsy drops the deletion
    symbol/genotypes entirely.
    """
    sub = substitution_error
    if ploidy == 1:
        if not deletion_error:
            phi = np.full((4, 4), sub / 3.0)
            np.fill_diagonal(phi, 1.0 - sub)
            return phi
        # haploid with deletion symbol: symbols/genotypes A C G T -
        phi = np.zeros((5, 5))
        for b in range(4):
            for g in range(4):
                phi[b, g] = (1.0 - (sub + deletion_error)) if b == g else sub / 3.0
            # true deletion, base b observed
            phi[b, 4] = err_missed_deletion / 4.0
        # deletion observed, genotype a real base
        phi[4, :4] = deletion_error
        phi[4, 4] = 1.0 - err_missed_deletion
        return phi

    if ploidy != 2:
        raise ValueError(f"unsupported ploidy {ploidy}")

    gts = _diploid_genotypes(with_del=bool(deletion_error))
    if not deletion_error:
        phi = np.zeros((4, len(gts)))
        for b, base in enumerate(BASES):
            for g, gt in enumerate(gts):
                n = gt.count(base)
                if n == 2:
                    phi[b, g] = 1.0 - sub
                elif n == 1:
                    phi[b, g] = (1.0 - sub) / 2.0 + sub / 6.0
                else:
                    phi[b, g] = sub / 3.0
        return phi

    # diploid with deletions: 5 symbols, 15 genotypes
    ok = 1.0 - (sub + deletion_error)
    emd = err_missed_deletion
    phi = np.zeros((5, len(gts)))
    for b, base in enumerate(BASES):
        for g, gt in enumerate(gts):
            n_base = gt.count(base)
            n_gap = gt.count(GAP)
            if n_gap == 0:
                if n_base == 2:
                    phi[b, g] = ok
                elif n_base == 1:
                    phi[b, g] = ok / 2.0 + sub / 6.0
                else:
                    phi[b, g] = sub / 3.0
            elif n_gap == 1:
                if n_base == 1:
                    phi[b, g] = ok / 2.0 + emd / 8.0
                else:
                    phi[b, g] = sub / 6.0 + emd / 8.0
            else:  # homozygous deletion
                phi[b, g] = emd / 4.0
    for g, gt in enumerate(gts):
        n_gap = gt.count(GAP)
        if n_gap == 2:
            phi[4, g] = 1.0 - emd
        elif n_gap == 1:
            phi[4, g] = (1.0 - emd) / 2.0 + deletion_error / 2.0
        else:
            phi[4, g] = deletion_error
    return phi


def make_prior(
    ploidy: int = 1,
    deletion_error: float = 0.03,
    theta: float = 0.01,
    del_subs_ratio: float = 0.4,
) -> np.ndarray:
    """Genotype priors prior[r, g] given reference base r.

    Reference: sequences.py:185-313. Rows are the 4 reference bases.
    """
    if ploidy == 1:
        if not deletion_error:
            prior = np.full((4, 4), theta / 3.0)
            np.fill_diagonal(prior, 1.0 - theta)
            return prior
        prior = np.full((4, 5), theta / 3.0)
        for r in range(4):
            prior[r, r] = 1.0 - theta * (1.0 + del_subs_ratio)
        if del_subs_ratio > 1e-4:
            prior[:, 4] = theta * del_subs_ratio
        return prior

    if ploidy != 2:
        raise ValueError(f"unsupported ploidy {ploidy}")

    p_homo = _p_homo()
    gts = _diploid_genotypes(with_del=bool(deletion_error))
    prior = np.zeros((4, len(gts)))
    for r, base in enumerate(BASES):
        for g, gt in enumerate(gts):
            n_gap = gt.count(GAP)
            n_base = gt.count(base)
            if n_gap == 0:
                if n_base == 2:
                    prior[r, g] = (
                        1.0 - theta if not deletion_error else 1.0 - theta * (1.0 + del_subs_ratio)
                    )
                elif n_base == 1:
                    prior[r, g] = (1.0 - p_homo) * theta / 3.0
                else:
                    prior[r, g] = p_homo * theta / 3.0
            elif n_gap == 1:
                prior[r, g] = (1.0 - p_homo) * del_subs_ratio * theta
            else:
                prior[r, g] = p_homo * del_subs_ratio * theta
    return prior


def make_model(
    ploidy: int = 1,
    deletion_error: float = 0.03,
    err_missed_deletion: float = 0.1,
    substitution_error: float = 0.04,
    theta: float = 0.01,
    del_subs_ratio: float = 0.4,
    uniform_priors: bool = False,
) -> ObservationModel:
    phi = make_phi(ploidy, deletion_error, err_missed_deletion, substitution_error)
    prior = make_prior(ploidy, deletion_error, theta, del_subs_ratio)
    if uniform_priors:
        prior = np.full_like(prior, 1.0 / prior.shape[1])
    return ObservationModel(ploidy=ploidy, phi=phi, prior=prior)
