"""Port scores (bossruns_torch.ops.scores) vs the JAX closed form, on CPU.

The same count arrays (numpy, from a seed) go through the JAX
``site_scores_t`` and the port's plain ``site_scores_t``, both in f32.

Tolerance: rtol 1e-5, atol 5e-5. Same closed form in f32, but a different
summation order (XLA's dot fuses multiply-adds, the port rounds each
product) and exp/log implementation. With up to 40 counts per symbol the
f32 log-likelihoods reach ~170, whose ulp is 1.5e-5; that rounding moves
the posterior, and each f32 version lands up to ~3e-5 from the f64 closed
form (measured), so atol 1e-6 cannot hold between them.
``test_port_is_as_close_to_f64_as_jax`` pins that the port's error is the
f32 floor and not more. Both stay inside the f32-vs-f64 bands of
test_model_scores.py (rtol 5e-4 above 0.1, 2e-2 above 1e-3), checked too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bossruns_tpu.ops import scores as jscores
from bossruns_tpu.ops.model import make_model
from bossruns_torch.ops import scores as tscores

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 5e-5


def _both(model, counts_t, ref, jdtype=jnp.float32):
    jt = jscores.ScoreTables(model, jdtype)
    sj, ej = jscores.site_scores_t(jnp.asarray(counts_t), jnp.asarray(ref), jt)
    tt = tscores.ScoreTables(model, torch.float32, device="cpu")
    st, et = tscores.site_scores_t(torch.from_numpy(counts_t), torch.from_numpy(ref), tt)
    return (np.asarray(sj), np.asarray(ej)), (st.numpy(), et.numpy())


@pytest.mark.parametrize("ploidy", [1, 2])
@pytest.mark.parametrize("deletion_error", [0.03, 0.0])
def test_site_scores_t_matches_jax(rng, ploidy, deletion_error):
    m = make_model(ploidy=ploidy, deletion_error=deletion_error)
    counts = rng.integers(0, 40, size=(2, 5, 1000)).astype(np.uint16)
    ref = rng.integers(0, 4, size=1000).astype(np.int8)
    (sj, ej), (st, et) = _both(m, counts, ref)
    np.testing.assert_allclose(st, sj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(et, ej, rtol=RTOL, atol=ATOL)
    s64 = _both(m, counts, ref, jnp.float64)[0][0]
    big, mid = s64 > 1e-1, s64 > 1e-3
    np.testing.assert_allclose(st[big], s64[big], rtol=5e-4)
    np.testing.assert_allclose(st[mid], s64[mid], rtol=2e-2)


@pytest.mark.parametrize("ploidy", [1, 2])
def test_port_is_as_close_to_f64_as_jax(rng, ploidy):
    m = make_model(ploidy=ploidy)
    counts = rng.integers(0, 40, size=(1, 5, 2000)).astype(np.uint16)
    ref = rng.integers(0, 4, size=2000).astype(np.int8)
    (sj, _), (st, _) = _both(m, counts, ref)
    s64 = _both(m, counts, ref, jnp.float64)[0][0]
    err_port = np.abs(st - s64).max()
    err_jax = np.abs(sj - s64).max()
    assert err_port <= 1.5 * err_jax + 1e-6, (err_port, err_jax)


def test_low_coverage_scores_agree_tightly(rng):
    """At the coverage the engine actually scores (a site freezes at a
    total of 30), the log-likelihoods stay small and the two f32 versions
    agree to rtol 1e-5, atol 1e-6."""
    m = make_model(ploidy=1)
    counts = rng.multinomial(rng.integers(0, 30), [0.9, 0.04, 0.03, 0.02, 0.01],
                             size=(1, 4000)).transpose(0, 2, 1).astype(np.uint16)
    ref = np.zeros(4000, np.int8)
    (sj, _), (st, _) = _both(m, counts, ref)
    np.testing.assert_allclose(st, sj, rtol=1e-5, atol=1e-6)


def test_clip_at_990_matches_jax():
    m = make_model(ploidy=1)
    counts = np.array([[[2000, 990, 0], [0, 0, 5], [1, 1, 0], [0, 0, 0], [0, 0, 3000]]],
                      np.uint16)  # [1, 5, 3]
    ref = np.array([0, 0, 2], np.int8)
    (sj, _), (st, _) = _both(m, counts, ref)
    np.testing.assert_allclose(st, sj, rtol=RTOL, atol=ATOL)
    assert st[0, 0] == st[0, 1]  # 2000 clips to 990


@pytest.mark.parametrize("ploidy", [1, 2])
def test_prior_score_matches_jax(ploidy):
    m = make_model(ploidy=ploidy)
    s0, e0 = tscores.prior_score(m, device="cpu")
    js0, je0 = jscores.prior_score(m)
    assert abs(s0 - js0) < 1e-12
    assert abs(e0 - je0) < 1e-12


def test_zero_coverage_scores_equal_prior_score():
    m = make_model(ploidy=1)
    counts = np.zeros((1, 5, 4), np.uint16)
    ref = np.arange(4, dtype=np.int8)
    (sj, _), (st, _) = _both(m, counts, ref)
    np.testing.assert_allclose(st, sj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st[0], tscores.prior_score(m, device="cpu")[0], rtol=1e-5)


def test_masked_site_scores_match_engine_rules(rng):
    """site_scores (CPU -> plain) applies max(.,0), site validity and the
    freeze to tiny at covsum >= freeze_cov, as runs.py:577-590 does."""
    m = make_model(ploidy=1)
    counts = rng.integers(0, 12, size=(2, 5, 500)).astype(np.uint16)
    ref = rng.integers(0, 4, size=500).astype(np.int8)
    valid = rng.random(500) < 0.8
    tt = tscores.ScoreTables(m, torch.float32, device="cpu")
    scores, covsum = tscores.site_scores(
        torch.from_numpy(counts), torch.from_numpy(ref), torch.from_numpy(valid), tt,
        freeze_cov=30, tiny=float(np.finfo(np.float32).tiny))
    (sj, _), _ = _both(m, counts, ref)
    cs = counts.astype(np.int32).sum(axis=1)
    expect = np.where(valid[None], np.maximum(sj, 0.0), 0.0)
    expect = np.where(cs >= 30, np.finfo(np.float32).tiny, expect)
    np.testing.assert_array_equal(covsum.numpy(), cs)
    np.testing.assert_allclose(scores.numpy(), expect, rtol=RTOL, atol=ATOL)
    assert (scores.numpy()[cs >= 30] == np.finfo(np.float32).tiny).all()


def test_plain_scores_use_no_matmul(monkeypatch):
    """The contraction is elementwise multiply-adds (ROADMAP F5): no
    matmul path exists for TF32 to enter on the card."""
    def boom(*a, **k):
        raise AssertionError("matmul used in the score closed form")

    for name in ("einsum", "matmul", "mm", "bmm", "tensordot"):
        monkeypatch.setattr(torch, name, boom)
    m = make_model(ploidy=2)
    tt = tscores.ScoreTables(m, torch.float32, device="cpu")
    c = torch.randint(0, 30, (1, 5, 64), dtype=torch.int32)
    s, _ = tscores.site_scores_t(c, torch.zeros(64, dtype=torch.int8), tt)
    assert torch.isfinite(s).all()
