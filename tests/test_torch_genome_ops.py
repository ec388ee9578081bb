"""Port genome ops (bossruns_torch.ops.genome_ops) vs the JAX functions.

Cases of tests/test_genome_ops.py, with the same numpy inputs on both
sides. Window sums: JAX's XLA cumsum reassociates, the port's f64 cumsum
is sequential like numpy's, so the port is held BIT-EXACT against the f64
oracle and to rtol 1e-12 against JAX, plus an absolute floor of 64 ulps of
the running total (a window sum is a difference of two prefix sums, so its
rounding scales with the total, not with the window).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bossruns_tpu import oracle
from bossruns_tpu.ops import genome_ops as jg
from bossruns_torch.ops import genome_ops as tg

torch.set_num_threads(2)

T = torch.from_numpy


def _floor(x):
    return 64 * np.finfo(np.float64).eps * np.abs(x).sum()


def test_windowed_sums_single_segment(rng):
    x = rng.random(513)
    n = x.shape[0]
    cs_j = jg._csum(jnp.asarray(x))
    cs_t = tg._csum(T(x))
    rows_j, rows_t = jnp.arange(n, dtype=jnp.int32), torch.arange(n)
    for w in (1, 4, 37, 512, 1000):
        fj = jg.windowed_sums_fwd(cs_j, jnp.asarray(w), jnp.full(n, n, jnp.int32), rows_j)
        rj = jg.windowed_sums_rev(cs_j, jnp.asarray(w), jnp.zeros(n, jnp.int32), rows_j)
        ft = tg.windowed_sums_fwd(cs_t, w, torch.full((n,), n, dtype=torch.int32), rows_t)
        rt = tg.windowed_sums_rev(cs_t, w, torch.zeros(n, dtype=torch.int32), rows_t)
        np.testing.assert_array_equal(ft.numpy(), oracle.move_sum_fwd(x, w))
        np.testing.assert_array_equal(rt.numpy(), oracle.move_sum_rev(x, w))
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-12, atol=_floor(x))
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-12, atol=_floor(x))


def test_windowed_sums_respect_segments(rng):
    x = rng.random(200)
    seg_start = np.array([0] * 120 + [120] * 80, np.int32)
    seg_end = np.array([120] * 120 + [200] * 80, np.int32)
    rows_j, rows_t = jnp.arange(200, dtype=jnp.int32), torch.arange(200)
    cs_j, cs_t = jg._csum(jnp.asarray(x)), tg._csum(T(x))
    fj = jg.windowed_sums_fwd(cs_j, jnp.asarray(50), jnp.asarray(seg_end), rows_j)
    rj = jg.windowed_sums_rev(cs_j, jnp.asarray(50), jnp.asarray(seg_start), rows_j)
    ft = tg.windowed_sums_fwd(cs_t, 50, T(seg_end), rows_t)
    rt = tg.windowed_sums_rev(cs_t, 50, T(seg_start), rows_t)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-12, atol=_floor(x))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-12, atol=_floor(x))


def test_expected_benefit_matches_jax_and_oracle(rng):
    n = 1024
    x = rng.random(n) * np.exp(rng.normal(0, 3, n))  # wide dynamic range
    ccl = np.array([460, 300, 200, 150, 110, 80, 60, 40, 20, 8]) * 100
    seg_s, seg_e = np.zeros(n, np.int32), np.full(n, n, np.int32)
    smu_j, ben_j = jg.expected_benefit(jnp.asarray(x)[None], jnp.asarray(ccl // 100),
                                       jnp.asarray(seg_s), jnp.asarray(seg_e))
    smu_t, ben_t = tg.expected_benefit(T(x)[None], list(ccl // 100), T(seg_s), T(seg_e))
    fl = 5 * _floor(x)  # the chain sums ~5 weights' worth of window sums
    np.testing.assert_allclose(smu_t.numpy()[0], np.asarray(smu_j)[0], rtol=1e-12, atol=fl)
    np.testing.assert_allclose(ben_t.numpy()[0], np.asarray(ben_j)[0], rtol=1e-12, atol=fl)
    smu_o, ben_o = oracle.expected_benefit(x, ccl)
    np.testing.assert_array_equal(smu_t.numpy()[0], smu_o)
    np.testing.assert_array_equal(ben_t.numpy()[0], ben_o)


def test_fhat_pointmass_exact(rng):
    w = 50
    counts = rng.poisson(0.7, size=(w, 2)).astype(np.float64)
    valid = np.ones(w, bool)
    valid[-3:] = False
    fj = jg.fhat_pointmass(jnp.asarray(counts), jnp.asarray(valid), w - 3)
    ft = tg.fhat_pointmass(T(counts), T(valid), w - 3)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))


def test_frexp_abs_exponent_exact(rng):
    k = np.arange(-185, 2)
    p2 = 2.0 ** k.astype(np.float64)
    vals = np.concatenate([
        rng.random(1000),
        p2, np.nextafter(p2, 0), np.nextafter(p2, 2 * p2),  # within one ulp of 2^k
        np.array([5e-324, 2.2e-308, 1e-310]),                 # f64 subnormals
    ])
    got = tg.frexp_abs_exponent(T(vals), 192).numpy()
    want = np.asarray(jg.frexp_abs_exponent(jnp.asarray(vals, jnp.float64), 192))
    np.testing.assert_array_equal(got, want)
    # the exact form is numpy.frexp (JAX clamps values below 2^-190 to the
    # top bin, numpy gives 190 just below 2^-190; the port follows numpy)
    edge = np.array([2.0 ** -190.5, 2.0 ** -191])
    _, e = np.frexp(edge)
    np.testing.assert_array_equal(tg.frexp_abs_exponent(T(edge), 192).numpy(),
                                  np.minimum(np.abs(e), 191))
    v32 = np.concatenate([rng.random(500), 2.0 ** np.arange(-120, 1)]).astype(np.float32)
    np.testing.assert_array_equal(tg.frexp_abs_exponent(T(v32), 192).numpy(),
                                  np.asarray(jg.frexp_abs_exponent(jnp.asarray(v32), 192)))


@pytest.mark.parametrize("shape", [(1, 700, 2), (2, 500, 2)])
def test_find_strategy_matches_jax(rng, shape):
    benefit = rng.random(shape) * np.exp(rng.normal(0, 4, shape))
    benefit[rng.random(shape) < 0.3] = 0.0
    smu = rng.random(shape)
    fhat = (rng.random(shape) * 1e-3).astype(np.float32).astype(np.float64)
    res_j = jg.find_strategy(jnp.asarray(benefit), jnp.asarray(smu), jnp.asarray(fhat),
                             jnp.asarray(5300.0))
    res_t = tg.find_strategy(T(benefit), T(smu), T(fhat), 5300.0)
    np.testing.assert_array_equal(res_t.strat.numpy(), np.asarray(res_j.strat))
    np.testing.assert_allclose(float(res_t.threshold), float(res_j.threshold), rtol=1e-12)
    assert bool(res_t.any_nonzero) == bool(res_j.any_nonzero)
    strat_o, thr_o = oracle.find_strategy(benefit, smu, fhat, 5300.0)
    np.testing.assert_array_equal(res_t.strat.numpy(), strat_o)
    assert float(res_t.threshold) == thr_o  # exact powers of two, sequential scan


def test_bins_and_ubar0_match_jax(rng):
    b = rng.random((1, 300, 2)) * np.exp(rng.normal(0, 4, (1, 300, 2)))
    b[rng.random(b.shape) < 0.3] = 0.0
    f = (rng.random(b.shape) * 1e-3).astype(np.float32).astype(np.float64)
    s = rng.random(b.shape)
    cj, fj = jg.bin_benefit(jnp.asarray(b), jnp.asarray(f), jnp.asarray(b.max()), 192)
    ct, ft = tg.bin_benefit(T(b), T(f), torch.tensor(b.max(), dtype=torch.float64), 192)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert float(tg.ubar0_partial(T(f), T(s), torch.float64)) == float(
        jg.ubar0_partial(jnp.asarray(f), jnp.asarray(s), jnp.float64))


def bin_edge_case(case: str):
    """(benefit, smu, fhat) of an adversarial binning input. fhat and smu
    are dyadic (k * 2^-20, k * 2^-10) so every sum the bins and ubar0 take
    is exact in any order (the F4 contract), and the kernel's grouping can
    be held bit for bit.

    one_bin: every benefit equal, one bin holds everything;
    all_bins: ratios 2^-k * [0.5, 1) for every bin that numpy and the JAX
        package both reach (not [2^-191, 2^-190), where numpy gives 190 and
        JAX the top bin: test_frexp_abs_exponent_exact), zeros, and ratios
        from 2^-192 down to 2^-1020 (the top bin; benefits stay normal f64:
        XLA on the CPU treats subnormals as zero);
    ragged: two barcodes of Gd = 4096 + 1003 rows (not a multiple of the
        4096-row tile or of 4), a 30% share of zeros."""
    rng = np.random.default_rng({"one_bin": 71, "all_bins": 72, "ragged": 73}[case])
    shape = (2, 4096 + 1003, 2) if case == "ragged" else (1, 900, 2)
    if case == "one_bin":
        b = np.full(shape, 0.37)
    elif case == "all_bins":
        k = np.concatenate([np.arange(190), [191, 192, 300, 1000, 1020]])
        # mantissas away from 0.5 and 1: x * 3.7 / 3.7 stays in its binade
        ratio = np.ldexp(rng.uniform(0.55, 0.95, k.size), -k)
        flat = np.zeros(int(np.prod(shape)))
        flat[: k.size] = ratio
        flat[k.size: 2 * k.size] = ratio[::-1]
        flat[2 * k.size] = 1.0  # the max itself: bin 1
        b = rng.permutation(flat * 3.7).reshape(shape)
    else:
        b = rng.random(shape) * np.exp(rng.normal(0, 4, shape))
        b[rng.random(shape) < 0.3] = 0.0
    fhat = rng.integers(1, 2**12, shape) * 2.0**-20
    smu = rng.integers(0, 2**10, shape) * 2.0**-10
    return b, smu, fhat


@pytest.mark.parametrize("case", ["one_bin", "all_bins", "ragged"])
def test_bin_benefit_edge_cases_match_jax(case):
    b, smu, f = bin_edge_case(case)
    cj, fj = jg.bin_benefit(jnp.asarray(b), jnp.asarray(f), jnp.asarray(b.max()), 192)
    ct, ft = tg.bin_benefit(T(b), T(f), torch.tensor(b.max(), dtype=torch.float64), 192)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert int(ct.sum()) == int((b > 0).sum())
    used = int((ct > 0).sum())
    assert used == {"one_bin": 1, "all_bins": 191}.get(case, used)
    res_j = jg.find_strategy(jnp.asarray(b), jnp.asarray(smu), jnp.asarray(f),
                             jnp.asarray(5300.0))
    res_t = tg.find_strategy(T(b), T(smu), T(f), 5300.0)
    np.testing.assert_array_equal(res_t.strat.numpy(), np.asarray(res_j.strat))
    assert bool(res_t.any_nonzero) == bool(res_j.any_nonzero)
    # the threshold is 2^-k * norm: exact against the f64 oracle; JAX takes
    # 2^-k from XLA's exp2, an ulp off at some k
    strat_o, thr_o = oracle.find_strategy(b, smu, f, 5300.0)
    assert float(res_t.threshold) == thr_o
    np.testing.assert_array_equal(res_t.strat.numpy(), strat_o)
    np.testing.assert_allclose(float(res_t.threshold), float(res_j.threshold), rtol=1e-12)


def test_scatter_add_drops_out_of_range(rng):
    target = rng.random((6, 2))
    i0 = np.array([0, 5, 6, -1, 2, 2], np.int32)
    i1 = np.array([1, 0, 0, 1, 2, 1], np.int32)
    w = np.ones(6)
    got = tg.scatter_add_2d(T(target), T(i0), T(i1), T(w)).numpy()
    want = target.copy()
    for a, b_ in ((0, 1), (5, 0), (2, 1)):
        want[a, b_] += 1.0
    np.testing.assert_array_equal(got, want)
    t3 = np.zeros((2, 3, 4))
    idx = (np.array([0, 1, 2]), np.array([1, 2, 0]), np.array([3, 3, 3]))
    got3 = tg.scatter_add_3d(T(t3), *(T(i) for i in idx), T(np.ones(3))).numpy()
    want3 = np.asarray(jg.scatter_add_3d(jnp.asarray(t3), *(jnp.asarray(i) for i in idx),
                                         jnp.ones(3)))
    np.testing.assert_array_equal(got3, want3)


def test_estimate_fhat_priors_matches_jax():
    counts = np.random.default_rng(0).poisson(2.0, size=(300, 2)).astype(np.float64)
    assert tg.estimate_fhat_priors(counts) == jg.estimate_fhat_priors(counts)
