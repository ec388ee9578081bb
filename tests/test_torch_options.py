"""The engine options of RunsConfig in the port, against the JAX package and
the port's f64 oracle (bossruns_torch.oracle).

(a) ``fhat_pointmass`` with a general prior: port, JAX (x64) and the
    port's oracle (scipy's betaln) agree within rtol 1e-8 for alpha 0.4,
    1.7 and 25 over 135 and 4025 windows; alpha == 1 stays bit-identical;
(b) ``fhat_alpha`` 0.4 and 1.7: the port engine equals the port's oracle
    given the engine's scores, bit for bit (strat, bucket_on, read_starts,
    coverage), over a soak, and the JAX engine with the same option (state
    exact, scores within the f32 tolerance of test_torch_engine.py);
(c) ``dtype="float64"``: state exact against the JAX f64-score engine,
    scores within rtol 1e-10 / atol 1e-10, and the strategy equals the
    port's oracle run on its OWN f64 scores (fast_scores, no override),
    started from the engine's init_state, in every valid cell of every
    step;
(d) ``benefit_dtype="float32"``: coverage, zeroed, bucket_on and
    read_starts exact against the JAX f32 decision path, and strat equal;
    where it is not, the two thresholds lie at most one exponent bin apart
    and every flipped cell's benefit lies between them, widened by the bar
    within which two f32 summation orders' benefits agree (the count is
    printed);
(f) ``dtype`` "bfloat16" or "int32", and ``benefit_dtype`` "float16",
    "bfloat16" or "int32", raise ValueError; ``dtype="float16"`` runs
    (test_torch_f16.py holds it against the JAX f16 engine).
(e), the sharded engine under each option, is test_torch_options_mesh.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bossruns_tpu.models import runs as jruns
from bossruns_tpu.models.layout import build_layout
from bossruns_tpu.ops import genome_ops as jg
from bossruns_torch import oracle
from bossruns_torch.models import runs as truns
from bossruns_torch.models.convert import batch_from_numpy, state_to_numpy
from bossruns_torch.ops import genome_ops as tg
from test_engine_parity import _random_batch

torch.set_num_threads(2)

CCL = np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400])
STATE = ("coverage", "zeroed", "bucket_on", "read_starts")


def _layout(seed: int, nb: int = 1):
    rng = np.random.default_rng(seed)
    return build_layout({"a": rng.integers(0, 4, 130_000).astype(np.uint8),
                         "b": rng.integers(0, 4, 110_000).astype(np.uint8)}, n_barcodes=nb)


def _jbatch(b):
    return jruns.ReadBatch(**{k: jnp.asarray(v) for k, v in b.items()})


# ------------------------------------------------------------------- (a) ----

def _read_starts(n: int, seed: int) -> np.ndarray:
    """[n + 7, 2] counts (7 padding rows of zeros), a third of them zero."""
    rng = np.random.default_rng(seed)
    rs = np.zeros((n + 7, 2))
    rs[:n] = rng.poisson(3.0, (n, 2)) * (rng.random((n, 2)) > 0.33)
    return rs


@pytest.mark.parametrize("n", [135, 4025])
@pytest.mark.parametrize("alpha", [0.4, 1.7, 25.0])
def test_general_point_mass_matches_jax_and_oracle(n, alpha):
    rs = _read_starts(n, int(alpha * 10) + n)
    valid = np.arange(rs.shape[0]) < n
    got = tg.fhat_pointmass(torch.from_numpy(rs), torch.from_numpy(valid), n, alpha, 0.1).numpy()
    jax_ = np.asarray(jg.fhat_pointmass(jnp.asarray(rs), jnp.asarray(valid), n, alpha, 0.1))
    orc = oracle.fhat_pointmass(rs[:n], alpha=alpha, p0=0.1)
    np.testing.assert_allclose(got[:n], orc, rtol=1e-8, atol=0)
    np.testing.assert_allclose(got, jax_, rtol=1e-8, atol=0)
    assert not got[n:].any()
    # the unobserved windows' point mass is where the general form acts
    zero = rs[:n] == 0
    assert zero.any() and not np.allclose(got[:n][zero], alpha / (2 * n * alpha + rs.sum()))


@pytest.mark.parametrize("n", [135, 4025])
def test_unit_point_mass_stays_bit_identical(n):
    rs = _read_starts(n, n)
    valid = np.arange(rs.shape[0]) < n
    got = tg.fhat_pointmass(torch.from_numpy(rs), torch.from_numpy(valid), n, 1.0, 0.1).numpy()
    jax_ = np.asarray(jg.fhat_pointmass(jnp.asarray(rs), jnp.asarray(valid), n, 1.0, 0.1))
    np.testing.assert_array_equal(got, jax_)
    np.testing.assert_array_equal(got[:n], oracle.fhat_pointmass(rs[:n], alpha=1.0, p0=0.1))


# ------------------------------------------------------------------- (b) ----

@pytest.mark.parametrize("alpha", [0.4, 1.7])
def test_general_alpha_engine_matches_port_oracle(alpha):
    rng = np.random.default_rng(int(alpha * 10))
    lay = _layout(5)
    eng = truns.RunsEngine(lay, config=truns.RunsConfig(debug_aux=True, fhat_alpha=alpha),
                           device="cpu")
    state = eng.init_state()
    st_np = state_to_numpy(state)
    st_np["read_starts"] = st_np["read_starts"].astype(np.float64)
    params = eng.make_params(CCL, 5300.0)
    updated = 0
    for step in range(10):
        b = _random_batch(rng, lay, n_obs=120_000)
        state, aux = eng.step(state, batch_from_numpy(b, "cpu"), params)
        st_np, aux_o = oracle.full_update(eng, st_np, b, CCL, 5300.0,
                                          scores_override=aux.scores.numpy())
        got = state_to_numpy(state)
        assert bool(aux.updated) == aux_o["updated"], step
        for k in ("coverage", "bucket_on", "strat"):
            np.testing.assert_array_equal(got[k], st_np[k], err_msg=f"{k} step {step}")
        np.testing.assert_array_equal(got["read_starts"].astype(np.float64), st_np["read_starts"])
        updated += aux_o["updated"]
    assert updated >= 5
    frac = float(state.strat[:, eng.strat_valid, :].float().mean())
    assert 0.0 < frac < 1.0


@pytest.mark.parametrize("alpha", [0.4, 1.7])
def test_general_alpha_engine_matches_jax(alpha):
    rng = np.random.default_rng(int(alpha * 100))
    lay = _layout(6, nb=2)
    je = jruns.RunsEngine(lay, config=jruns.RunsConfig(debug_aux=True, fhat_alpha=alpha))
    te = truns.RunsEngine(lay, config=truns.RunsConfig(debug_aux=True, fhat_alpha=alpha),
                          device="cpu")
    js, ts = je.init_state(), te.init_state()
    jp, tp = je.make_params(CCL, 5300.0), te.make_params(CCL, 5300.0)
    for step in range(6):
        b = _random_batch(rng, lay, n_obs=100_000, nb=2)
        js, ja = je.step(js, _jbatch(b), jp)
        ts, ta = te.step(ts, batch_from_numpy(b, "cpu"), tp)
        got = state_to_numpy(ts)
        for k in (*STATE, "strat"):
            np.testing.assert_array_equal(got[k], np.asarray(getattr(js, k)),
                                          err_msg=f"{k} step {step}")
        np.testing.assert_allclose(ta.scores.numpy(), np.asarray(ja.scores), rtol=1e-5, atol=5e-5)
        assert bool(ta.updated) == bool(ja.updated)


# ------------------------------------------------------------------- (c) ----

def test_f64_scores_match_jax_and_the_oracles_own_scores():
    rng = np.random.default_rng(64)
    lay = _layout(7, nb=2)
    cfg = dict(debug_aux=True, dtype="float64")
    je = jruns.RunsEngine(lay, config=jruns.RunsConfig(**cfg))
    te = truns.RunsEngine(lay, config=truns.RunsConfig(**cfg), device="cpu")
    assert te.tiny == float(np.finfo(np.float64).tiny)
    js, ts = je.init_state(), te.init_state()
    st_np = state_to_numpy(ts)
    assert st_np["read_starts"].dtype == np.float64
    jp, tp = je.make_params(CCL, 5300.0), te.make_params(CCL, 5300.0)
    valid = te.strat_valid.numpy()
    updated = 0
    for step in range(6):
        b = _random_batch(rng, lay, n_obs=100_000, nb=2)
        js, ja = je.step(js, _jbatch(b), jp)
        ts, ta = te.step(ts, batch_from_numpy(b, "cpu"), tp)
        assert ta.scores.dtype == torch.float64 and ta.vec.dtype == torch.float64
        got = state_to_numpy(ts)
        for k in (*STATE, "strat"):
            np.testing.assert_array_equal(got[k], np.asarray(getattr(js, k)),
                                          err_msg=f"{k} step {step}")
        np.testing.assert_allclose(ta.scores.numpy(), np.asarray(ja.scores), rtol=1e-10,
                                   atol=1e-10)
        st_np, aux_o = oracle.full_update(te, st_np, b, CCL, 5300.0, fast_scores=True)
        np.testing.assert_array_equal(got["strat"][:, valid], st_np["strat"][:, valid],
                                      err_msg=f"strat vs the oracle's own scores, step {step}")
        assert bool(ta.updated) == aux_o["updated"]
        updated += aux_o["updated"]
    assert updated >= 2


# ------------------------------------------------------------------- (d) ----

def _benefit(eng, scores):
    """The port engine's benefit [nb, Gd, 2] for its post-mask scores, and
    the bar within which another f32 summation order's benefit agrees with
    it (rtol 1e-6 + 4096 f32 eps of the largest row total: a float sum of
    one scan tile's non-negative terms, in another order)."""
    ds = tg.ds_row_sums(scores, eng.benefit_dtype)
    kw = eng.benefit_args(eng.init_state(), ds, None, None, eng.make_params(CCL, 5300.0))
    _, ben = tg.expected_benefit(ds, tg.ccl_windows(kw["approx_ccl"], kw["win_clamp"]),
                                 eng.seg_start, eng.seg_end,
                                 mu_ds=kw["mu_ds"], tiled=eng.tile_scan)
    total = float(ds.double().sum(dim=1).max())
    return ben, 1e-6 * ben.abs() + 4096 * float(np.finfo(np.float32).eps) * total


def _threshold_rule(t_a: float, t_b: float, diff, ben, slack) -> None:
    """Test (d)'s rule: thresholds at most one exponent bin apart, and each
    differing cell's benefit between them, widened by its slack."""
    lo, hi = min(t_a, t_b), max(t_a, t_b)
    assert hi <= 2 * lo * (1 + 1e-5), (t_a, t_b)
    b, e = ben[diff], slack[diff]
    assert bool(((b >= lo - e) & (b <= hi + e)).all())


def test_f32_decisions_match_jax_f32_decision_path():
    rng = np.random.default_rng(32)
    lay = _layout(8, nb=2)
    cfg = dict(debug_aux=True, benefit_dtype="float32")
    je = jruns.RunsEngine(lay, config=jruns.RunsConfig(**cfg))
    te = truns.RunsEngine(lay, config=truns.RunsConfig(**cfg), device="cpu")
    js, ts = je.init_state(), te.init_state()
    jp, tp = je.make_params(CCL, 5300.0), te.make_params(CCL, 5300.0)
    flipped = updated = 0
    for step in range(8):
        b = _random_batch(rng, lay, n_obs=100_000, nb=2)
        js, ja = je.step(js, _jbatch(b), jp)
        ts, ta = te.step(ts, batch_from_numpy(b, "cpu"), tp)
        assert ta.threshold.dtype == torch.float32
        got = state_to_numpy(ts)
        for k in STATE:
            np.testing.assert_array_equal(got[k], np.asarray(getattr(js, k)),
                                          err_msg=f"{k} step {step}")
        assert bool(ta.updated) == bool(ja.updated)
        updated += bool(ta.updated)
        diff = torch.from_numpy(got["strat"] != np.asarray(js.strat))
        if bool(diff.any()):
            _threshold_rule(float(ja.threshold), float(ta.threshold), diff,
                            *_benefit(te, ta.scores))
            flipped += int(diff.sum())
    print(f"f32 decision path: {flipped} strat cells differ from JAX's over 8 steps")
    assert updated >= 2


def test_f32_decisions_agree_with_f64_decisions():
    """The f32 decision path beside the default one on the same batches:
    the same rule as against JAX (a one-bin threshold shift at most, and
    flips only between the thresholds)."""
    rng = np.random.default_rng(33)
    lay = _layout(9)
    e64 = truns.RunsEngine(lay, config=truns.RunsConfig(debug_aux=True), device="cpu")
    e32 = truns.RunsEngine(lay, config=truns.RunsConfig(debug_aux=True, benefit_dtype="float32"),
                           device="cpu")
    s64, s32 = e64.init_state(), e32.init_state()
    p = e64.make_params(CCL, 5300.0)
    for step in range(6):
        b = batch_from_numpy(_random_batch(rng, lay, n_obs=120_000), "cpu")
        s64, a64 = e64.step(s64, b, p)
        s32, a32 = e32.step(s32, b, p)
        for k in STATE:
            assert torch.equal(getattr(s64, k), getattr(s32, k)), (k, step)
        assert torch.equal(a64.scores, a32.scores)
        diff = s64.strat != s32.strat
        if bool(diff.any()):
            _threshold_rule(float(a64.threshold), float(a32.threshold), diff,
                            *_benefit(e32, a32.scores))
        # and they stay in step: the f64 path's own strategy feeds neither
        s32.strat.copy_(s64.strat)


# ------------------------------------------------------------------- (f) ----

@pytest.mark.parametrize("field", ["dtype", "benefit_dtype"])
@pytest.mark.parametrize("name", ["float16", "bfloat16", "int32"])
def test_unsupported_dtypes_raise(field, name):
    lay = _layout(1)
    cfg = truns.RunsConfig(**{field: name})
    if (field, name) == ("dtype", "float16"):  # the one of these the port now runs
        assert truns.RunsEngine(lay, config=cfg, device="cpu").tables.packed.dtype == torch.float16
        return
    with pytest.raises(ValueError, match="the port runs float32, float64" if field != "dtype"
                       else "the port runs float16, float32, float64"):
        truns.RunsEngine(lay, config=cfg, device="cpu")


def test_option_dtypes_reach_state_and_aux():
    lay = _layout(2)
    rng = np.random.default_rng(2)
    b = batch_from_numpy(_random_batch(rng, lay, n_obs=40_000), "cpu")
    for dt, bdt in (("float64", "float64"), ("float32", "float32"), ("float64", "float32")):
        eng = truns.RunsEngine(lay, config=truns.RunsConfig(dtype=dt, benefit_dtype=bdt),
                               device="cpu")
        S, D = truns.DTYPES[dt], truns.DTYPES[bdt]
        assert eng.tables.packed.dtype == S and eng.contig_denom.dtype == D
        assert eng.fhat_rows.dtype == D and eng.tile_scan
        state, aux = eng.step(eng.init_state(), b, eng.make_params(CCL, 5300.0))
        assert state.read_starts.dtype == S and aux.vec.dtype == S
        assert aux.threshold.dtype == D
    assert not truns.RunsEngine(lay, device="cpu").tile_scan
