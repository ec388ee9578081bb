"""RunsConfig(dtype="float16") in the port, against the JAX f16 engine.

The JAX engine runs f16 scores, read starts and aux as XLA's CPU backend
compiles them: every dot and reduction sums f32 values and rounds once,
every other op rounds to f16 (bossruns_torch/ops/scores.py). The port's
plain versions follow that program, so:

(a) f16 ``ScoreTables`` equal JAX's bit for bit;
(b) plain f16 scores equal JAX ``site_scores_t`` f16 (the engine's [nb, 5,
    N] layout) bit for bit, haploid and diploid, with empty sites and the
    990 clip, and on an adversarial diploid model (random phi and prior)
    whose posteriors spread over all 15 genotypes, where the q dot's
    addition tree decides the last bit (ROADMAP F15);
(c) read starts saturate as JAX's f16 ``scatter_add_2d``: 2048 + 1 stays
    2048, and a state restored above 2048 with an odd mantissa moves one
    step (to the even one) and stays;
(d) coverage sums of 2049, 4097 and 70,000 (inf in f16) through the
    engine: bucket_on, zeroed and aux (inf included) equal JAX's;
(e) the port's f16 engine against the JAX f16 engine over 6 steps at
    2.4 Mb: coverage, read_starts, bucket_on and zeroed exact, scores
    within (b), and, given the JAX engine's own scores, strategy and
    threshold bit for bit; with benefit_dtype="float32" the state exact and
    the strategy equal or one threshold bin away (test_torch_options.py's
    rule);
(f) the (1, 2) and (2, 2) meshes equal the single engine at f16 bit for
    bit, with either decision dtype;
(g) an f16 checkpoint round trip, a JAX f16 state carried across, and
    "bfloat16" still raising.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bossruns_tpu.models import runs as jruns
from bossruns_tpu.models.layout import build_layout
from bossruns_tpu.ops import genome_ops as jg
from bossruns_tpu.ops import model as jmodel
from bossruns_tpu.ops import scores as jscores
from bossruns_tpu.ops.model import make_model as jmake_model
from bossruns_torch.models import runs as truns
from bossruns_torch.models.convert import batch_from_numpy, state_to_numpy
from bossruns_torch.ops import model as tmodel
from bossruns_torch.ops import scores as tscores
from bossruns_torch.ops.model import make_model
from bossruns_torch.parallel import mesh as tmesh
from test_engine_parity import _random_batch
from test_torch_options import _benefit, _threshold_rule

torch.set_num_threads(2)

CCL = np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400])
STATE = ("coverage", "zeroed", "bucket_on", "read_starts")
F16 = dict(dtype="float16")


def _jbatch(b):
    return jruns.ReadBatch(**{k: jnp.asarray(v) for k, v in b.items()})


def _assert_scores(got: np.ndarray, want: np.ndarray) -> None:
    """(b)'s bar: f16 scores equal bit for bit."""
    assert got.dtype == np.float16 == want.dtype
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


def adversarial_model(module, rng):
    """A diploid ObservationModel of ``module`` (the port's or the JAX
    package's ops.model) with random phi (Dirichlet(0.3) columns) and a
    random prior: its posteriors spread over all 15 genotypes, so the q
    dot sums 15 terms of one size and its addition tree decides the last
    f16 bit. The default models concentrate the posterior; no count vector
    searched (all of 0-12 per symbol, a grid to 990, 12M random ones)
    reaches a site whose f16 score that tree moves there."""
    phi = rng.dirichlet(np.full(5, 0.3), 15).T
    prior = rng.dirichlet(np.ones(15), 4)
    return module.ObservationModel(2, phi, prior)


# ------------------------------------------------------------------- (a) ----

@pytest.mark.parametrize("ploidy", [1, 2])
def test_f16_tables_equal_jax(ploidy):
    m = make_model(ploidy=ploidy)
    jt = jscores.ScoreTables(jmake_model(ploidy=ploidy), jnp.float16)
    tt = tscores.ScoreTables(m, torch.float16, device="cpu")
    for k in ("phi", "log_phi", "log_prior", "k"):
        want = np.asarray(getattr(jt, k))
        got = getattr(tt, k).numpy()
        assert got.dtype == np.float16 == want.dtype
        np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16), err_msg=k)


# ------------------------------------------------------------------- (b) ----

@pytest.mark.parametrize("case", [1, 2, "adversarial"])
def test_plain_f16_scores_match_jax(case):
    """Cases 1 and 2: the engine's model at that ploidy; "adversarial":
    ``adversarial_model`` over counts of 0-5, which the addition tree of
    the 15-term q dot moves at 8 of its 120,000 scores (the tree before
    F15's fix missed JAX there)."""
    rng = np.random.default_rng(16 + case if case != "adversarial" else 0)
    n = 60_000
    if case == "adversarial":
        jm = adversarial_model(jmodel, rng)
        m = tmodel.ObservationModel(jm.ploidy, jm.phi, jm.prior)
        cnt = rng.integers(0, 6, (2, 5, n)).astype(np.uint16)
    else:
        jm, m = jmake_model(ploidy=case), make_model(ploidy=case)
        cnt = rng.integers(0, 12, (2, 5, n)).astype(np.uint16)
        cnt[:, :, : n // 10] = 0                                          # empty sites
        cnt[:, :, n // 10: n // 5] = rng.integers(900, 1300, (2, 5, n // 10))  # the 990 clip
        cnt[:, :, n // 5: n // 4] = rng.integers(0, 41, (2, 5, n // 20))
    ref = rng.integers(0, 4, n).astype(np.int8)
    jt = jscores.ScoreTables(jm, jnp.float16)
    tt = tscores.ScoreTables(m, torch.float16, device="cpu")
    sj, ej = jscores.site_scores_t(jnp.asarray(cnt), jnp.asarray(ref), jt)
    st, et = tscores.site_scores_t(torch.from_numpy(cnt), torch.from_numpy(ref), tt)
    assert st.dtype == torch.float16
    _assert_scores(st.numpy(), np.asarray(sj))
    _assert_scores(et.numpy(), np.asarray(ej))
    # a score rounded from f32 once misses JAX's f16 program at most sites
    s32 = tscores.site_scores_t(torch.from_numpy(cnt), torch.from_numpy(ref),
                                tscores.ScoreTables(m, device="cpu"))[0]
    assert (s32.half().numpy() != np.asarray(sj)).mean() > 0.5


# ------------------------------------------------------------------- (c) ----

def test_f16_read_start_adds_saturate_as_jax():
    z = np.zeros((6, 2), np.float16)
    z[1, 0], z[2, 0], z[3, 1] = 2050.0, 2052.0, 4100.0  # odd, even, odd mantissas
    rows = np.array([0] * 5000 + [1] * 3 + [2] * 3 + [3] * 7 + [4] * 2047, np.int32)
    strand = np.array([0] * 5013 + [1] * 2047, np.int32)
    strand[5006:5013] = 1
    w = np.ones(rows.shape[0], np.float32)
    want = np.asarray(jg.scatter_add_2d(jnp.asarray(z), jnp.asarray(rows), jnp.asarray(strand),
                                        jnp.asarray(w)))
    got = torch.from_numpy(z.copy())
    got.view(-1).index_add_(0, torch.from_numpy(rows * 2 + strand).long(),
                            torch.from_numpy(w).half())
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 0] == 2048 and want[1, 0] == 2052 and want[2, 0] == 2052
    assert want[3, 1] == 4100 and want[4, 1] == 2047  # above 4096 a +1 never ties


def _short_layout(seed: int, nb: int = 1, align: int = 1):
    """Contigs of 40,000 sites (whose f16 site count is finite; kept by a
    lower min_len), 130,000 and 110,000 (inf in f16, as for every contig
    of the default min_len: their mean is 0, or NaN with an inf coverage
    sum, and they never drop out, as in the JAX engine)."""
    rng = np.random.default_rng(seed)
    return build_layout({c: rng.integers(0, 4, n).astype(np.uint8)
                         for c, n in (("s", 40_000), ("a", 130_000), ("b", 110_000))},
                        n_barcodes=nb, align_chunks=align, min_len=30_000)


def test_f16_engine_read_starts_match_jax_across_2048():
    lay = _short_layout(3)
    je = jruns.RunsEngine(lay, config=jruns.RunsConfig(**F16))
    te = truns.RunsEngine(lay, config=truns.RunsConfig(**F16), device="cpu")
    rng = np.random.default_rng(3)
    js, ts = je.init_state(), te.init_state()
    rs = np.zeros((lay.Wf_pad, 2), np.float16)
    rs[:4, 0] = [2050.0, 2052.0, 2049.0, 3001.0]
    rs[4, 1] = 2047.0
    js = js._replace(read_starts=jnp.asarray(rs))
    ts.read_starts.copy_(torch.from_numpy(rs))
    jp, tp = je.make_params(CCL, 5300.0), te.make_params(CCL, 5300.0)
    for step in range(3):
        b = _random_batch(rng, lay, n_obs=20_000, n_rs=1500)
        b["rs_row"][:900] = rng.integers(0, 6, 900)
        js, _ = je.step(js, _jbatch(b), jp)
        ts, _ = te.step(ts, batch_from_numpy(b, "cpu"), tp)
        np.testing.assert_array_equal(ts.read_starts.numpy(), np.asarray(js.read_starts),
                                      err_msg=f"step {step}")
    assert ts.read_starts.dtype == torch.float16
    assert float(ts.read_starts.max()) >= 2048


# ------------------------------------------------------------------- (d) ----

def test_f16_coverage_sums_round_and_overflow_as_jax():
    lay = _short_layout(4)
    je = jruns.RunsEngine(lay, config=jruns.RunsConfig(debug_aux=True, **F16))
    te = truns.RunsEngine(lay, config=truns.RunsConfig(debug_aux=True, **F16), device="cpu")
    cov = np.zeros((1, 5, lay.G_pad), np.uint16)
    o_s, o_a = int(lay.offsets[0]), int(lay.offsets[1])
    # contig s: a window of 2049 / 4097 sums (f16 rounds them to 2048 /
    # 4096), a 70,000 sum (inf: contig mean inf, every site low), and
    # moderate coverage beside them
    cov[0, 0, o_s: o_s + 20_000] = 9
    cov[0, 0, o_s + 100: o_s + 300] = 2049
    cov[0, 1, o_s + 300: o_s + 500] = 4097
    cov[0, 0, o_s + 700], cov[0, 1, o_s + 700] = 35_000, 35_000
    # contig a: a run above 2048 in a long contig (f16 site count inf)
    cov[0, 2, o_a + 1000: o_a + 21_000] = 2051
    cov[0, 3, o_a + 30_000] = 65_535
    rng = np.random.default_rng(4)
    b = _random_batch(rng, lay, n_obs=8_000)
    js = je.init_state()._replace(coverage=jnp.asarray(cov))
    ts = te.init_state()
    ts.coverage.copy_(torch.from_numpy(cov.view(np.int16)).view(torch.uint16))
    jp, tp = je.make_params(CCL, 5300.0), te.make_params(CCL, 5300.0)
    for step in range(2):
        js, ja = je.step(js, _jbatch(b), jp)
        ts, ta = te.step(ts, batch_from_numpy(b, "cpu"), tp)
        got = state_to_numpy(ts)
        for k in (*STATE, "strat"):
            np.testing.assert_array_equal(got[k], np.asarray(getattr(js, k)),
                                          err_msg=f"{k} step {step}")
        np.testing.assert_array_equal(ta.vec.numpy(), np.asarray(ja.vec))
        _assert_scores(ta.scores.numpy(), np.asarray(ja.scores))
    assert ta.vec.dtype == torch.float16 and np.isinf(float(ta.vec[3]))
    assert got["zeroed"][0, o_s: o_s + 20_000].all()  # contig s dropped whole
    assert got["bucket_on"].any()


# ------------------------------------------------------------------- (e) ----

def _layout_24(seed: int):
    """2.4 Mb: three long contigs and a 40,000-site one."""
    rng = np.random.default_rng(seed)
    return build_layout({c: rng.integers(0, 4, n).astype(np.uint8) for c, n in
                         (("a", 1_000_000), ("b", 800_000), ("c", 560_000), ("s", 40_000))},
                        min_len=30_000)


def _override_scores(monkeypatch, box):
    """The port engine's H2 call returns box["scores"] (the JAX engine's
    post-mask f16 scores: the row stage's dropout mask is idempotent on
    them) beside its own coverage sums."""
    real = truns.site_scores

    def fake(**kw):
        s, c = real(**kw)
        return torch.from_numpy(box["scores"].copy()), c

    monkeypatch.setattr(truns, "site_scores", fake)


def test_f16_engine_matches_jax_f16_engine(monkeypatch):
    lay = _layout_24(24)
    cfg = dict(debug_aux=True, **F16)
    je = jruns.RunsEngine(lay, config=jruns.RunsConfig(**cfg))
    te = truns.RunsEngine(lay, config=truns.RunsConfig(**cfg), device="cpu")
    tg_ = truns.RunsEngine(lay, config=truns.RunsConfig(**cfg), device="cpu")
    assert te.tiny == float(np.finfo(np.float16).tiny)
    rng = np.random.default_rng(24)
    js, ts, tgs = je.init_state(), te.init_state(), tg_.init_state()
    jp, tp = je.make_params(CCL, 5300.0), te.make_params(CCL, 5300.0)
    box, updated = {}, 0
    for step in range(6):
        b = _random_batch(rng, lay, n_obs=150_000)
        js, ja = je.step(js, _jbatch(b), jp)
        ts, ta = te.step(ts, batch_from_numpy(b, "cpu"), tp)
        got = state_to_numpy(ts)
        for k in STATE:
            np.testing.assert_array_equal(got[k], np.asarray(getattr(js, k)),
                                          err_msg=f"{k} step {step}")
        _assert_scores(ta.scores.numpy(), np.asarray(ja.scores))
        # given JAX's scores, the row and benefit stages give JAX's decisions
        box["scores"] = np.asarray(ja.scores)
        with monkeypatch.context() as mp:
            _override_scores(mp, box)
            tgs, tga = tg_.step(tgs, batch_from_numpy(b, "cpu"), tp)
        given = state_to_numpy(tgs)
        for k in (*STATE, "strat"):
            np.testing.assert_array_equal(given[k], np.asarray(getattr(js, k)),
                                          err_msg=f"{k} given JAX's scores, step {step}")
        assert float(tga.threshold) == float(ja.threshold)
        np.testing.assert_array_equal(tga.vec.numpy(), np.asarray(ja.vec))
        updated += bool(ja.updated)
    assert updated >= 2


def test_f16_engine_with_f32_decisions_matches_jax():
    lay = _layout_24(25)
    cfg = dict(debug_aux=True, benefit_dtype="float32", **F16)
    je = jruns.RunsEngine(lay, config=jruns.RunsConfig(**cfg))
    te = truns.RunsEngine(lay, config=truns.RunsConfig(**cfg), device="cpu")
    rng = np.random.default_rng(25)
    js, ts = je.init_state(), te.init_state()
    jp, tp = je.make_params(CCL, 5300.0), te.make_params(CCL, 5300.0)
    flipped = 0
    for step in range(6):
        b = _random_batch(rng, lay, n_obs=150_000)
        js, ja = je.step(js, _jbatch(b), jp)
        ts, ta = te.step(ts, batch_from_numpy(b, "cpu"), tp)
        assert ta.threshold.dtype == torch.float32
        got = state_to_numpy(ts)
        for k in STATE:
            np.testing.assert_array_equal(got[k], np.asarray(getattr(js, k)),
                                          err_msg=f"{k} step {step}")
        diff = torch.from_numpy(got["strat"] != np.asarray(js.strat))
        if bool(diff.any()):
            _threshold_rule(float(ja.threshold), float(ta.threshold), diff,
                            *_benefit(te, ta.scores))
            flipped += int(diff.sum())
    print(f"f16 scores, f32 decisions: {flipped} strat cells differ from JAX's over 6 steps")


# ------------------------------------------------------------------- (f) ----

@pytest.mark.parametrize("bdt", ["float64", "float32"])
@pytest.mark.parametrize("Sb,Sg", [(1, 2), (2, 2)])
def test_f16_mesh_equals_single(bdt, Sb, Sg):
    nb = 2 if Sb > 1 else 1
    lay = _short_layout(30 + Sb, nb=nb, align=4 * Sg)
    cfg = truns.RunsConfig(debug_aux=True, benefit_dtype=bdt, **F16)
    single = truns.RunsEngine(lay, config=cfg, device="cpu")
    sharded = tmesh.ShardedRunsEngine(lay, tmesh.make_mesh(["cpu"] * (Sb * Sg), Sb), config=cfg)
    rng = np.random.default_rng(40 + Sb)
    s1, s2 = single.init_state(), sharded.init_state()
    params = single.make_params(CCL, 5300.0)
    updated = 0
    for step in range(4):
        b = _random_batch(rng, lay, n_obs=150_000 * nb, nb=nb, n_rs=1200)
        s1, a1 = single.step(s1, batch_from_numpy(b, "cpu"), params)
        s2, a2 = sharded.step(s2, batch_from_numpy(b, "cpu"), params)
        got, want = sharded.state_numpy(s2), state_to_numpy(s1)
        for k in (*STATE, "strat"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} step {step}")
        assert torch.equal(a2.vec, a1.vec) and a1.vec.dtype == torch.float16
        assert torch.equal(a2.threshold, a1.threshold)
        assert torch.equal(a2.scores, a1.scores)
        updated += bool(a1.updated)
    assert updated >= 1


# ------------------------------------------------------------------- (g) ----

def test_f16_checkpoint_round_trip_and_jax_state(tmp_path):
    from bossruns_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    lay = _short_layout(5)
    rng = np.random.default_rng(5)
    je = jruns.RunsEngine(lay, config=jruns.RunsConfig(**F16))
    eng = truns.RunsEngine(lay, config=truns.RunsConfig(**F16), device="cpu")
    batches = [_random_batch(rng, lay, n_obs=30_000, n_rs=3000) for _ in range(3)]
    for b in batches:
        b["rs_row"][:2500] = 1  # one window crosses 2048
    js = je.init_state()
    jp, tp = je.make_params(CCL, 5300.0), eng.make_params(CCL, 5300.0)
    for b in batches[:2]:
        js, _ = je.step(js, _jbatch(b), jp)
    jstate = {k: np.asarray(getattr(js, k)) for k in (*STATE, "strat")}
    assert jstate["read_starts"].dtype == np.float16 and jstate["read_starts"].max() == 2048
    state = eng.state_from_numpy(jstate)
    assert state.read_starts.dtype == torch.float16
    np.testing.assert_array_equal(state.read_starts.numpy(), jstate["read_starts"])
    save_checkpoint(tmp_path, state, {"batch": 2})
    loaded, host, _ = load_checkpoint(tmp_path, "cpu", dtype=torch.float16)
    assert host["batch"] == 2
    for k in (*STATE, "strat"):
        assert torch.equal(getattr(loaded, k), getattr(state, k)), k
    js, _ = je.step(js, _jbatch(batches[2]), jp)
    loaded, _ = eng.step(loaded, batch_from_numpy(batches[2], "cpu"), tp)
    for k in (*STATE, "strat"):
        np.testing.assert_array_equal(state_to_numpy(loaded)[k], np.asarray(getattr(js, k)),
                                      err_msg=k)


@pytest.mark.parametrize("field", ["dtype", "benefit_dtype"])
def test_bfloat16_still_raises(field):
    with pytest.raises(ValueError, match="cannot run it either"):
        truns.RunsEngine(_short_layout(1), config=truns.RunsConfig(**{field: "bfloat16"}),
                         device="cpu")
    if field == "dtype":  # the JAX engine fails on it too (np.finfo)
        with pytest.raises(ValueError):
            jruns.RunsEngine(_short_layout(1), config=jruns.RunsConfig(dtype="bfloat16"))
