"""Port engine (bossruns_torch.models.runs) vs the f64 oracle and the JAX engine.

(a) the test_engine_parity contract, twinned: given the port's own f32
    scores, coverage, bucket_on, read_starts and strat equal the f64 numpy
    oracle EXACTLY over a 20-batch soak;
(b) the port engine against the JAX RunsEngine on the same batches and
    starting state (carried over with models/convert.py): coverage,
    zeroed, bucket_on and read_starts exact; scores within the f32
    tolerance of test_torch_scores.py; strat exact, and any flipped row
    must lie where the two engines' scores differ;
(c) padding and out-of-range rows in the int64 index math;
(d) diploid;
(e) the scores and coverage sums kept between steps: H2 rescores only the
    tiles H1 touched while the state is the one the engine last stepped,
    and every site otherwise. Over 14 steps with 2 barcodes (a copy_
    restore, a state_from_numpy state, two states stepped in turns; sites
    zeroed in untouched tiles, zeroed sites that change again, frozen
    sites), eagerly and through the stand-in graph cache, the engine
    equals an engine that rescores every site bit for bit, and the JAX
    engine as (b) holds it; the plain H2 writes only the flagged tiles.
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bossruns_tpu import oracle
from bossruns_tpu.io.coo_native import pad_split, split_runs
from bossruns_tpu.models import runs as jruns
from bossruns_tpu.models.layout import DS, build_layout
from bossruns_tpu.ops.model import make_model
from bossruns_torch.models import runs as truns
from bossruns_torch.models.convert import batch_from_numpy, state_from_numpy, state_to_numpy
from bossruns_torch.ops import genome_ops as tg
from bossruns_torch.ops import scores as ts
from bossruns_torch.utils import spans
from test_engine_parity import _random_batch
from test_torch_graph import _graphed

torch.set_num_threads(2)

CCL = np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400])


def _soak_oracle(rng, lay, eng, n_steps, n_obs):
    state = eng.init_state()
    st_np = state_to_numpy(state)
    st_np["read_starts"] = st_np["read_starts"].astype(np.float64)
    params = eng.make_params(CCL, 5300.0)
    updated = 0
    for step in range(n_steps):
        b = _random_batch(rng, lay, n_obs=n_obs, len_b=eng.model.len_b)
        state, aux = eng.step(state, batch_from_numpy(b, "cpu"), params)
        st_np, aux_o = oracle.full_update(eng, st_np, b, CCL, 5300.0,
                                          scores_override=aux.scores.numpy())
        got = state_to_numpy(state)
        assert bool(aux.any_on) == aux_o["any_on"], step
        assert bool(aux.updated) == aux_o["updated"], step
        for k in ("coverage", "bucket_on", "strat"):
            np.testing.assert_array_equal(got[k], st_np[k], err_msg=f"{k} step {step}")
        np.testing.assert_array_equal(got["read_starts"].astype(np.float64), st_np["read_starts"])
        if aux_o["updated"]:
            updated += 1
            np.testing.assert_allclose(float(aux.threshold), aux_o["threshold"], rtol=1e-12)
    return state, updated


def test_port_engine_matches_oracle_decisions_exactly(rng):
    seq_a = rng.integers(0, 4, 150_000).astype(np.uint8)
    seq_b = rng.integers(0, 4, 120_000).astype(np.uint8)
    lay = build_layout({"a": seq_a, "b": seq_b})
    eng = truns.RunsEngine(lay, config=truns.RunsConfig(debug_aux=True), device="cpu")
    state, updated = _soak_oracle(rng, lay, eng, n_steps=20, n_obs=120_000)
    assert updated >= 15
    frac = state.strat[:, eng.strat_valid, :].float().mean()
    assert 0.0 < float(frac) < 1.0


def test_port_engine_matches_oracle_diploid(rng):
    seq = rng.integers(0, 4, 140_000).astype(np.uint8)
    lay = build_layout({"a": seq})
    eng = truns.RunsEngine(lay, make_model(ploidy=2), truns.RunsConfig(debug_aux=True),
                           device="cpu")
    _, updated = _soak_oracle(rng, lay, eng, n_steps=5, n_obs=100_000)
    assert updated >= 2


def test_port_engine_matches_jax_engine(rng):
    seq_a = rng.integers(0, 4, 130_000).astype(np.uint8)
    seq_b = rng.integers(0, 4, 110_000).astype(np.uint8)
    lay = build_layout({"a": seq_a, "b": seq_b}, n_barcodes=2)
    je = jruns.RunsEngine(lay, config=jruns.RunsConfig(debug_aux=True))
    te = truns.RunsEngine(lay, config=truns.RunsConfig(debug_aux=True), device="cpu")
    js = je.init_state()
    # start from a nonzero state carried over from the JAX side
    warm = _random_batch(rng, lay, n_obs=60_000, nb=2)
    js, _ = je.step(js, jruns.ReadBatch(**{k: jnp.asarray(v) for k, v in warm.items()}),
                    je.make_params(CCL, 5300.0))
    ts = state_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()}, "cpu")
    jp, tp = je.make_params(CCL, 5300.0), te.make_params(CCL, 5300.0)
    max_w = max(CCL) // DS
    for step in range(8):
        b = _random_batch(rng, lay, n_obs=100_000, nb=2)
        js, ja = je.step(js, jruns.ReadBatch(**{k: jnp.asarray(v) for k, v in b.items()}), jp)
        ts, ta = te.step(ts, batch_from_numpy(b, "cpu"), tp)
        _assert_matches_jax(ts, ta, js, ja, max_w, step)


def _assert_matches_jax(ts, ta, js, ja, max_w: int, step) -> None:
    """The port's state and aux against the JAX engine's after one step:
    coverage, zeroed, bucket_on and read_starts exact, scores within the
    f32 tolerance, strat exact but where the two engines' scores differ in
    a flipped row's benefit windows."""
    got = state_to_numpy(ts)
    for k in ("coverage", "zeroed", "bucket_on", "read_starts"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(js, k)),
                                      err_msg=f"{k} step {step}")
    s_j, s_t = np.asarray(ja.scores), ta.scores.numpy()
    np.testing.assert_allclose(s_t, s_j, rtol=1e-5, atol=5e-5)
    assert bool(ta.any_on) == bool(ja.any_on)
    assert bool(ta.updated) == bool(ja.updated)
    flips = np.argwhere(got["strat"] != np.asarray(js.strat))
    if flips.size:
        # a flip is allowed only where the scores that feed its benefit
        # windows differ between the engines
        diff_ds = (s_t != s_j).reshape(s_t.shape[0], -1, DS).any(axis=2)
        for bc, r, _ in flips:
            lo, hi = max(r - max_w, 0), r + max_w + 1
            assert diff_ds[bc, lo:hi].any(), (step, bc, r)


def _rows(mr, ex):
    """CovRows from ([(bc, g, len)], [(bcsym, g)]) lists, numpy dtypes kept."""
    mr = np.array(mr, np.int64).reshape(-1, 3)
    ex = np.array(ex, np.int64).reshape(-1, 2)
    t = lambda a, dt: torch.from_numpy(a.astype(dt))
    return tg.CovRows(t(mr[:, 0], np.uint8), t(mr[:, 1], np.uint32), t(mr[:, 2], np.uint16),
                      t(ex[:, 0], np.uint16), t(ex[:, 1], np.uint32))


def test_padding_and_out_of_range_rows_are_dropped():
    nb, G = 2, 1000
    seq = torch.from_numpy((np.arange(G) % 4).astype(np.int8))
    pad = int(tg.EX_PAD)
    rows = _rows(
        mr=[(0, 10, 5), (1, 995, 10),       # real; the second is cut at nb*G
            (0, 50, 0), (255, 2**32 - 1, 0),  # mr_len 0: padding
            (7, 3, 4)],                        # barcode beyond nb: flat >= nb*G
        ex=[(0 * 5 + 2, 20), (1 * 5 + 4, 999),  # real
            (0, pad), (7, pad),                 # EX_PAD, with zero and nonzero bcsym
            (nb * 5, 0), (nb * 5 + 3, 100)],   # flat index >= nb*5*G
    )
    cov = torch.zeros((nb, 5, G), dtype=torch.uint16)
    changed = tg.coverage_update(cov, seq, rows)
    want = np.zeros((nb, 5, G), np.int64)
    for g in range(10, 15):
        want[0, g % 4, g] += 1
    for g in range(995, 1000):
        want[1, g % 4, g] += 1
    want[0, 2, 20] += 1
    want[1, 4, 999] += 1
    np.testing.assert_array_equal(cov.numpy(), want)
    np.testing.assert_array_equal(changed.numpy(), (want != 0).any(axis=(0, 1)))


def test_gated_rows_keep_full_when_accepted_and_trunc_when_rejected():
    G = 500
    seq = torch.zeros(G, dtype=torch.int8)
    full = _rows(mr=[(0, 0, 10), (0, 100, 10)], ex=[(1, 50), (2, 150)])
    trunc = _rows(mr=[(0, 0, 4), (0, 100, 4)], ex=[(3, 60), (4, 160)])
    rd = lambda *v: torch.tensor(v, dtype=torch.uint32)
    full = full._replace(mr_read=rd(0, 1), ex_read=rd(0, 1))
    trunc = trunc._replace(mr_read=rd(0, 1), ex_read=rd(0, 1))
    bits = torch.tensor([1, 0], dtype=torch.uint8)  # read 0 accepted, read 1 rejected
    cov = torch.zeros((1, 5, G), dtype=torch.uint16)
    tg.coverage_update(cov, seq, full, trunc, bits)
    want = np.zeros((1, 5, G), np.int64)
    want[0, 0, 0:10] = 1     # read 0: full run
    want[0, 1, 50] = 1       # read 0: full explicit
    want[0, 0, 100:104] = 1  # read 1: trunc run
    want[0, 4, 160] = 1      # read 1: trunc explicit
    np.testing.assert_array_equal(cov.numpy(), want)


def test_saturating_uint16_add():
    cov = torch.full((1, 5, 8), 65530, dtype=torch.int32).to(torch.uint16)
    seq = torch.zeros(8, dtype=torch.int8)
    tg.coverage_update(cov, seq, _rows(mr=[(0, 0, 8)] * 10, ex=[]))
    assert (cov[0, 0].to(torch.int32) == 65535).all()
    assert (cov[0, 1:].to(torch.int32) == 65530).all()


def test_gated_step_equals_classic_step(rng):
    """step_gated with bits == step on the rows those bits select."""
    from bossruns_torch.io.coo_native import pad_split, split_runs_rows

    seq = rng.integers(0, 4, 120_000).astype(np.uint8)
    lay = build_layout({"a": seq})
    eng = truns.RunsEngine(lay, device="cpu")
    n = 60
    rstart = rng.integers(0, 110_000, n).astype(np.int64)
    rlen = rng.integers(400, 3000, n).astype(np.int32)
    pos = np.concatenate([s + np.arange(m) for s, m in zip(rstart, rlen)])
    sym = lay.seq_int[pos].astype(np.int8)
    flip = rng.random(pos.shape[0]) < 0.05
    sym[flip] = rng.integers(0, 5, int(flip.sum()))
    qual = np.full(sym.shape[0], 40, np.int8)
    rrow = np.arange(n, dtype=np.int32)
    rbc = np.zeros(n, np.int32)
    f = split_runs_rows(lay, sym, qual, rstart, rlen, rbc, rrow)
    tl = np.minimum(rlen, 400)
    off = np.concatenate([[0], np.cumsum(rlen)[:-1]])
    sel = np.concatenate([o + np.arange(m) for o, m in zip(off, tl)])
    t = split_runs_rows(lay, sym[sel], qual[sel], rstart, tl, rbc, rrow)
    bits = (rng.random(n) < 0.5).astype(np.uint8)
    rs_row = rng.integers(0, lay.n_fhat, n).astype(np.int32)
    rs_strand = rng.integers(0, 2, n).astype(np.int32)
    gated = {f"{p}{k}": a for p, s in (("f_", f), ("t_", t))
             for k, a in zip(("mr_bc", "mr_g", "mr_len", "mr_read", "ex_bcsym", "ex_g", "ex_read"), s)}
    gated.update(rs_row=rs_row, rs_strand=rs_strand, rs_read=rrow)
    # classic: only the selected rows, packed and padded
    keep_f = lambda rows: bits[rows] == 1
    keep_t = lambda rows: bits[rows] == 0
    mf, ef = keep_f(f[3]), keep_f(f[6])
    mt, et = keep_t(t[3]), keep_t(t[6])
    cat = lambda i, m1, m2: np.concatenate([f[i][m1], t[i][m2]])
    split = (cat(0, mf, mt), cat(1, mf, mt), cat(2, mf, mt), cat(4, ef, et), cat(5, ef, et))
    batch = dict(pad_split(split), rs_row=rs_row, rs_strand=rs_strand,
                 rs_w=bits.astype(np.float32))
    params = eng.make_params(CCL, 5300.0)
    sa, _ = eng.step(eng.init_state(), batch_from_numpy(batch, "cpu"), params)
    gt = {k: torch.from_numpy(v) for k, v in gated.items()}
    sb, _ = eng.step_gated(eng.init_state(), gt, torch.from_numpy(bits), params)
    for k in truns.GenomeState._fields:
        assert torch.equal(getattr(sa, k), getattr(sb, k)), k


def test_strat_dict_is_a_copy():
    """strat_dict's arrays outlive the step: on the CPU they must not view
    the state the next step updates in place (one barcode, where the
    per-contig slice is already contiguous)."""
    rng = np.random.default_rng(7)
    lay = build_layout({"a": rng.integers(0, 4, 120_000).astype(np.uint8),
                        "b": rng.integers(0, 4, 110_000).astype(np.uint8)})
    eng = truns.RunsEngine(lay, device="cpu")
    state = eng.init_state()
    masks = eng.strat_dict(state)
    assert all(m.all() for m in masks.values())
    state.strat.fill_(False)
    assert all(m.all() for m in masks.values())
    assert not any(eng.strat_dict(state)[n].any() for n in masks)


# ------------------------------------------------------------------- (e) ----

def _window_batch(rng, lay, nb: int, n_runs: int, width: int, run_len: int = 40,
                  n_rs: int = 300) -> dict:
    """Runs of ``run_len`` at uniform starts inside one window of ``width``
    sites per contig, placed at random, on random barcodes; 5% of the
    symbols random (the batch form of test_engine_parity._random_batch)."""
    starts = []
    for c in range(lay.n_contigs):
        w0 = rng.integers(0, int(lay.lengths[c]) - width)
        starts.append(lay.offsets[c] + w0 + rng.integers(0, width - run_len, n_runs))
    rstart = np.concatenate(starts).astype(np.int64)
    pos = (rstart[:, None] + np.arange(run_len)[None, :]).ravel()
    sym = lay.seq_int[pos].astype(np.int8)
    flip = rng.random(pos.shape[0]) < 0.05
    sym[flip] = rng.integers(0, 5, int(flip.sum()))
    split = split_runs(lay, sym, np.full(pos.shape[0], 40, np.int8), rstart,
                       np.full(rstart.shape[0], run_len, np.int32),
                       rng.integers(0, nb, rstart.shape[0]).astype(np.int32), 0, 5)
    return dict(pad_split(split), rs_row=rng.integers(0, lay.n_fhat, n_rs).astype(np.int32),
                rs_strand=rng.integers(0, 2, n_rs).astype(np.int32),
                rs_w=np.ones(n_rs, np.float32))


def _mid_run_state(rng, je) -> dict:
    """A state (numpy) of the JAX engine ``je`` with coverage about 20 at
    the reference symbol over each contig's first 25 kb (some sites at or
    above the freeze at 30) and none beyond, so the dropout is active and
    zeroes the rest."""
    lay = je.layout
    cov = np.zeros((lay.n_barcodes, 5, lay.G_pad), np.uint16)
    for c in range(lay.n_contigs):
        g = lay.offsets[c] + np.arange(25_000)
        cov[:, lay.seq_int[g], g] = rng.poisson(20, (lay.n_barcodes, g.shape[0]))
    return dict({k: np.asarray(v) for k, v in je.init_state()._asdict().items()}, coverage=cov)


def _dense(eng):
    """``eng`` made to rescore every site at every step: its kept values
    never count as valid."""
    eng._kept_valid = lambda state: False
    return eng


@pytest.mark.parametrize("graphed", [False, True])
def test_kept_scores_equal_dense_engine_and_jax(graphed):
    rng = np.random.default_rng(2201 + graphed)
    nb = 2
    lay = build_layout({"a": rng.integers(0, 4, 40_000).astype(np.uint8),
                        "b": rng.integers(0, 4, 36_000).astype(np.uint8)}, n_barcodes=nb,
                       min_len=30_000)
    cfg = truns.RunsConfig(debug_aux=True)
    je = jruns.RunsEngine(lay, config=jruns.RunsConfig(debug_aux=True))
    te = truns.RunsEngine(lay, config=cfg, device="cpu")
    de = _dense(truns.RunsEngine(lay, config=cfg, device="cpu"))
    if graphed:
        _graphed(te)
    tp, dp, jp = (e.make_params(CCL, 5300.0) for e in (te, de, je))
    start = _mid_run_state(rng, je)
    jstate = lambda d: jruns.GenomeState(**{k: jnp.asarray(d[k])
                                            for k in jruns.GenomeState._fields})
    T = {"A": te.state_from_numpy(start)}
    D = {"A": de.state_from_numpy(start)}
    J = {"A": jstate(start)}
    # a copy_ restore of A's state after step 0, a new state B forked from
    # A through NumPy, then A and B in turns, and B twice
    plan = ["A"] * 4 + ["restore"] + ["A"] * 3 + ["fork"] + ["B", "A", "B", "A", "B", "B", "B"]
    want = []
    seen = dict(zeroed_untouched=0, zeroed_changed=0)
    last, snap = None, None
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for step, what in enumerate(plan):
            if what == "restore":
                for st, e in ((T["A"], te), (D["A"], de)):
                    for t, v in zip(st, e.state_from_numpy(snap)):
                        t.copy_(v)
                J["A"] = jstate(snap)
                last = None
                continue
            if what == "fork":
                d = state_to_numpy(T["A"])
                T["B"], D["B"], J["B"] = te.state_from_numpy(d), de.state_from_numpy(d), jstate(d)
                continue
            b = _window_batch(rng, lay, nb, n_runs=600, width=8_000)
            before = state_to_numpy(T[what])
            want.append("scores.tiled" if last == what else "scores.full")
            if graphed:
                T[what], ta = te.step_from_numpy(T[what], b, tp)
            else:
                T[what], ta = te.step(T[what], batch_from_numpy(b, "cpu"), tp)
            D[what], da = de.step(D[what], batch_from_numpy(b, "cpu"), dp)
            J[what], ja = je.step(J[what], jruns.ReadBatch(**{k: jnp.asarray(v)
                                                              for k, v in b.items()}), jp)
            last = what
            if snap is None:
                snap = state_to_numpy(T["A"])
            for k in truns.GenomeState._fields:
                assert torch.equal(getattr(T[what], k), getattr(D[what], k)), (k, step)
            for k in ("vec", "threshold", "scores"):
                assert torch.equal(getattr(ta, k), getattr(da, k)), (k, step)
            _assert_matches_jax(T[what], ta, J[what], ja, max(CCL) // DS, step)
            if want[-1] == "scores.tiled":
                changed = (state_to_numpy(T[what])["coverage"] != before["coverage"]).any(
                    axis=(0, 1))
                touched = tg.tile_flags(torch.from_numpy(changed)).numpy()
                untouched = ~np.repeat(touched != 0, tg.COVERAGE_TILE)[: lay.G_pad]
                seen["zeroed_untouched"] += int((before["zeroed"] & untouched).sum())
                seen["zeroed_changed"] += int((before["zeroed"] & changed).sum())
    counts = spans.window(t0, time.perf_counter()).counts
    assert len(want) == 14 and want.count("scores.full") == 7
    # the dense engine counts a full rescore at each of its 14 steps
    assert counts.get("scores.full", 0) == 7 + 14
    assert counts.get("scores.tiled", 0) == want.count("scores.tiled") == 7
    assert seen["zeroed_untouched"] > 0 and seen["zeroed_changed"] > 0, seen
    cov = T["B"].coverage.to(torch.int32).sum(dim=1)
    assert (cov >= cfg.freeze_cov).any() and T["B"].zeroed.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16])
def test_plain_scores_write_only_flagged_tiles(dtype):
    """site_scores with kept buffers and tile flags on the CPU: the flagged
    tiles' sites as the call without flags gives them, bit for bit, the
    rest of the buffers untouched; with ``full`` set, or without tiles,
    every site. Tiles need ``full`` and ``out``, and ``full`` needs tiles."""
    rng = np.random.default_rng(2202)
    nb, G = 2, 3 * tg.COVERAGE_TILE + 1237  # G % 4 != 0, a ragged last tile
    cov = rng.integers(0, 4, (nb, 5, G)) * (rng.random((nb, 5, G)) < 0.5)
    cov[:, :, rng.random(G) < 0.1] += 30  # frozen sites
    cov = torch.from_numpy(cov.astype(np.uint16))
    seq = torch.from_numpy(rng.integers(0, 4, G).astype(np.int8))
    valid = torch.from_numpy(rng.random(G) < 0.9)
    tables = ts.ScoreTables(make_model(ploidy=2), dtype, device="cpu")
    tiny = float(np.finfo(ts.NP_DTYPES[dtype]).tiny)
    args = (cov, seq, valid, tables, 30, tiny)
    want_s, want_c = ts.site_scores(*args)
    n_tiles = -(-G // tg.COVERAGE_TILE)
    tiles = torch.tensor([1, 0, 0, 1], dtype=torch.uint8)
    assert tiles.shape[0] == n_tiles
    kept = (torch.full((nb, G), 7.0, dtype=dtype), torch.full((nb, G), -1, dtype=torch.int32))
    out = ts.site_scores(*args, out=kept, tiles=tiles, full=torch.zeros(1, dtype=torch.int32))
    assert out[0] is kept[0] and out[1] is kept[1]
    sel = ts.tile_mask(tiles, torch.zeros(1, dtype=torch.int32), G)
    assert int(sel.sum()) == 2 * tg.COVERAGE_TILE - (n_tiles * tg.COVERAGE_TILE - G)
    assert torch.equal(kept[0][:, sel], want_s[:, sel])
    assert torch.equal(kept[1][:, sel], want_c[:, sel])
    assert (kept[0][:, ~sel] == 7.0).all() and (kept[1][:, ~sel] == -1).all()
    ts.site_scores(*args, out=kept, tiles=tiles, full=torch.ones(1, dtype=torch.int32))
    assert torch.equal(kept[0], want_s) and torch.equal(kept[1], want_c)
    kept[0].fill_(7.0)
    kept[1].fill_(-1)
    ts.site_scores(*args, out=kept)  # no tiles: every site
    assert torch.equal(kept[0], want_s) and torch.equal(kept[1], want_c)
    with pytest.raises(ValueError):
        ts.site_scores(*args, out=kept, tiles=tiles)
    with pytest.raises(ValueError):
        ts.site_scores(*args, out=kept, full=torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        ts.site_scores(*args, tiles=tiles, full=torch.ones(1, dtype=torch.int32))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32, torch.float64])
def test_scores_without_out_equal_fresh_out_with_full_set(dtype):
    """site_scores without ``out`` (the sharded step's call) equals a call
    into fresh buffers with ``full`` set and no tile flagged, bit for bit."""
    rng = np.random.default_rng(2301)
    nb, G = 2, 2 * tg.COVERAGE_TILE + 517
    cov = rng.integers(0, 4, (nb, 5, G)) * (rng.random((nb, 5, G)) < 0.5)
    cov[:, :, rng.random(G) < 0.1] += 30  # frozen sites
    args = dict(coverage=torch.from_numpy(cov.astype(np.uint16)),
                seq=torch.from_numpy(rng.integers(0, 4, G).astype(np.int8)),
                site_valid=torch.from_numpy(rng.random(G) < 0.9),
                tables=ts.ScoreTables(make_model(ploidy=2), dtype, device="cpu"),
                freeze_cov=30, tiny=float(np.finfo(ts.NP_DTYPES[dtype]).tiny))
    want_s, want_c = ts.site_scores(**args)
    fresh = (torch.full((nb, G), 7.0, dtype=dtype), torch.full((nb, G), -1, dtype=torch.int32))
    ts.site_scores(**args, out=fresh, tiles=torch.zeros(3, dtype=torch.uint8),
                   full=torch.ones(1, dtype=torch.int32))
    assert want_s.dtype == dtype and want_c.dtype == torch.int32
    assert torch.equal(fresh[0], want_s) and torch.equal(fresh[1], want_c)


def test_second_engine_on_the_same_state_rescores_every_site():
    """Two engines stepping one state in turns: a step after the other
    engine's rescores every site, a step after the engine's own rescores by
    tile (the counters say which), and every step equals an engine that
    rescores every site, bit for bit."""
    rng = np.random.default_rng(2207)
    lay = build_layout({"a": rng.integers(0, 4, 40_000).astype(np.uint8),
                        "b": rng.integers(0, 4, 36_000).astype(np.uint8)}, n_barcodes=1,
                       min_len=30_000)
    cfg = truns.RunsConfig(debug_aux=True)
    engines = {w: truns.RunsEngine(lay, config=cfg, device="cpu") for w in "AB"}
    de = _dense(truns.RunsEngine(lay, config=cfg, device="cpu"))
    params = {w: e.make_params(CCL, 5300.0) for w, e in engines.items()}
    dp = de.make_params(CCL, 5300.0)
    s, sd = engines["A"].init_state(), de.init_state()
    order = "AABAABBA"
    kinds = []
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for step, w in enumerate(order):
            b = _window_batch(rng, lay, 1, n_runs=600, width=8_000)
            s, a = engines[w].step(s, batch_from_numpy(b, "cpu"), params[w])
            kinds.append(engines[w]._full_host)
            sd, ad = de.step(sd, batch_from_numpy(b, "cpu"), dp)
            for k in truns.GenomeState._fields:
                assert torch.equal(getattr(s, k), getattr(sd, k)), (k, step)
            for k in ("vec", "threshold", "scores"):
                assert torch.equal(getattr(a, k), getattr(ad, k)), (k, step)
    counts = spans.window(t0, time.perf_counter()).counts
    assert kinds == [True, False, True, True, False, True, False, True]
    assert counts.get("scores.tiled", 0) == 3
    assert counts.get("scores.full", 0) == 5 + len(order)
