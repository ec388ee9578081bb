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
(d) diploid.
"""
import jax.numpy as jnp
import numpy as np
import torch

from bossruns_tpu import oracle
from bossruns_tpu.models import runs as jruns
from bossruns_tpu.models.layout import DS, build_layout
from bossruns_tpu.ops.model import make_model
from bossruns_torch.models import runs as truns
from bossruns_torch.models.convert import batch_from_numpy, state_from_numpy, state_to_numpy
from bossruns_torch.ops import genome_ops as tg
from test_engine_parity import _random_batch

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
