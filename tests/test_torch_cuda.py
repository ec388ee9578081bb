"""The CUDA kernels against their plain versions, on a card (marker ``cuda``).

The seeding kernel H5 is held exactly against its plain version, and the
aligner seeding on the card against the host-seeded aligner, record for
record. The AEONS kernels too: H6 (all-vs-all seeding) in all 48 entries
of every row at both device buckets, H7 (contig strategies) in threshold,
mask and benefit at 8 and 40 Mb, and a short AEONS simulation on the card
against the same simulation on the CPU.

Skipped where torch sees no GPU; on a machine with one run
``python -m pytest tests/test_torch_cuda.py -m cuda -q``. Two barcodes,
so the per-barcode index math is exercised (chip_smoke.py runs one). The
engine on the card is also held against the f64 NumPy oracle's decisions,
the contract tests/test_torch_engine.py holds on the CPU, and at the
8.05 Mb slice shape against the port's own oracle (bossruns_torch.oracle).
"""
import numpy as np
import pytest
import torch

from bossruns_tpu import oracle
from bossruns_tpu.models.layout import build_layout
from bossruns_torch.models import runs as truns
from bossruns_torch.models.convert import batch_from_numpy, state_to_numpy
from bossruns_torch.ops import genome_ops as tg
from bossruns_torch.ops import scores as ts
from test_engine_parity import _random_batch

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda

CCL = np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400])


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def setup(dev):
    rng = np.random.default_rng(3)
    lay = build_layout({"a": rng.integers(0, 4, 150_000).astype(np.uint8),
                        "b": rng.integers(0, 4, 120_000).astype(np.uint8)}, n_barcodes=2)
    eng = truns.RunsEngine(lay, config=truns.RunsConfig(debug_aux=True), device=dev)
    state = eng.init_state()
    params = eng.make_params(CCL, 5300.0)
    for _ in range(3):
        b = batch_from_numpy(_random_batch(rng, lay, n_obs=120_000, nb=2), dev)
        state, _ = eng.step(state, b, params)
    batch = batch_from_numpy(_random_batch(rng, lay, n_obs=120_000, nb=2), dev)
    return eng, state, batch, params


def _clone(d):
    return {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in d.items()}


def test_engine_on_card_matches_cpu(setup, dev):
    eng, _, _, _ = setup
    rng = np.random.default_rng(9)
    cpu = truns.RunsEngine(eng.layout, config=eng.config, device="cpu")
    sg, sc = eng.init_state(), cpu.init_state()
    params = eng.make_params(CCL, 5300.0)
    for step in range(6):
        b = _random_batch(rng, eng.layout, n_obs=120_000, nb=2)
        sg, ag = eng.step(sg, batch_from_numpy(b, dev), params)
        sc, ac = cpu.step(sc, batch_from_numpy(b, "cpu"), params)
        g, c = state_to_numpy(sg), state_to_numpy(sc)
        for k in ("coverage", "zeroed", "bucket_on", "read_starts"):
            np.testing.assert_array_equal(g[k], c[k], err_msg=f"{k} step {step}")
        np.testing.assert_allclose(ag.scores.cpu().numpy(), ac.scores.numpy(),
                                   rtol=1e-5, atol=5e-5)
        assert bool(ag.updated) == bool(ac.updated)


def test_coverage_kernel_exact(setup):
    eng, state, batch, _ = setup
    rows = tg.CovRows(batch.mr_bc, batch.mr_g, batch.mr_len, batch.ex_bcsym, batch.ex_g)
    a, b = _clone(eng.coverage_args(state, rows)), _clone(eng.coverage_args(state, rows))
    assert torch.equal(tg.coverage_update(**a), tg.coverage_update_plain(**b))
    assert torch.equal(a["coverage"].view(torch.int16), b["coverage"].view(torch.int16))


def test_score_kernel_within_f32_tolerance(setup):
    eng, state, _, _ = setup
    args = eng.score_args(state)
    sk, ck = ts.site_scores(**args)
    sp, cp = ts.site_scores_plain(**args)
    assert torch.equal(ck, cp)
    torch.testing.assert_close(sk, sp, rtol=1e-5, atol=5e-5)


def test_row_and_benefit_kernels(setup, dev):
    eng, state, batch, params = setup
    rows = tg.CovRows(batch.mr_bc, batch.mr_g, batch.mr_len, batch.ex_bcsym, batch.ex_g)
    changed = tg.coverage_update_plain(**_clone(eng.coverage_args(state, rows)))
    scores, covsum = ts.site_scores(**eng.score_args(state))
    aux = torch.zeros(4, dtype=torch.float32, device=dev)
    args = eng.row_args(state, scores, covsum, changed, aux, params,
                        batch.rs_row, batch.rs_strand, rs_w=batch.rs_w)
    a, b = _clone(args), _clone(args)
    for x, y in zip(tg.row_stage(**a), tg.row_stage_plain(**b)):
        assert torch.equal(x, y)
    for k in ("scores", "zeroed", "bucket_on", "read_starts", "aux"):
        assert torch.equal(a[k], b[k]), k
    ds, fe = tg.row_stage_plain(**_clone(args))
    bargs = eng.benefit_args(state, ds, fe, a["aux"], params)
    a, b = _clone(bargs), _clone(bargs)
    smu_k, ben_k, thr_k = tg.benefit_strategy(**a)
    smu_p, ben_p, _ = tg.benefit_strategy_plain(**b)
    atol = 256 * np.finfo(np.float64).eps * float(ds.sum(dim=1).max())
    torch.testing.assert_close(smu_k, smu_p, rtol=1e-12, atol=atol)
    torch.testing.assert_close(ben_k, ben_p, rtol=1e-12, atol=atol)
    ref = tg.find_strategy(ben_k, smu_k, fe[None].expand_as(ben_k), bargs["time_cost"])
    assert float(ref.threshold) == float(thr_k)


def test_row_kernel_gated_exact(setup, dev):
    """H3 with read-start weights from per-read bits (the gated flow)."""
    eng, state, batch, params = setup
    rng = np.random.default_rng(12)
    n_rs = batch.rs_row.shape[0]
    rs_read = torch.arange(n_rs, dtype=torch.int32, device=dev)
    bits = torch.from_numpy((rng.random(n_rs) < 0.5).astype(np.uint8)).to(dev)
    scores, covsum = ts.site_scores(**eng.score_args(state))
    changed = torch.ones(scores.shape[-1], dtype=torch.bool, device=dev)
    aux = torch.zeros(4, dtype=torch.float32, device=dev)
    args = eng.row_args(state, scores, covsum, changed, aux, params, batch.rs_row,
                        batch.rs_strand, rs_read=rs_read, bits=bits)
    a, b = _clone(args), _clone(args)
    for x, y in zip(tg.row_stage(**a), tg.row_stage_plain(**b)):
        assert torch.equal(x, y)
    for k in ("scores", "zeroed", "bucket_on", "read_starts", "aux"):
        assert torch.equal(a[k], b[k]), k
    added = float(a["read_starts"].sum()) - float(args["read_starts"].sum())
    assert added == float(bits.sum())


@pytest.fixture(scope="module")
def wide_world(dev):
    """A 6 Mb, two-barcode genome (about 3000 fhat windows, so the
    posterior pass of H3 takes many 256-entry blocks) after 3 steps on
    the card, with the next batch."""
    rng = np.random.default_rng(23)
    lay = build_layout({"a": rng.integers(0, 4, 3_600_000).astype(np.uint8),
                        "b": rng.integers(0, 4, 2_400_000).astype(np.uint8)}, n_barcodes=2,
                       align_chunks=8)
    assert 2 * lay.Wf_pad > 8 * 256
    eng = truns.RunsEngine(lay, device=dev)
    state = eng.init_state()
    params = eng.make_params(CCL, 5300.0)
    batches = [batch_from_numpy(_random_batch(rng, lay, n_obs=2_000_000, nb=2), dev)
               for _ in range(4)]
    for b in batches[:3]:
        state, _ = eng.step(state, b, params)
    return eng, state, batches, params


@pytest.mark.parametrize("gated", [False, True])
def test_row_kernel_exact_over_several_table_blocks(wide_world, dev, gated):
    """H3 at a Wf that takes several posterior blocks, ungated and gated:
    every output and in-place update equals the plain version."""
    eng, state, batches, params = wide_world
    batch = batches[3]
    rows = tg.CovRows(batch.mr_bc, batch.mr_g, batch.mr_len, batch.ex_bcsym, batch.ex_g)
    changed = tg.coverage_update_plain(**_clone(eng.coverage_args(state, rows)))
    scores, covsum = ts.site_scores(**eng.score_args(state))
    aux = torch.zeros(4, dtype=torch.float32, device=dev)
    n_rs = batch.rs_row.shape[0]
    if gated:
        bits = torch.from_numpy((np.random.default_rng(4).random(n_rs) < 0.5)
                                .astype(np.uint8)).to(dev)
        args = eng.row_args(state, scores, covsum, changed, aux, params, batch.rs_row,
                            batch.rs_strand, rs_read=torch.arange(n_rs, dtype=torch.int32,
                                                                  device=dev), bits=bits)
    else:
        args = eng.row_args(state, scores, covsum, changed, aux, params,
                            batch.rs_row, batch.rs_strand, rs_w=batch.rs_w)
    a, b = _clone(args), _clone(args)
    for x, y in zip(tg.row_stage(**a), tg.row_stage_plain(**b)):
        assert torch.equal(x, y)
    for k in ("scores", "zeroed", "bucket_on", "read_starts", "aux"):
        assert torch.equal(a[k], b[k]), k
    assert float(a["read_starts"].sum()) > float(args["read_starts"].sum())


def test_shard_rows_exact_over_several_table_blocks(wide_world, dev):
    """H8's row phases on every shard of a (2, 2) mesh over the 6 Mb genome,
    kernel against plain version (the probe of chip_smoke.py), and the
    sharded engine equal to the single engine bit for bit."""
    from chip_smoke import ShardProbe
    from bossruns_torch.parallel.mesh import ShardedRunsEngine, make_mesh

    eng, _, batches, params = wide_world
    single = truns.RunsEngine(eng.layout, device=dev)
    sharded = ShardedRunsEngine(eng.layout, make_mesh([dev] * 4, barcode_shards=2))
    probe = ShardProbe(range(4), timed=False)
    sharded.probe = probe
    s1, ss = single.init_state(), sharded.init_state()
    for b in batches:
        s1, a1 = single.step(s1, b, params)
        ss, a_s = sharded.step(ss, b, params)
        assert float(a_s.threshold) == float(a1.threshold)
        assert torch.equal(a_s.vec, a1.vec)
    torch.cuda.synchronize()
    assert sum(n == "shard_rows" for n, _, _ in probe.calls) == 4 * 4 * 4
    got, want = sharded.state_numpy(ss), single.state_numpy(s1)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_engine_on_card_matches_oracle_decisions(dev):
    """Given the card's own f32 scores, coverage, bucket_on, read_starts and
    strat equal the f64 oracle exactly, step by step."""
    rng = np.random.default_rng(21)
    lay = build_layout({"a": rng.integers(0, 4, 150_000).astype(np.uint8),
                        "b": rng.integers(0, 4, 120_000).astype(np.uint8)})
    eng = truns.RunsEngine(lay, config=truns.RunsConfig(debug_aux=True), device=dev)
    state = eng.init_state()
    st_np = state_to_numpy(state)
    st_np["read_starts"] = st_np["read_starts"].astype(np.float64)
    params = eng.make_params(CCL, 5300.0)
    updated = 0
    for step in range(10):
        b = _random_batch(rng, lay, n_obs=120_000)
        state, aux = eng.step(state, batch_from_numpy(b, dev), params)
        st_np, aux_o = oracle.full_update(eng, st_np, b, CCL, 5300.0,
                                          scores_override=aux.scores.cpu().numpy())
        got = state_to_numpy(state)
        assert bool(aux.updated) == aux_o["updated"], step
        for k in ("coverage", "bucket_on", "strat"):
            np.testing.assert_array_equal(got[k], st_np[k], err_msg=f"{k} step {step}")
        np.testing.assert_array_equal(got["read_starts"].astype(np.float64), st_np["read_starts"])
        if aux_o["updated"]:
            updated += 1
            np.testing.assert_allclose(float(aux.threshold), aux_o["threshold"], rtol=1e-12)
    assert updated >= 5


def test_engine_on_card_matches_port_oracle_at_slice_shape(dev):
    """At the 8.05 Mb slice shape of chip_smoke.py (3 contigs, a 4000-read
    batch applied 4 times), strat, bucket_on, read_starts and coverage of
    the engine on the card equal the port's own f64 oracle given the
    card's scores, bit for bit, after every step."""
    from bossruns_torch import oracle as port_oracle
    from chip_smoke import CCL as SLICE_CCL
    from chip_smoke import TIME_COST, build_inputs

    lay, batch_np, _, _ = build_inputs(np.random.default_rng(11))
    eng = truns.RunsEngine(lay, config=truns.RunsConfig(debug_aux=True), device=dev)
    state = eng.init_state()
    batch = batch_from_numpy(batch_np, dev)
    params = eng.make_params(SLICE_CCL, TIME_COST)
    st_np = state_to_numpy(state)
    st_np["read_starts"] = st_np["read_starts"].astype(np.float64)
    updated = 0
    for step in range(4):
        state, aux = eng.step(state, batch, params)
        st_np, aux_o = port_oracle.full_update(eng, st_np, batch_np, SLICE_CCL, TIME_COST,
                                               scores_override=aux.scores.cpu().numpy())
        got = state_to_numpy(state)
        assert bool(aux.updated) == aux_o["updated"], step
        for k in ("coverage", "bucket_on", "strat"):
            np.testing.assert_array_equal(got[k], st_np[k], err_msg=f"{k} step {step}")
        np.testing.assert_array_equal(got["read_starts"].astype(np.float64), st_np["read_starts"])
        updated += aux_o["updated"]
    assert updated >= 2


@pytest.fixture(scope="module")
def seed_world():
    """A 600 kb genome with a planted repeat, reads simulated from it."""
    from bossruns_tpu.utils.datagen import simulate_reads

    rng = np.random.default_rng(31)
    base = rng.integers(0, 4, 600_000).astype(np.uint8)
    base[400_000:406_000] = base[100_000:106_000]
    genome = {"g": "".join(np.array(list("ACGT"))[base])}
    reads = simulate_reads(rng, genome, 600, mean_len=4000.0, sd_len=3000.0)
    return base, {r.rid: r.seq for r in reads}


@pytest.mark.parametrize("k,w", [(13, 5), (15, 10)])
def test_seed_kernel_exact(seed_world, dev, k, w):
    """H5 equals the plain version in all 24 rows: corpus prefixes at L=512,
    the reads' 4096 bucket, and random junk reads (placeholders)."""
    from bossruns_torch.aligner import encode
    from bossruns_torch.aligner import seed as S
    from bossruns_torch.aligner.index import build_index

    base, seqs = seed_world
    idx = build_index(base, np.ones(base.shape[0], bool), k=k, w=w)
    di = S.DeviceIndex(idx, dev)
    enc = [encode(s) for s in seqs.values()]
    rng = np.random.default_rng(5)
    cases = {
        512: [e[:400] for e in enc],
        4096: [e[:4096] for e in enc if 2048 < e.shape[0] <= 4096],
        32768: [e for e in enc if e.shape[0] > 8192][:8],
    }
    cases[512] += [rng.integers(0, 5, 500).astype(np.int8) for _ in range(32)]
    for L, reads in cases.items():
        assert reads, L
        mat = np.full((len(reads), L), 4, np.int8)
        for r, e in enumerate(reads):
            mat[r, : e.shape[0]] = e[:L]
        (x,) = S.upload_reads([mat], di)
        b = S.anchor_budget(L, w)
        got = S.seed_topn(x, di, k, w, b, L)
        want = S.seed_topn_plain(x, di, k, w, b, L)
        torch.cuda.synchronize()
        assert torch.equal(got, want), L
        assert float((got[2] >= 3).float().mean()) > 0.5


@pytest.mark.parametrize("L", [512, 4096])
def test_seed_kernel_ragged_batch_and_unmapped_reads(seed_world, dev, L):
    """H5 equals its plain version in all 24 rows on an odd number of reads
    (1001) mixing mapped reads with reads that have no index hit at all
    (all N, poly-A, a read shorter than k) and random junk."""
    from bossruns_torch.aligner import encode
    from bossruns_torch.aligner import seed as S
    from bossruns_torch.aligner.index import build_index

    base, seqs = seed_world
    idx = build_index(base, np.ones(base.shape[0], bool), k=13, w=5)
    di = S.DeviceIndex(idx, dev)
    rng = np.random.default_rng(L)
    enc = [encode(s)[:L] for s in seqs.values()]
    mat = np.full((1001, L), 4, np.int8)
    for r in range(1001):
        kind = r % 5
        if kind in (0, 1):
            e = enc[r % len(enc)]
            mat[r, : e.shape[0]] = e
        elif kind == 2:
            mat[r, : L - 8] = 0                         # poly-A: one k-mer, never indexed
        elif kind == 3:
            mat[r, :10] = rng.integers(0, 4, 10)        # shorter than k; the rest N
        else:
            mat[r] = rng.integers(0, 5, L)
    (x,) = S.upload_reads([mat], di)
    b = S.anchor_budget(L, 5)
    got = S.seed_topn(x, di, 13, 5, b, L)
    want = S.seed_topn_plain(x, di, 13, 5, b, L)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool((got[2, 3::5] == -1).all())            # no anchor: placeholders only
    assert float((got[2, 0::5] >= 3).float().mean()) > 0.5


def test_aligner_on_card_matches_host_seeded(seed_world, dev):
    from bossruns_torch.aligner import make_aligner
    from bossruns_torch.models.layout import build_layout

    base, seqs = seed_world
    lay = build_layout({"g": base})
    card = make_aligner(lay, device=dev, k=13, w=5, min_votes=3)
    host = make_aligner(lay, device="cpu", backend="host", k=13, w=5, min_votes=3)
    for kw in (dict(trunc=True), dict(), dict(all_records=True)):
        a, b = card.map_sequences(seqs, **kw), host.map_sequences(seqs, **kw)
        assert len(a) == len(b) > 0 and list(a.qname) == list(b.qname)
        for f in ("qstart", "qend", "rev", "tstart", "tend", "nmatch", "blocklen", "mapq",
                  "align_score", "s1", "primary"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        for x, y in zip(a.cigars, b.cigars):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("L", [8192, 32768])
def test_seed_candidates_kernel_exact(seed_world, dev, L):
    """H6 equals its plain version in all 48 entries of every row, at the
    bucket's default tolerance, against a pool index of 5 kb reads."""
    from bossruns_torch.aeons.ava import PoolIndex
    from bossruns_torch.aligner import encode
    from bossruns_torch.aligner import seed as S
    from bossruns_torch.utils.datagen import simulate_reads

    base, seqs = seed_world
    genome = {"g": "".join(np.array(list("ACGT"))[base])}
    rng = np.random.default_rng(L)
    pool = {r.rid: r.seq for r in simulate_reads(rng, genome, 500, mean_len=5000.0)}
    pidx = PoolIndex(pool, device=dev)
    ml = 5000.0 if L == 8192 else 16000.0
    q = [encode(r.seq)[:L] for r in simulate_reads(rng, genome, 64, mean_len=ml)]
    mat = np.full((len(q) + 4, L), 4, np.int8)
    for r, e in enumerate(q):
        mat[r, : e.shape[0]] = e
    mat[len(q):] = rng.integers(0, 5, (4, L))
    (x,) = S.upload_reads([mat], pidx.dev)
    got = S.seed_candidates(x, pidx.dev)
    want = S.seed_candidates_plain(x, pidx.dev, tol=S.candidate_tol(L))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert float((got[:-4, 0] >= 4).any(dim=1).float().mean()) > 0.8


def test_seed_upload_from_staging_only(seed_world, dev):
    """On the card the packed reads go through the index's pinned staging:
    the staged payload decodes to the reads, and an array that was not
    packed into staging raises (no pageable copy)."""
    from bossruns_torch.aligner import seed as S
    from bossruns_torch.aligner.index import build_index

    base, _ = seed_world
    di = S.DeviceIndex(build_index(base, np.ones(base.shape[0], bool), k=13, w=5), dev)
    mat = np.random.default_rng(3).integers(0, 5, (33, 1024)).astype(np.int8)
    (x,) = S.upload_reads([mat], di)
    assert x.device.type == "cuda" and x.dtype == torch.int32 and x.shape == (33, 128)
    np.testing.assert_array_equal(S.unpack_reads(x, 1024).cpu().numpy(), mat)
    with pytest.raises(ValueError, match="staging"):
        S.put_packed(S.pack_reads(mat), di)


def test_pack_rows_host_loop_equals_numpy(dev):
    """The kernel library's host pack (bk_pack_rows) writes the bytes of
    NumPy's pack, rows cut or padded to L (empty, odd, exact, over-long),
    and refuses a code outside 0..4."""
    from bossruns_torch.aligner import seed as S

    rng = np.random.default_rng(12)
    for L in (512, 4096, 32768):
        lens = rng.integers(0, L + 20, 57)
        lens[:5] = (0, L, L + 100, 7, 9)
        start = np.concatenate([[0], np.cumsum(lens)[:-1]])
        codes = rng.integers(0, 5, int(lens.sum())).astype(np.int8)
        got = S.pack_rows(codes, start, lens, L, np.empty((57, L // 8), np.uint32), compiled=True)
        want = S.pack_rows(codes, start, lens, L, np.empty((57, L // 8), np.uint32))
        assert got.tobytes() == want.tobytes(), L
    codes[3] = 5
    with pytest.raises(RuntimeError, match="outside 0..4"):
        S.pack_rows(codes, start, lens, L, np.empty((57, L // 8), np.uint32), compiled=True)


def test_encode_rows_host_loop_equals_numpy(seed_world, dev):
    """The aligner's one pass over a batch's text on the card's path (the
    host loop encodes and packs into pinned staging) gives NumPy's codes
    (every byte value, upper and lower case, N and junk) and payload."""
    from bossruns_torch import aligner as tal
    from bossruns_torch.aligner import seed as S
    from bossruns_torch.aligner.index import build_index

    base, _ = seed_world
    idx = build_index(base, np.ones(base.shape[0], bool), k=13, w=5)
    card, cpu = S.DeviceIndex(idx, dev), S.DeviceIndex(idx, "cpu")
    rng = np.random.default_rng(4)
    lens = rng.integers(0, 9000, 300)
    lens[:4] = (0, 1, 40_000, 256)
    alphabet = np.frombuffer(b"ACGTacgtNnRY-x", np.uint8)
    raw = alphabet[rng.integers(0, alphabet.shape[0], int(lens.sum()))]
    raw[1: 1 + 1024] = np.tile(np.arange(256, dtype=np.uint8), 4)   # inside the 40 kb read
    text = raw.tobytes()
    offs = np.concatenate([[0], np.cumsum(lens)])
    calls = [(offs[g], lens[g], tal.bucket_of(int(lens[g].max())))
             for g in tal.length_groups(lens)]
    (c1, (_, p1)), (c0, (_, p0)) = S.encode_rows(text, calls, card), S.encode_rows(text, calls, cpu)
    np.testing.assert_array_equal(c1, c0)
    np.testing.assert_array_equal(c0, tal._ENC[raw])
    assert len(p1) == len(p0) == len(calls)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(p1, p0))


def _link_reads(seed_world, n=300):
    """Reads of mean 2,500 (sd 1,200): four or more length buckets."""
    from bossruns_torch.utils.datagen import simulate_reads

    base, _ = seed_world
    genome = {"g": "".join(np.array(list("ACGT"))[base])}
    reads = simulate_reads(np.random.default_rng(8), genome, n, mean_len=2500.0, sd_len=1200.0)
    return {r.rid: r.seq for r in reads}


def test_dispatch_queues_every_bucket_behind_a_sleep(seed_world, dev):
    """map_sequences queues every bucket's upload and H5 launch before its
    first pull: with ~50 ms of sleep queued on the stream, the dispatch
    loop's host time stays under a tenth of the sleep."""
    import time

    from bossruns_torch.aligner import bucket_of, make_aligner
    from bossruns_torch.models.layout import build_layout

    base, _ = seed_world
    seqs = _link_reads(seed_world)
    assert len({bucket_of(len(s)) for s in seqs.values()}) >= 4
    al = make_aligner(build_layout({"g": base}), device=dev, k=13, w=5, min_votes=3)
    al.map_sequences(seqs)  # warm-up
    real, spent = al._seed_bucket_dispatch, []
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed(*a):
        e0.record()
        torch.cuda._sleep(100_000_000)  # ~50 ms at 2 GHz, just before the loop
        e1.record()
        t0 = time.perf_counter()
        out = real(*a)
        spent.append(1000 * (time.perf_counter() - t0))
        return out

    al._seed_bucket_dispatch = timed
    torch.cuda.synchronize()
    al.map_sequences(seqs)
    torch.cuda.synchronize()
    assert sum(spent) < 0.1 * e0.elapsed_time(e1), (spent, e0.elapsed_time(e1))


def test_map_sequences_on_card_equals_cpu_over_buckets(seed_world, dev):
    """Records seeded on the card (packed, staged link) equal the CPU's
    plain seeding's on a batch over four or more length buckets."""
    from bossruns_torch.aligner import make_aligner
    from bossruns_torch.models.layout import build_layout

    base, _ = seed_world
    seqs = _link_reads(seed_world, 200)
    lay = build_layout({"g": base})
    card = make_aligner(lay, device=dev, k=13, w=5, min_votes=3)
    cpu = make_aligner(lay, device="cpu", k=13, w=5, min_votes=3)
    for kw in (dict(trunc=True), dict(), dict(all_records=True)):
        a, b = card.map_sequences(seqs, **kw), cpu.map_sequences(seqs, **kw)
        assert len(a) == len(b) > 0 and list(a.qname) == list(b.qname)
        for f in ("qstart", "qend", "rev", "tstart", "tend", "nmatch", "blocklen", "mapq",
                  "align_score", "s1", "primary"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        for x, y in zip(a.cigars, b.cigars):
            np.testing.assert_array_equal(x, y)


def test_strategy_pull_on_card(dev):
    """strat_dict takes the pinned copy strat_to_host_async started behind
    a step, equal to a plain pull, and a step drops a pending copy."""
    rng = np.random.default_rng(6)
    lay = build_layout({"a": rng.integers(0, 4, 150_000).astype(np.uint8)})
    eng = truns.RunsEngine(lay, device=dev)
    state, params = eng.init_state(), eng.make_params(CCL, 5300.0)
    for _ in range(2):
        eng.strat_to_host_async(state)
        state, _ = eng.step(state, batch_from_numpy(_random_batch(rng, lay, n_obs=60_000), dev),
                            params)
    assert eng._strat_pull.take(state.strat) is None
    want = {k: v.copy() for k, v in eng.strat_dict(state).items()}   # pulled
    eng.strat_to_host_async(state)
    got = eng.strat_dict(state)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(eng._strat_pull._buf.numpy(), state.strat.cpu().numpy())


@pytest.mark.parametrize("n_contigs", [40, 200])
def test_aeons_strategy_kernel_exact(dev, n_contigs):
    """H7 equals its plain version (threshold, mask and benefit, bit for bit)
    on bench.py's strat_triple pools of 200 kb contigs."""
    from bossruns_torch.aeons import benefit as B

    rng = np.random.default_rng(n_contigs)
    for hi in (22, 30):
        n = n_contigs * 2000
        nd = np.full(n_contigs, 2000, np.int64)
        cov = rng.integers(0, hi, n).astype(np.uint8)
        flags = rng.integers(0, 16, n_contigs).astype(np.uint8)
        up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        args = (up(cov), up(np.cumsum(nd)), up(flags), up(B.score_table(10.0)),
                (4, 200, 140, 100, 70, 50, 35, 25, 17, 9, 3), B.AEONS_WEIGHTS, 55.0, 10)
        mk, tk, bk = B.strategy(*args)
        mp, tp, bp = B.strategy_plain(*args)
        torch.cuda.synchronize()
        assert tk == tp and tk > 0
        assert torch.equal(bk, bp) and torch.equal(mk, mp)


def _aeons_pool(rng, kind: str):
    """Chunk coverage, chunk counts and flag bits of a contig pool: "long",
    one 50,000-chunk (5 Mb) contig beside 2,000 one-chunk contigs; "tiny",
    2,000 contigs of one or two chunks. Flags at random (NOI and uncapped
    ends), coverage 0-21."""
    nd = (np.array([50_000] + [1] * 2000) if kind == "long"
          else rng.integers(1, 3, 2000)).astype(np.int64)
    cov = rng.integers(0, 22, int(nd.sum())).astype(np.uint8)
    return cov, nd, rng.integers(0, 16, nd.size).astype(np.uint8)


@pytest.mark.parametrize("kind", ["long", "tiny"])
def test_aeons_strategy_kernel_long_and_tiny_contigs(dev, kind):
    """H7 on the longest per-contig chain beside many one-chunk contigs, and
    on many tiny contigs: mask, benefit and threshold bit-equal to its plain
    version, mask and threshold to the f64 host path."""
    from bossruns_torch.aeons import benefit as B

    cov, nd, flags = _aeons_pool(np.random.default_rng(77 if kind == "long" else 78), kind)
    wins = (4, 200, 140, 100, 70, 50, 35, 25, 17, 9, 3)
    up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    args = (up(cov), up(np.cumsum(nd)), up(flags), up(B.score_table(10.0)), wins,
            B.AEONS_WEIGHTS, 55.0, 10)
    mk, tk, bk = B.strategy(*args)
    mp, tp, bp = B.strategy_plain(*args)
    torch.cuda.synchronize()
    assert tk == tp and tk > 0
    assert torch.equal(bk, bp) and torch.equal(mk, mp)
    bit = lambda k: (flags >> k) & 1 > 0  # noqa: E731
    mh, th = B._strategy_host(cov, nd, bit(0), bit(1), bit(2), bit(3), 10.0,
                              np.array(wins[1:]), wins[0], 55.0, 10)
    assert tk == th
    np.testing.assert_array_equal(mk.cpu().numpy(), mh)
    assert 0.0 < float(mh.mean()) < 1.0


def _benefit_kw(dev, rng, nb: int, Gd: int, halo: int) -> dict:
    """Arguments of H4 on a synthetic ds-row genome: f64 scores over a wide
    range, two segments, buckets of 100 rows (some rows in none), dyadic
    f32 fhat weights, a random strategy, the bucket gate open."""
    r = np.arange(Gd)
    s1 = Gd // 3
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    bidx = (r // 100).astype(np.int32)
    bidx[rng.random(Gd) < 0.02] = -1
    return dict(
        scores_ds=up(rng.random((nb, Gd)) * np.exp(rng.normal(0, 2, (nb, Gd)))),
        seg_start=up(np.where(r < s1, 0, s1).astype(np.int32)),
        seg_end=up(np.where(r < s1, s1, Gd).astype(np.int32)),
        fhat_exp=up(rng.integers(1, 2**12, (Gd, 2)) * 2.0**-20),
        bucket_on=up(rng.random((nb, Gd // 100 + 1)) < 0.9), bucket_idx=up(bidx),
        strat_valid=up(rng.random(Gd) < 0.95), strat=up(rng.random((nb, Gd, 2)) < 0.5),
        aux=torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float32, device=dev), mu_ds=4,
        approx_ccl=up(np.array([100 * halo, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200,
                                400], np.int32)),
        time_cost=torch.tensor(5300.0, dtype=torch.float32, device=dev), win_clamp=halo,
        win_cap=halo,
    )


def _shard_kw(kw: dict, lo: int, hi: int, halo: int) -> dict:
    """Genome rows [lo, hi) of H4's arguments as one shard's."""
    rows = ("seg_start", "seg_end", "fhat_exp", "bucket_idx", "strat_valid")
    out = dict(kw, row0=lo, halo=halo, aux=kw["aux"].clone(),
               scores_ds=kw["scores_ds"][:, lo:hi].contiguous(),
               strat=kw["strat"][:, lo:hi].contiguous())
    out.update({k: kw[k][lo:hi].contiguous() for k in rows})
    return out


def _sharded_benefit(kw: dict, bounds: list, halo: int) -> list:
    """H8's benefit phases over genome shards [bounds[g], bounds[g + 1]),
    with the sharded engine's collectives between them (in-process, in
    shard order): the workspaces and shard arguments after the threshold."""
    skw = [_shard_kw(kw, lo, hi, halo) for lo, hi in zip(bounds, bounds[1:])]
    ws = [tg.benefit_workspace(k["scores_ds"]) for k in skw]
    for w, k in zip(ws, skw):
        tg.shard_benefit("scan", w, **k)
    tiles = torch.cat([w["tile_sums"] for w in ws], dim=1)
    for g, (w, k) in enumerate(zip(ws, skw)):
        w["tiles_g"], w["tile0"] = tiles.clone(), sum(x["tile_sums"].shape[1] for x in ws[:g])
        tg.shard_benefit("prefix", w, **k)
    for g, (w, k) in enumerate(zip(ws, skw)):  # the cumsum at rows [row0 - halo, row0 + Gdl + halo]
        left = ws[g - 1]["cs"][:, -halo - 1: -1] if g else torch.zeros_like(w["cs"][:, :halo])
        right = (ws[g + 1]["cs"][:, 1: halo + 1] if g + 1 < len(ws)
                 else torch.zeros_like(w["cs"][:, :halo]))
        w["ext"] = torch.cat([left, w["cs"], right], dim=1)
        tg.shard_benefit("windows", w, **k)
    for key, op in (("norm", torch.max), ("any_nz", torch.max)):
        v = op(torch.stack([w[key] for w in ws]))
        for w in ws:
            w[key].fill_(v)
    for w, k in zip(ws, skw):
        tg.shard_benefit("bins", w, **k)
    for key in ("counts", "fsum", "ubar0"):
        v = sum(w[key] for w in ws)
        for w in ws:
            w[key].copy_(v)
    for w, k in zip(ws, skw):
        tg.shard_benefit("threshold", w, **k)
    return list(zip(ws, skw))


@pytest.mark.parametrize("halo", [300, 4096])
def test_benefit_kernels_ragged_two_barcodes(dev, halo):
    """H4 and H8's benefit phases on Gd = 3 * 4096 + 1001 rows (a multiple
    of neither the 4096-row tile nor 4) with two barcodes: the single path
    against its plain version (windows within the f64 bar, the decisions
    exact given the kernel's own benefit and smu), and two shards split at
    a tile boundary equal to the single path bit for bit (smu, benefit,
    threshold, strat, aux): both take the tile prefixes in the same order.
    A widest window of 4096 rows (the engine's clamp) stages more than 48
    KB of cumsum per block in the window launch."""
    Gd = 3 * 4096 + 1001
    kw = _benefit_kw(dev, np.random.default_rng(81), 2, Gd, halo)
    a, b = _clone(kw), _clone(kw)
    smu_k, ben_k, thr_k = tg.benefit_strategy(**a)
    smu_p, ben_p, _ = tg.benefit_strategy_plain(**b)
    atol = 256 * np.finfo(np.float64).eps * float(kw["scores_ds"].sum(dim=1).max())
    torch.testing.assert_close(smu_k, smu_p, rtol=1e-12, atol=atol)
    torch.testing.assert_close(ben_k, ben_p, rtol=1e-12, atol=atol)
    ref = tg.find_strategy(ben_k, smu_k, kw["fhat_exp"][None].expand_as(ben_k), kw["time_cost"])
    assert float(ref.threshold) == float(thr_k)
    bidx = kw["bucket_idx"].long()
    gate = (kw["bucket_on"][:, bidx.clamp_min(0)] & (bidx >= 0)[None]
            & kw["strat_valid"][None])
    assert bool(a["aux"][1] > 0)
    assert torch.equal(a["strat"], torch.where(gate[..., None], ref.strat, kw["strat"]))
    assert torch.equal(a["aux"], b["aux"])
    parts = _sharded_benefit(kw, [0, 2 * 4096, Gd], halo)
    assert torch.equal(torch.cat([w["smu"] for w, _ in parts], dim=1), smu_k)
    assert torch.equal(torch.cat([w["benefit"] for w, _ in parts], dim=1), ben_k)
    assert torch.equal(torch.cat([k["strat"] for _, k in parts], dim=1), a["strat"])
    for w, k in parts:
        assert float(w["threshold"]) == float(thr_k)
        assert torch.equal(k["aux"], a["aux"])


@pytest.mark.parametrize("case", ["one_bin", "all_bins", "ragged"])
def test_benefit_bins_and_threshold_edge_cases(dev, case):
    """H8's bins phase (H4's binning launch) on the adversarial inputs of
    test_torch_genome_ops.py, with two barcodes for "ragged": counts and
    fsum bit-equal to the plain bin_benefit; then the threshold phase
    (threshold, strat, aux) equal to its plain version."""
    from test_torch_genome_ops import bin_edge_case

    b, smu, f = bin_edge_case(case)
    nb, Gd = b.shape[:2]
    kw = _shard_kw(_benefit_kw(dev, np.random.default_rng(82), nb, Gd, 300), 0, Gd, 300)
    kw["fhat_exp"] = torch.from_numpy(np.ascontiguousarray(f[0])).to(dev)
    ben = torch.from_numpy(b).to(dev)
    f_b = kw["fhat_exp"][None].expand_as(ben)
    outs = []
    for shard in (tg.shard_benefit, tg.shard_benefit_plain):
        ws = tg.benefit_workspace(kw["scores_ds"])
        k = _clone(kw)
        ws["benefit"].copy_(ben)
        ws["norm"].copy_(ben.max().reshape(1))
        ws["any_nz"].fill_(1)
        ws["counts"].zero_()
        ws["fsum"].zero_()
        ws["ubar0"].copy_(tg.ubar0_partial(f_b, torch.from_numpy(smu).to(dev),
                                           torch.float64).reshape(1))
        shard("bins", ws, **k)
        shard("threshold", ws, **k)
        outs.append((ws, k))
    (wk, kk), (wp, kp) = outs
    counts, fsum = tg.bin_benefit(ben, f_b, ben.max(), tg.NBINS)
    assert torch.equal(wk["counts"].to(torch.float64), counts)
    assert torch.equal(wk["fsum"], fsum)
    assert torch.equal(wp["counts"].to(torch.float64), counts)
    assert float(wk["threshold"]) == float(wp["threshold"])
    assert torch.equal(kk["strat"], kp["strat"]) and torch.equal(kk["aux"], kp["aux"])


def test_aeons_sim_on_card_matches_cpu(dev, tmp_path, monkeypatch):
    """2 batches of test_aeons.py's end-to-end AEONS sim on the card and on
    the CPU: the same contigs, masks and pseudotimes."""
    from bossruns_tpu.config import BossConfig
    from bossruns_torch.aeons.simulation import BossAeonsSim
    from bossruns_torch.ops import kernels
    from bossruns_torch.utils.datagen import write_corpus

    monkeypatch.chdir(tmp_path)
    paths = write_corpus(tmp_path / "data", rng=np.random.default_rng(21),
                         contig_lengths={"gA": 100_000}, n_reads=1300, mean_len=5000.0)

    def args(name):
        a = BossConfig()
        a.general.name = name
        a.simulation.fq = paths["fq"]
        a.simulation.batchsize = 140
        a.simulation.maxb = 2
        a.simulation.binit = 4
        a.optional.min_seq_len = 2500
        a.optional.min_contig_len = 10_000
        return a

    kernels.reset_launches()
    card = BossAeonsSim(args("card"), out_base=tmp_path / "card", device=dev)
    cpu = BossAeonsSim(args("cpu"), out_base=tmp_path / "cpu", device="cpu")
    for _ in range(2):
        card.process_batch()
        cpu.process_batch()
        assert {s.seq for s in card.pool.sequences.values()} == {
            s.seq for s in cpu.pool.sequences.values()}
        assert card.strat.keys() == cpu.strat.keys()
        for h in card.strat:
            np.testing.assert_array_equal(card.strat[h], cpu.strat[h])
        assert (card.read_cache.time_boss, card.read_cache.time_control) == (
            cpu.read_cache.time_boss, cpu.read_cache.time_control)
    n = kernels.launches()
    assert n["seed_candidates"] > 0 and n["aeons_strategy"] > 0 and n["seed_topn"] > 0


def _mesh_world(nb: int, seed: int):
    """A 16-chunk genome (1.6 Mb: shards of 4 or 8 chunks fall on H4's
    4096-row scan tiles) and batches concentrated on a window across the
    edge of genome shards 0 and 1 of a 4-way split."""
    rng = np.random.default_rng(seed)
    lay = build_layout({"a": rng.integers(0, 4, 1_000_000).astype(np.uint8),
                        "b": rng.integers(0, 4, 600_000).astype(np.uint8)}, n_barcodes=nb,
                       align_chunks=4)
    edge = lay.G_pad // 4
    batches = []
    for _ in range(3):
        b = _random_batch(rng, lay, n_obs=1_200_000, nb=nb, run_len=400)
        g = b["mr_g"].astype(np.int64)
        # move every run into [edge - 100 kb, edge + 100 kb)
        moved = (edge - 100_000 + (g % 199_000)).astype(np.uint32)
        b["mr_g"] = np.where(b["mr_len"] > 0, moved, b["mr_g"])
        batches.append(b)
    return lay, batches


def test_shard_kernels_exact_on_card(dev):
    """H8: every phase of every shard of a (2, 4) mesh with two barcodes,
    kernel against plain version on the same inputs (chip_smoke's probe)."""
    from chip_smoke import ShardProbe
    from bossruns_torch.parallel.mesh import ShardedRunsEngine, make_mesh

    lay, batches = _mesh_world(2, 41)
    eng = ShardedRunsEngine(lay, make_mesh([dev] * 8, barcode_shards=2))
    probe = ShardProbe(range(8), timed=False)
    eng.probe = probe
    state = eng.init_state()
    params = eng.make_params(CCL, 5300.0)
    for b in batches:
        state, aux = eng.step(state, batch_from_numpy(b, dev), params)
    torch.cuda.synchronize()
    assert len(probe.calls) == 3 * 8 * (1 + 4 + 5)
    assert bool(aux.any_on)


@pytest.mark.parametrize("Sb,Sg", [(1, 4), (2, 2)])
def test_sharded_engine_on_card_matches_single(dev, Sb, Sg):
    """Tile-aligned shards: the sharded engine on the card equals the
    single engine on the card bit for bit, threshold included."""
    from bossruns_torch.parallel.mesh import ShardedRunsEngine, make_mesh

    lay, batches = _mesh_world(2, 42)
    single = truns.RunsEngine(lay, device=dev)
    sharded = ShardedRunsEngine(lay, make_mesh([dev] * (Sb * Sg), barcode_shards=Sb))
    s1, ss = single.init_state(), sharded.init_state()
    params = single.make_params(CCL, 5300.0)
    for i, b in enumerate(batches):
        s1, a1 = single.step(s1, batch_from_numpy(b, dev), params)
        ss, a_s = sharded.step(ss, batch_from_numpy(b, dev), params)
        assert float(a_s.threshold) == float(a1.threshold), i
        assert torch.equal(a_s.vec, a1.vec), i
    got, want = sharded.state_numpy(ss), single.state_numpy(s1)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert bool(a1.updated)


# ------------------------------------- coverage workspace (H1, H8) and H2 --

COV_G = 5 * 4096 + 1000  # a multiple of 4 with a partial last tile


def _rows(dev, rng, G, nb, n_runs, run_max, n_ex, n_reads=None):
    """A family of coverage rows on the card: runs of 1..run_max bases and
    explicit observations at random places (read ids when n_reads)."""
    mr_g = rng.integers(0, G, n_runs).astype(np.uint32)
    mr_len = rng.integers(1, run_max + 1, n_runs).astype(np.uint16)
    mr_bc = rng.integers(0, nb, n_runs).astype(np.uint8)
    ex_g = rng.integers(0, G, n_ex).astype(np.uint32)
    ex_bcsym = (rng.integers(0, nb, n_ex) * 5 + rng.integers(0, 5, n_ex)).astype(np.uint16)
    reads = None
    if n_reads:
        reads = (rng.integers(0, n_reads, n_runs).astype(np.uint32),
                 rng.integers(0, n_reads, n_ex).astype(np.uint32))
    return mr_bc, mr_g, mr_len, ex_bcsym, ex_g, reads


def _family(dev, parts):
    mr_bc, mr_g, mr_len, ex_bcsym, ex_g, reads = parts
    up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    extra = (up(reads[0]), up(reads[1])) if reads is not None else ()
    return tg.CovRows(up(mr_bc), up(mr_g), up(mr_len), up(ex_bcsym), up(ex_g), *extra)


def _edge_rows(rng, G, nb):
    """Runs across every tile boundary, into the last partial tile, past the
    end of barcode 0's row (they run on into barcode 1, as the reference's
    flat cumsum does) and past the end of the genome (clipped), plus dropped
    rows: mr_len 0, EX_PAD, positions and barcodes out of range."""
    t = np.arange(1, -(-G // 4096)) * 4096
    mr_g = np.concatenate([t - 50, [G - 30, G - 10, G - 5, 2**32 - 100, 7]]).astype(np.uint32)
    mr_len = np.concatenate([np.full(t.shape, 100), [30, 60, 40, 500, 0]]).astype(np.uint16)
    mr_bc = np.zeros(mr_g.shape, np.uint8)
    mr_bc[-3] = nb - 1                      # past the end of the last row: clipped
    ex_g = np.array([0, 4095, 4096, G - 1, 0xFFFFFFFF, G + 5, 12], np.uint32)
    ex_bcsym = np.array([0, 1, 2, 5 * (nb - 1) + 4, 3, 0, 5 * nb], np.uint16)
    return mr_bc, mr_g, mr_len, ex_bcsym, ex_g, None


@pytest.mark.parametrize("kind", ["sparse", "dense", "gated", "edges", "window"])
def test_coverage_exact_over_five_steps(dev, kind):
    """H1 (and H8's window) over five consecutive steps on one coverage:
    after every step coverage and changed equal the plain version's. Before
    each call a freed block of garbage is left for the allocator to hand
    out as the call's match scratch, which the kernels zero only at the
    tiles they mark. Two barcodes, a partial last tile."""
    rng = np.random.default_rng(["sparse", "dense", "gated", "edges", "window"].index(kind))
    nb, G = 2, COV_G
    seq = torch.from_numpy(rng.integers(0, 4, G).astype(np.int8)).to(dev)
    cov = torch.from_numpy(rng.integers(0, 50, (nb, 5, G)).astype(np.uint16)).to(dev)
    ref = cov.clone()
    for step in range(5):
        torch.full((2 * nb * G,), -1, dtype=torch.int32, device=dev)  # freed: the next scratch
        bits = None
        trunc = None
        if kind == "sparse":
            full = _family(dev, _rows(dev, rng, G, nb, 12, 300, 40))
        elif kind == "dense":
            full = _family(dev, _rows(dev, rng, G, nb, 3000, 5000, 200_000))
        elif kind == "gated":
            full = _family(dev, _rows(dev, rng, G, nb, 400, 2000, 20_000, n_reads=64))
            trunc = _family(dev, _rows(dev, rng, G, nb, 400, 400, 5_000, n_reads=64))
            bits = torch.from_numpy((rng.random(64) < 0.5).astype(np.uint8)).to(dev)
        elif kind == "edges":
            full = _family(dev, _edge_rows(rng, G, nb))
        if kind == "window":
            # shard (1, 1) of a 2 x 2 window over a genome of 2G sites:
            # rows in global barcodes and positions, many starting left of g0
            full = _family(dev, _rows(dev, rng, 2 * G, 2 * nb, 1500, 6000, 50_000))
            b0, g0 = nb, G
            got = tg.shard_coverage(cov, seq, full, b0, g0)
            want = tg.shard_coverage_plain(ref, seq, full, b0, g0)
        else:
            got = tg.coverage_update(cov, seq, full, trunc, bits)
            want = tg.coverage_update_plain(ref, seq, full, trunc, bits)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (kind, step)
        assert torch.equal(cov.view(torch.int16), ref.view(torch.int16)), (kind, step)
        assert bool(got.any())


@pytest.mark.parametrize("gated", [False, True])
def test_coverage_writes_match_scratch_only_in_flagged_tiles(dev, gated):
    """H1 given a match scratch, as the engine passes it its kept coverage
    sums (csrc/coverage.cu), over three steps with rows in the first two
    tiles of six: the scratch outside the tiles H1 flags keeps what it
    held, every changed site lies in a flagged tile, and coverage and
    changed equal the plain version's."""
    rng = np.random.default_rng(2205 + gated)
    nb, G = 2, COV_G
    seq = torch.from_numpy(rng.integers(0, 4, G).astype(np.int8)).to(dev)
    cov = torch.from_numpy(rng.integers(0, 50, (nb, 5, G)).astype(np.uint16)).to(dev)
    ref = cov.clone()
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    for step in range(3):
        match = torch.full((nb, G), -12345, dtype=torch.int32, device=dev)
        trunc = bits = None
        if gated:
            full = _family(dev, _rows(dev, rng, 2 * 4096, nb, 20, 600, 60, n_reads=64))
            trunc = _family(dev, _rows(dev, rng, 2 * 4096, nb, 20, 400, 30, n_reads=64))
            bits = torch.from_numpy((rng.random(64) < 0.5).astype(np.uint8)).to(dev)
        else:
            full = _family(dev, _rows(dev, rng, 2 * 4096, nb, 20, 600, 60))
        got, tiles = tg.coverage_update_tiled(cov, seq, full, trunc, bits, match=match)
        want = tg.coverage_update_plain(ref, seq, full, trunc, bits)
        torch.cuda.synchronize()
        assert torch.equal(got, want), step
        assert torch.equal(cov.view(torch.int16), ref.view(torch.int16)), step
        flagged = ts.tile_mask(tiles, zero, G)
        assert bool(want.any()) and bool(flagged[want].all()), step
        assert 0 < int(tiles.sum()) < tiles.numel(), (step, tiles.tolist())
        assert bool((match[:, ~flagged] == -12345).all()), step


def test_coverage_saturates_at_65535(dev):
    """Sites at 65530 take 20 increments (a match run over them and
    explicit observations): they stop at 65535 in kernel and plain."""
    rng = np.random.default_rng(7)
    G = 4096
    seq = torch.from_numpy(rng.integers(0, 4, G).astype(np.int8)).to(dev)
    cov = torch.full((1, 5, G), 65530, dtype=torch.int32).to(torch.int16).view(torch.uint16)
    cov = cov.to(dev)
    ref = cov.clone()
    n = 20
    mr_g = np.full(n, 100, np.uint32)
    mr_len = np.full(n, 50, np.uint16)
    ex_g = np.full(n, 120, np.uint32)
    ex_bcsym = np.full(n, 4, np.uint16)
    full = _family(dev, (np.zeros(n, np.uint8), mr_g, mr_len, ex_bcsym, ex_g, None))
    got = tg.coverage_update(cov, seq, full)
    want = tg.coverage_update_plain(ref, seq, full)
    assert torch.equal(got, want)
    assert torch.equal(cov.view(torch.int16), ref.view(torch.int16))
    c = cov.view(torch.int16).to(torch.int32) & 0xFFFF
    assert int(c.max()) == 65535 and int(c[0, 4, 120]) == 65535


def _score_tables(dev, ploidy, deletion_error):
    from bossruns_torch.ops.model import make_model

    return ts.ScoreTables(make_model(ploidy=ploidy, deletion_error=deletion_error), device=dev)


def _mixed_coverage(rng, nb, G):
    """[nb, 5, G] uint16 where each site is one of: no counts, frozen
    (covsum >= 30), counts on the fifth plane only, or 1-20 counts per
    symbol, in runs of 1-40 sites so warps mix them; the first 300 sites
    are empty (whole empty warps)."""
    kind = np.repeat(rng.integers(0, 4, G), rng.integers(1, 41, G))[:G]
    cov = rng.integers(1, 21, (nb, 5, G)).astype(np.uint16)
    cov[:, :, kind == 0] = 0
    cov[:, :, kind == 1] = 7                      # covsum 35: frozen
    cov[:, :4, kind == 2] = 0                     # only the fifth plane
    cov[:, :, :300] = 0
    return cov


def _score_both(dev, tables, cov, seq, valid):
    args = dict(coverage=cov, seq=seq, site_valid=valid, tables=tables, freeze_cov=30,
                tiny=float(np.finfo(np.float32).tiny))
    sk, ck = ts.site_scores(**args)
    sp, cp = ts.site_scores_plain(**args)
    assert torch.equal(ck, cp)
    torch.testing.assert_close(sk, sp, rtol=1e-5, atol=5e-5)
    return sk, ck


@pytest.mark.parametrize("ploidy,deletion_error", [(1, 0.03), (1, 0.0), (2, 0.03), (2, 0.0)])
def test_score_kernel_all_models_mixed_warps(dev, ploidy, deletion_error):
    """H2 at all four model shapes ((5,5), (4,4), (5,15), (4,10)) against
    site_scores_plain on warps that mix empty, frozen, invalid, fifth-plane-
    only and covered sites; covsum exact. Empty valid sites score the same
    bits inside mixed warps (full contraction) as in empty warps (the
    per-block constants)."""
    rng = np.random.default_rng(ploidy * 10 + int(deletion_error * 100))
    nb, G = 2, 40_000
    tables = _score_tables(dev, ploidy, deletion_error)
    assert (tables.len_b, tables.len_g) in ((5, 5), (4, 4), (5, 15), (4, 10))
    seq = torch.from_numpy(rng.integers(0, 4, G).astype(np.int8)).to(dev)
    valid = torch.from_numpy(rng.random(G) < 0.9).to(dev)
    cov = torch.from_numpy(_mixed_coverage(rng, nb, G)).to(dev)
    sk, ck = _score_both(dev, tables, cov, seq, valid)
    empty = (cov[:, : tables.len_b].view(torch.int16) == 0).all(dim=1) & valid[None, :] \
        & (ck < 30)
    for r in range(4):
        vals = sk[empty & (seq[None, :] == r)]
        assert vals.numel() > 0 and bool((vals == vals[0]).all()), r


@pytest.mark.parametrize("ploidy,deletion_error", [(1, 0.03), (1, 0.0), (2, 0.03), (2, 0.0)])
def test_score_kernel_f16_all_models(dev, ploidy, deletion_error):
    """H2's half instantiation at all four model shapes against the plain
    f16 version on the card, on mixed warps plus clipped counts: bit for
    bit, and the empty sites' per-block constants equal the contraction."""
    from bossruns_torch.ops.model import make_model

    rng = np.random.default_rng(ploidy * 20 + int(deletion_error * 100))
    nb, G = 2, 40_000
    tables = ts.ScoreTables(make_model(ploidy=ploidy, deletion_error=deletion_error),
                            torch.float16, device=dev)
    seq = torch.from_numpy(rng.integers(0, 4, G).astype(np.int8)).to(dev)
    valid = torch.from_numpy(rng.random(G) < 0.9).to(dev)
    cov = _mixed_coverage(rng, nb, G)
    cov[:, :, 1000:1400] = rng.integers(985, 1200, (nb, 5, 400))  # the 990 clip, unfrozen below
    cov[:, :, 1000:1400] *= (rng.random(400) < 0.01)                # most of them frozen
    cov = torch.from_numpy(cov).to(dev)
    args = dict(coverage=cov, seq=seq, site_valid=valid, tables=tables, freeze_cov=30,
                tiny=float(np.finfo(np.float16).tiny))
    sk, ck = ts.site_scores(**args)
    sp, cp = ts.site_scores_plain(**args)
    assert sk.dtype == torch.float16 and torch.equal(ck, cp)
    assert torch.equal(sk.view(torch.int16), sp.view(torch.int16))


def test_f16_overflow_on_card_matches_cpu(dev):
    """The f16 engine on the card against the CPU where coverage sums pass
    2048 and 65,519 (inf in f16) and a 40 kb contig's f16 mean goes inf:
    state, aux (its inf mean included), threshold and scores equal."""
    rng = np.random.default_rng(29)
    lay = build_layout({c: rng.integers(0, 4, n).astype(np.uint8)
                        for c, n in (("s", 40_000), ("a", 130_000))}, min_len=30_000)
    cov = np.zeros((1, 5, lay.G_pad), np.uint16)
    o_s, o_a = int(lay.offsets[0]), int(lay.offsets[1])
    cov[0, 0, o_s: o_s + 20_000] = 9
    cov[0, 0, o_s + 100: o_s + 300] = 2049
    cov[0, 1, o_s + 300: o_s + 500] = 4097
    cov[0, :2, o_s + 700] = 35_000
    cov[0, 2, o_a + 1000: o_a + 21_000] = 2051
    cfg = truns.RunsConfig(dtype="float16", debug_aux=True)
    eg, ec = truns.RunsEngine(lay, config=cfg, device=dev), truns.RunsEngine(lay, config=cfg,
                                                                             device="cpu")
    sg, sc = eg.init_state(), ec.init_state()
    for st in (sg, sc):
        st.coverage.copy_(torch.from_numpy(cov.view(np.int16)).view(torch.uint16))
    params = eg.make_params(CCL, 5300.0)
    for step in range(2):
        b = _random_batch(rng, lay, n_obs=20_000)
        sg, ag = eg.step(sg, batch_from_numpy(b, dev), params)
        sc, ac = ec.step(sc, batch_from_numpy(b, "cpu"), params)
        for k, v in state_to_numpy(sc).items():
            np.testing.assert_array_equal(state_to_numpy(sg)[k], v, err_msg=f"{k} step {step}")
        assert torch.equal(ag.vec.cpu(), ac.vec) and float(ag.threshold) == float(ac.threshold)
        _score_close(ag.scores, ac.scores)
    assert bool(torch.isinf(ac.vec[3])) and bool(sc.zeroed[0, o_s: o_s + 20_000].all())


def test_wire_step_on_card_equals_step(dev):
    """step_from_numpy (one uint32 upload, fields viewed on the card) ==
    step on the same batch, and the gated wire == the gated dict."""
    rng = np.random.default_rng(23)
    lay = build_layout({"a": rng.integers(0, 4, 150_000).astype(np.uint8),
                        "b": rng.integers(0, 4, 120_000).astype(np.uint8)}, n_barcodes=2)
    e1 = truns.RunsEngine(lay, config=truns.RunsConfig(debug_aux=True), device=dev)
    e2 = truns.RunsEngine(lay, config=truns.RunsConfig(debug_aux=True), device=dev)
    s1, s2 = e1.init_state(), e2.init_state()
    params = e1.make_params(CCL, 5300.0)
    for step in range(3):
        b = _random_batch(rng, lay, n_obs=120_000, nb=2)
        s1, a1 = e1.step(s1, batch_from_numpy(b, dev), params)
        s2, a2 = e2.step_from_numpy(s2, b, params)
        for k, v in state_to_numpy(s1).items():
            np.testing.assert_array_equal(state_to_numpy(s2)[k], v, err_msg=f"{k} step {step}")
        assert torch.equal(a1.vec, a2.vec) and torch.equal(a1.scores, a2.scores)


@pytest.mark.parametrize("G,offset", [(40_001, 0), (40_000, 1), (4095, 0)])
def test_score_kernel_ragged_and_unaligned(dev, G, offset):
    """H2's scalar instantiation: G not a multiple of 4 (nor of a block's
    1024 sites), and every base one element off alignment, against the
    plain version at the diploid shape."""
    rng = np.random.default_rng(G + offset)
    tables = _score_tables(dev, 2, 0.03)
    up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    seq = up(rng.integers(0, 4, G + offset).astype(np.int8))[offset:]
    valid = up(rng.random(G + offset) < 0.9)[offset:]
    data = _mixed_coverage(rng, 1, G).reshape(-1)
    cov = up(np.concatenate([np.zeros(offset, np.uint16), data]))[offset:].view(1, 5, G)
    assert cov.is_contiguous() and (cov.data_ptr() % 8 != 0) == bool(offset)
    _score_both(dev, tables, cov, seq, valid)


# ------------------------------------------------- H2 over kept buffers --

@pytest.mark.parametrize("G", [6 * 4096 + 1000, 6 * 4096 + 1237])
@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16])
def test_score_kernel_tiled_equals_dense(dev, dtype, nb, G):
    """H2's launch (float, _s64 and _h16; G % 4 == 0 and the scalar
    instantiation at G % 4 != 0) over kept buffers with ``full`` clear: the
    flagged tiles' sites equal the full launch into fresh buffers (the call
    without flags) bit for bit, the others keep what they held; with
    ``full`` set every site equals it, with no tile flagged none moves."""
    from bossruns_torch.ops.model import make_model

    rng = np.random.default_rng(int(G) + 7 * nb + (dtype == torch.float64))
    tables = ts.ScoreTables(make_model(ploidy=2), dtype, device=dev)
    up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    seq = up(rng.integers(0, 4, G).astype(np.int8))
    valid = up(rng.random(G) < 0.9)
    cov = up(_mixed_coverage(rng, nb, G))
    args = dict(coverage=cov, seq=seq, site_valid=valid, tables=tables, freeze_cov=30,
                tiny=float(np.finfo(ts.NP_DTYPES[dtype]).tiny))
    want_s, want_c = ts.site_scores(**args)
    n_tiles = -(-G // tg.COVERAGE_TILE)
    i32 = lambda v: torch.full((1,), v, dtype=torch.int32, device=dev)  # noqa: E731
    for mask in (rng.random(n_tiles) < 0.5, np.zeros(n_tiles, bool)):
        if mask.any():
            mask[0] = True  # the first tile too
        tiles = up(mask.astype(np.uint8))
        kept = (torch.full((nb, G), 7.0, dtype=dtype, device=dev),
                torch.full((nb, G), -1, dtype=torch.int32, device=dev))
        ts.site_scores(**args, out=kept, tiles=tiles, full=i32(0))
        sel = ts.tile_mask(tiles, i32(0), G)
        assert torch.equal(kept[0][:, sel], want_s[:, sel])
        assert torch.equal(kept[1][:, sel], want_c[:, sel])
        assert bool((kept[0][:, ~sel] == 7.0).all()) and bool((kept[1][:, ~sel] == -1).all())
        ts.site_scores(**args, out=kept, tiles=tiles, full=i32(1))
        assert torch.equal(kept[0], want_s) and torch.equal(kept[1], want_c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16])
def test_score_kernel_without_out_equals_full_launch(dev, dtype):
    """H2 without ``out`` (the sharded step's call: new buffers and a
    ``full`` flag the wrapper sets) equals the launch into given buffers
    that hold a sentinel, with ``full`` set and no tile flagged, and with
    no tile flags at all, bit for bit."""
    from bossruns_torch.ops.model import make_model

    rng = np.random.default_rng(2302)
    nb, G = 2, 5 * 4096 + 1237
    up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    args = dict(coverage=up(_mixed_coverage(rng, nb, G)),
                seq=up(rng.integers(0, 4, G).astype(np.int8)), site_valid=up(rng.random(G) < 0.9),
                tables=ts.ScoreTables(make_model(ploidy=2), dtype, device=dev), freeze_cov=30,
                tiny=float(np.finfo(ts.NP_DTYPES[dtype]).tiny))
    want_s, want_c = ts.site_scores(**args)
    assert want_s.dtype == dtype and bool((want_c > 0).any())
    sentinel = lambda: (torch.full((nb, G), 7.0, dtype=dtype, device=dev),  # noqa: E731
                        torch.full((nb, G), -1, dtype=torch.int32, device=dev))
    kept = sentinel()
    ts.site_scores(**args, out=kept, tiles=torch.zeros(6, dtype=torch.uint8, device=dev),
                   full=torch.ones(1, dtype=torch.int32, device=dev))
    assert torch.equal(kept[0], want_s) and torch.equal(kept[1], want_c)
    kept = sentinel()
    ts.site_scores(**args, out=kept)
    assert torch.equal(kept[0], want_s) and torch.equal(kept[1], want_c)


def test_score_kernel_refuses_rows_beyond_its_offsets(dev):
    """H2's entry point returns an error, before it reads a buffer, for a G
    whose five coverage planes overrun 32-bit offsets (5 G > 2^32) and for
    a NULL scratch pointer; the largest G it takes is 858,993,459."""
    from bossruns_torch.ops import kernels as K
    from bossruns_torch.ops.model import make_model

    tables = ts.ScoreTables(make_model(ploidy=2), device=dev)
    buf = torch.zeros(64, dtype=torch.int32, device=dev)
    p = buf.data_ptr()

    def call(G, scratch=p):
        K.KERNELS["site_scores"](p, p, p, tables.packed.data_ptr(), tables.len_b,
                                 tables.len_g, 1, G, 30, 1e-30, p, p, p, p, scratch, p,
                                 K.stream_ptr(buf))

    for G in (858_993_460, 1 << 31):
        with pytest.raises(RuntimeError):
            call(G)
    with pytest.raises(RuntimeError):
        call(4096, scratch=None)
    assert bool((buf == 0).all())


def test_captured_step_across_a_restore_equals_dense_engine(dev):
    """The engine's captured step over its kept scores, with the state
    restored by copy_ in the middle (as the chromosome cell's harness does),
    equals an engine that rescores every site, run eagerly, bit for bit:
    state, aux and scores at every step; the restore keeps the graph."""
    rng = np.random.default_rng(2203)
    lay = build_layout({"a": rng.integers(0, 4, 900_000).astype(np.uint8),
                        "b": rng.integers(0, 4, 700_000).astype(np.uint8)}, n_barcodes=2)
    cfg = truns.RunsConfig(debug_aux=True)
    eng = truns.RunsEngine(lay, config=cfg, device=dev)
    dense = truns.RunsEngine(lay, config=cfg, device=dev)
    dense._kept_valid = lambda state: False
    sg, sd = eng.init_state(), dense.init_state()
    params = eng.make_params(CCL, 5300.0)
    saved, full = None, []
    for step, b in enumerate(_graph_batches(lay, 2, 2204, n=8)):
        if step == 5:
            for t, s in zip(sg, saved):
                t.copy_(s)
            for t, s in zip(sd, saved):
                t.copy_(s)
        sg, ag = eng.step_from_numpy(sg, b, params)
        full.append(eng._full_host)
        sd, ad = dense.eager("step", sd, batch_from_numpy(b, dev), params)
        torch.cuda.synchronize()
        if step == 1:
            saved = [t.clone() for t in sg]
        for k in truns.GenomeState._fields:
            assert torch.equal(getattr(sg, k), getattr(sd, k)), (k, step)
        for k in ("vec", "threshold", "scores"):
            assert torch.equal(getattr(ag, k), getattr(ad, k)), (k, step)
    assert full == [True, False, False, False, False, True, False, False]
    assert eng.graphs.replays["step_from_numpy"] == 7 and len(eng.graphs.entries) == 1


def test_second_engine_on_the_same_state_forces_a_full_rescore(dev):
    """Two engines stepping one state in turns through their captured
    graphs: a step after the other engine's rescores every site (that step
    bumped the state's versions), a step after the engine's own rescores by
    tile; every step equals an engine that rescores every site, bit for bit
    (batches in one 8 kb window per contig, so most tiles are untouched)."""
    from test_torch_engine import _window_batch

    rng = np.random.default_rng(2206)
    lay = build_layout({"a": rng.integers(0, 4, 300_000).astype(np.uint8),
                        "b": rng.integers(0, 4, 200_000).astype(np.uint8)}, n_barcodes=1)
    cfg = truns.RunsConfig(debug_aux=True)
    engines = {w: truns.RunsEngine(lay, config=cfg, device=dev) for w in "AB"}
    dense = truns.RunsEngine(lay, config=cfg, device=dev)
    dense._kept_valid = lambda state: False
    params = {w: e.make_params(CCL, 5300.0) for w, e in engines.items()}
    pd = dense.make_params(CCL, 5300.0)
    s, sd = engines["A"].init_state(), dense.init_state()
    order = "AABAABBA"
    batches = _one_tier([_window_batch(rng, lay, 1, n_runs=600, width=8_000) for _ in order])
    kinds = []
    for step, (w, b) in enumerate(zip(order, batches)):
        s, a = engines[w].step_from_numpy(s, b, params[w])
        kinds.append(engines[w]._full_host)
        sd, ad = dense.eager("step", sd, batch_from_numpy(b, dev), pd)
        torch.cuda.synchronize()
        for k in truns.GenomeState._fields:
            assert torch.equal(getattr(s, k), getattr(sd, k)), (k, step)
        for k in ("vec", "threshold", "scores"):
            assert torch.equal(getattr(a, k), getattr(ad, k)), (k, step)
    assert kinds == [True, False, True, True, False, True, False, True]
    assert sum(e.graphs.replays["step_from_numpy"] for e in engines.values()) > 0


# ----------------------------------------------------------- engine options --
# fhat_alpha != 1 (H3's general point mass), dtype="float64" (the _s64 entry
# points of H2, H3 and H8's rows), benefit_dtype="float32" (the _d32
# entry points of H3, H4 and H8) and dtype="float16" (the _h16 entry points
# of H2, H3 and H8's rows, and H4's half aux), each against its plain version

OPTIONS = {
    "alpha": dict(fhat_alpha=1.7),
    "s64": dict(dtype="float64"),
    "d32": dict(benefit_dtype="float32"),
    "s64_d32": dict(dtype="float64", benefit_dtype="float32"),
    "h16": dict(dtype="float16"),
    "h16_d32": dict(dtype="float16", benefit_dtype="float32"),
}


@pytest.fixture(scope="module", params=list(OPTIONS))
def option_world(request, dev):
    rng = np.random.default_rng(3)
    lay = build_layout({"a": rng.integers(0, 4, 150_000).astype(np.uint8),
                        "b": rng.integers(0, 4, 120_000).astype(np.uint8)}, n_barcodes=2)
    cfg = truns.RunsConfig(debug_aux=True, **OPTIONS[request.param])
    eng = truns.RunsEngine(lay, config=cfg, device=dev)
    state = eng.init_state()
    params = eng.make_params(CCL, 5300.0)
    for _ in range(3):
        b = batch_from_numpy(_random_batch(rng, lay, n_obs=120_000, nb=2), dev)
        state, _ = eng.step(state, b, params)
    batch = batch_from_numpy(_random_batch(rng, lay, n_obs=120_000, nb=2), dev)
    return request.param, eng, state, batch, params


def _f16_ulps(a, b):
    """|a - b| of two f16 tensors in f16 ulps (sign-magnitude bit order)."""
    key = lambda t: torch.where(t.view(torch.int16) < 0,  # noqa: E731
                                -(t.view(torch.int16).long() & 0x7FFF), t.view(torch.int16).long())
    return (key(a) - key(b)).abs()


def _score_close(a, b):
    if a.dtype == torch.float64:
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    elif a.dtype == torch.float16:
        # the same f32 ops rounded to half at the same points: equal but
        # where CUDA's expf/logf and another device's round across a half
        # (card vs CPU); none measured on an H100 (16.4M sites)
        u = _f16_ulps(a.cpu(), b.cpu())
        assert float((u == 0).double().mean()) >= 0.9999 and int(u.max()) <= 1, int(u.max())
    else:
        torch.testing.assert_close(a, b, rtol=1e-5, atol=5e-5)


def test_option_engine_on_card_matches_cpu(option_world, dev):
    option, eng, _, _, _ = option_world
    rng = np.random.default_rng(19)
    cpu = truns.RunsEngine(eng.layout, config=eng.config, device="cpu")
    sg, sc = eng.init_state(), cpu.init_state()
    params = eng.make_params(CCL, 5300.0)
    updated = 0
    for step in range(6):
        b = _random_batch(rng, eng.layout, n_obs=120_000, nb=2)
        sg, ag = eng.step(sg, batch_from_numpy(b, dev), params)
        sc, ac = cpu.step(sc, batch_from_numpy(b, "cpu"), params)
        g, c = state_to_numpy(sg), state_to_numpy(sc)
        for k in ("coverage", "zeroed", "bucket_on", "read_starts"):
            np.testing.assert_array_equal(g[k], c[k], err_msg=f"{option} {k} step {step}")
        _score_close(ag.scores.cpu(), ac.scores)
        assert bool(ag.updated) == bool(ac.updated)
        updated += bool(ag.updated)
    assert updated >= 1


def test_option_stage_kernels_against_plain(option_world, dev):
    """H2 (f64 tables), H3 and H4 of the option's entry points against
    their plain versions on the same inputs: H3 exact but for the f32
    rounding of fhat_exp (one ulp) and, under a general alpha, the fhat
    weights (rtol 1e-13); H4's windows within the scan's rounding, its
    threshold and strategy exact given the kernel's own benefit."""
    option, eng, state, batch, params = option_world
    S, D = eng.dtype, eng.benefit_dtype
    args = eng.score_args(state)
    sk, ck = ts.site_scores(**args)
    sp, cp = ts.site_scores_plain(**args)
    assert sk.dtype == S and torch.equal(ck, cp)
    _score_close(sk, sp)
    rows = tg.CovRows(batch.mr_bc, batch.mr_g, batch.mr_len, batch.ex_bcsym, batch.ex_g)
    changed = tg.coverage_update_plain(**_clone(eng.coverage_args(state, rows)))
    aux = torch.zeros(4, dtype=S, device=dev)
    rargs = eng.row_args(state, sk, ck, changed, aux, params, batch.rs_row, batch.rs_strand,
                         rs_w=batch.rs_w)
    a, b = _clone(rargs), _clone(rargs)
    (ds_k, fe_k), (ds_p, fe_p) = tg.row_stage(**a), tg.row_stage_plain(**b)
    assert ds_k.dtype == D and torch.equal(ds_k, ds_p)
    torch.testing.assert_close(fe_k, fe_p, rtol=2.0 ** -23, atol=0)
    for k in ("scores", "zeroed", "bucket_on", "read_starts", "aux"):
        assert torch.equal(a[k], b[k]), k
    # the fhat weights, through H8's table phase on the whole genome
    wk = tg.row_workspace(sk, eng.contig_denom, eng.NW_pad, state.read_starts)
    wp = tg.row_workspace(sk, eng.contig_denom, eng.NW_pad, state.read_starts)
    k1, k2 = _clone(rargs), _clone(rargs)
    for phase in ("sums", "tables"):
        tg.shard_rows(phase, wk, **k1)
        tg.shard_rows_plain(phase, wp, **k2)
    torch.testing.assert_close(wk["fhat_w"], wp["fhat_w"], rtol=1e-13, atol=0)
    if eng.config.fhat_alpha == 1.0:
        assert torch.equal(wk["fhat_w"], wp["fhat_w"])
    bargs = eng.benefit_args(state, ds_k, fe_k, a["aux"], params)
    a, b = _clone(bargs), _clone(bargs)
    smu_k, ben_k, thr_k = tg.benefit_strategy(**a)
    smu_p, ben_p, thr_p = tg.benefit_strategy_plain(**b)
    assert thr_k.dtype == D
    eps, rtol = (256 * 2.0 ** -52, 1e-12) if D == torch.float64 else (4096 * 2.0 ** -23, 1e-6)
    atol = eps * float(ds_k.sum(dim=1).max())
    torch.testing.assert_close(smu_k, smu_p, rtol=rtol, atol=atol)
    torch.testing.assert_close(ben_k, ben_p, rtol=rtol, atol=atol)
    ref = tg.find_strategy(ben_k, smu_k, fe_k[None].expand_as(ben_k), bargs["time_cost"])
    assert float(ref.threshold) == float(thr_k)
    bidx = eng.bucket_idx.long()
    gate = bargs["bucket_on"][:, bidx.clamp_min(0)] & (bidx >= 0)[None] & eng.strat_valid[None]
    want = torch.where((gate & (a["aux"][1] > 0))[..., None], ref.strat, bargs["strat"])
    assert torch.equal(a["strat"], want)
    lo, hi = sorted((float(thr_k), float(thr_p)))
    assert hi <= 2 * lo * (1 + 1e-5)
    flips = a["strat"] != b["strat"]
    slack = (rtol * ben_p.abs() + atol)[flips]
    assert bool(((ben_k[flips] >= lo - slack) & (ben_k[flips] <= hi + slack)).all())


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_shard_kernels_and_mesh_on_card(dev, option):
    """H8 under the option: every phase of every shard of a (2, 2) mesh
    against its plain version (chip_smoke's probe), and the sharded engine
    equal to the single engine on the card bit for bit (tile-aligned
    shards)."""
    from chip_smoke import ShardProbe
    from bossruns_torch.parallel.mesh import ShardedRunsEngine, make_mesh

    lay, batches = _mesh_world(2, 43)
    cfg = truns.RunsConfig(**OPTIONS[option])
    single = truns.RunsEngine(lay, config=cfg, device=dev)
    sharded = ShardedRunsEngine(lay, make_mesh([dev] * 4, barcode_shards=2), config=cfg)
    probe = ShardProbe(range(4), timed=False)
    sharded.probe = probe
    s1, ss = single.init_state(), sharded.init_state()
    params = single.make_params(CCL, 5300.0)
    for i, b in enumerate(batches):
        s1, a1 = single.step(s1, batch_from_numpy(b, dev), params)
        ss, a_s = sharded.step(ss, batch_from_numpy(b, dev), params)
        assert torch.equal(a_s.threshold, a1.threshold), i
        assert torch.equal(a_s.vec, a1.vec), i
    torch.cuda.synchronize()
    assert len(probe.calls) == 3 * 4 * (1 + 4 + 5)
    got, want = sharded.state_numpy(ss), single.state_numpy(s1)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert bool(a1.updated)


# ---------------------------------------- captured steps (models/graphs.py) --

def _graph_batches(lay, nb: int, seed: int, n: int = 5) -> list:
    """n batches of one shape tier (every field padded to the largest)."""
    rng = np.random.default_rng(seed)
    return _one_tier([_random_batch(rng, lay, n_obs=300_000, nb=nb) for _ in range(n)])


def _one_tier(bs: list) -> list:
    """The batches ``bs``, every field padded to the largest."""
    for k, fill in (("mr_bc", 0), ("mr_g", 0), ("mr_len", 0), ("ex_bcsym", 0),
                    ("ex_g", tg.EX_PAD), ("rs_row", 0), ("rs_strand", 0), ("rs_w", 0)):
        m = max(b[k].shape[0] for b in bs)
        for b in bs:
            a = np.full(m, fill, b[k].dtype)
            a[: b[k].shape[0]] = b[k]
            b[k] = a
    return bs


@pytest.mark.parametrize("path", ["step", "step_from_numpy", "step_gated", "mesh"])
def test_replay_equals_eager_on_card(dev, path):
    """Each path's captured step (a tier's second step captures it, later
    ones replay) equals the eager step body on a second state, bit for bit
    over 5 steps: state, aux.vec, threshold and the strategy; the path
    counts replays above 0, and the kernels' launch counts grow with each
    replay."""
    from bossruns_torch.ops import kernels
    from bossruns_torch.parallel.mesh import ShardedRunsEngine, make_mesh
    from test_torch_wire import _gated_from_batch

    rng = np.random.default_rng(61)
    lay = build_layout({"a": rng.integers(0, 4, 900_000).astype(np.uint8),
                        "b": rng.integers(0, 4, 700_000).astype(np.uint8)}, n_barcodes=2,
                       align_chunks=4)
    cfg = truns.RunsConfig(debug_aux=True)
    if path == "mesh":
        eng = ShardedRunsEngine(lay, make_mesh([dev] * 4, barcode_shards=2), config=cfg)
    else:
        eng = truns.RunsEngine(lay, config=cfg, device=dev)
    sg, se = eng.init_state(), eng.init_state()
    params = eng.make_params(CCL, 5300.0)
    for step, b in enumerate(_graph_batches(lay, 2, 62)):
        before = kernels.launches()
        if path == "step_gated":
            d = _gated_from_batch(rng, b, 300)
            bits = torch.from_numpy((rng.random(300) < 0.6).astype(np.uint8)).to(dev)
            wire, spec = eng.pack_gated(d, out=eng.stage)
            gated = eng.unpack_gated(eng.upload_wire(wire, spec), spec)
            sg, ag = eng.step_gated(sg, gated, bits, params)
            se, ae = eng.eager("step_gated", se, eng.unpack_gated(
                torch.from_numpy(eng.pack_gated(d)[0]).to(dev), spec), bits, params)
        elif path == "step_from_numpy":
            sg, ag = eng.step_from_numpy(sg, b, params)
            se, ae = eng.eager("step_from_numpy", se, b, params)
        else:
            bd = batch_from_numpy(b, dev)
            sg, ag = eng.step(sg, bd, params)
            se, ae = eng.eager("step", se, bd, params)
        torch.cuda.synchronize()
        grew = {k: v - before[k] for k, v in kernels.launches().items() if v != before[k]}
        assert grew, f"no kernel launched at step {step}"
        got, want = eng.state_numpy(sg), eng.state_numpy(se)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{path} {k} step {step}")
        assert torch.equal(ag.vec, ae.vec) and torch.equal(ag.threshold, ae.threshold), step
        assert torch.equal(ag.scores, ae.scores), step
    key = "step" if path == "mesh" else path
    assert eng.graphs.replays[key] >= 3 and eng.graphs.eager[key] == 1, eng.graphs.stats()
    assert bool(ae.updated)


def test_capture_error_raises(dev):
    """A step body that cannot be captured (a device-to-host copy inside
    it) runs eagerly on its first occurrence and raises on the second,
    when the cache captures it: there is no fallback to eager."""
    rng = np.random.default_rng(63)
    lay = build_layout({"a": rng.integers(0, 4, 150_000).astype(np.uint8)})
    eng = truns.RunsEngine(lay, device=dev)
    state, params = eng.init_state(), eng.make_params(CCL, 5300.0)
    inputs = batch_from_numpy(_random_batch(rng, lay, n_obs=20_000), dev)._asdict()

    def body(s, i, p):
        s, aux = eng._classic(s, i, p)
        aux.vec.cpu()
        return s, aux

    eng.graphs.run("step", state, inputs, params, body, eng.win_cap(params, 4096))
    with pytest.raises(RuntimeError):
        eng.graphs.run("step", state, inputs, params, body, eng.win_cap(params, 4096))
    torch.cuda.synchronize()
