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
the contract tests/test_torch_engine.py holds on the CPU.
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
        x = torch.from_numpy(mat).to(dev)
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
    x = torch.from_numpy(mat).to(dev)
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
    x = torch.from_numpy(mat).to(dev)
    got = S.seed_candidates(x, pidx.dev)
    want = S.seed_candidates_plain(x, pidx.dev, tol=S.candidate_tol(L))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert float((got[:-4, 0] >= 4).any(dim=1).float().mean()) > 0.8


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
