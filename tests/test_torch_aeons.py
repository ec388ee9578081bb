"""The AEONS modules of the port against the JAX package, on the CPU.

* the pool-index scans (``aligner.index.build_index_cached``) give arrays
  byte-identical to JAX's, and to the scan of the real concatenation;
* ``seed_candidates_plain`` (the plain version of kernel H6) equals JAX's
  ``_seed_candidates_jit`` in all 48 entries of every row (6 fields x 8
  columns), placeholders and padding rows included;
* ``host_seed_candidates`` is byte-identical to JAX's;
* ``find_overlaps`` rows equal JAX's in both seeding modes, merged or not;
* ``contig_strategies`` on the CPU (the plain version of kernel H7) equals
  the f64 host path (threshold rel 1e-12, every mask bit) and JAX's host
  backend (every mask bit), and is within the JAX test's tolerance of the
  sequential mirror and of JAX's f32 device kernel.
"""
import numpy as np
import pytest
import torch

from bossruns_tpu.aeons import ava as java
from bossruns_tpu.aeons import benefit as jben
from bossruns_tpu.aeons.pool import Sequence
from bossruns_tpu.aligner import encode
from bossruns_tpu.aligner import host_seed as jhs
from bossruns_tpu.aligner import index as jidx
from bossruns_tpu.aligner import seed as jseed
from bossruns_tpu.utils.datagen import random_genome, simulate_reads
from bossruns_torch.aeons import ava as tava
from bossruns_torch.aeons import benefit as tben
from bossruns_torch.aligner import host_seed as ths
from bossruns_torch.aligner import index as tidx
from bossruns_torch.aligner import seed as tseed
from test_aeons import _numpy_contig_strategies

torch.set_num_threads(2)

BASES = np.array(list("ACGT"))
CCL = np.array([20000, 14000, 10000, 7000, 5000, 3500, 2500, 1700, 900, 300])
INDEX_FIELDS = ("keys", "offsets", "positions", "strands")


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _random_pool(rng, n=12, lo=60, hi=5000):
    seqs = {}
    for i in range(n):
        L = int(rng.integers(lo, hi))
        s = "".join(BASES[rng.integers(0, 4, L)])
        if L > 100 and i % 3 == 0:
            p = int(rng.integers(10, L - 20))
            s = s[:p] + "NNN" + s[p + 3:]
        seqs[f"s{i}"] = s
    return seqs


# ------------------------------------------------------------ pool index --

@pytest.mark.parametrize("k,w,max_occ", [(15, 10, 32), (13, 5, 64)])
def test_build_index_cached_matches_jax(k, w, max_occ):
    rng = np.random.default_rng(7)
    seqs = _random_pool(rng)
    seqs["dup"] = seqs["s1"]  # a repeated value shares one memo entry
    lengths = np.array([len(s) for s in seqs.values()], np.int64)
    starts = np.concatenate([[0], np.cumsum(lengths + tava.GAP)[:-1]]).astype(np.int64)
    tidx._SEQ_SCAN_CACHE.clear()
    got = tidx.build_index_cached(list(seqs.values()), starts, k=k, w=w, max_occ=max_occ)
    again = tidx.build_index_cached(list(seqs.values()), starts, k=k, w=w, max_occ=max_occ)
    want = jidx.build_index_cached(list(seqs.values()), starts, k=k, w=w, max_occ=max_occ)
    concat = np.full(int((lengths + tava.GAP).sum()), 4, np.int8)
    for s0, s in zip(starts, seqs.values()):
        concat[s0: s0 + len(s)] = encode(s)
    valid = concat < 4
    scan = tidx.build_index(np.where(valid, concat, 0).astype(np.uint8), valid, k=k, w=w,
                            max_occ=max_occ)
    for f in INDEX_FIELDS:
        _same(getattr(got, f), getattr(want, f), f)
        _same(getattr(again, f), getattr(want, f), f"{f} (memo hit)")
        _same(getattr(scan, f), getattr(want, f), f"{f} (concat scan)")


def test_pool_index_memo_hits_across_rebuilds():
    rng = np.random.default_rng(3)
    seqs = _random_pool(rng, n=6)
    tidx._SEQ_SCAN_CACHE.clear()
    tava.PoolIndex(seqs, device="cpu")
    n_first = len(tidx._SEQ_SCAN_CACHE)
    assert n_first == len(seqs)
    tava.PoolIndex(dict(seqs, extra="".join(BASES[rng.integers(0, 4, 900)])), device="cpu")
    assert len(tidx._SEQ_SCAN_CACHE) == n_first + 1
    s = seqs["s1"]
    a, b = tidx.scan_seq_minimizers(s), tidx.scan_seq_minimizers(s)
    assert a[0] is b[0] and a[1] is b[1]


# ------------------------------------------------------------------- K9 --

@pytest.fixture(scope="module")
def corpus_small():
    """test_host_seed.py's corpus: 120 kb with a planted 3 kb repeat, 300
    reads (both strands, mismatches and indels), k15/w10 index."""
    rng = np.random.default_rng(77)
    G = 120_000
    base = rng.integers(0, 4, G).astype(np.uint8)
    base[80_000:83_000] = base[20_000:23_000]
    genome = {"g": "".join(BASES[base])}
    idx = jidx.build_index(base, np.ones(G, bool), k=15, w=10, max_occ=64)
    sim = simulate_reads(rng, genome, 300, mean_len=1500.0, sd_len=800.0)
    return idx, [encode(r.seq) for r in sim]


@pytest.fixture(scope="module")
def ava_world():
    """An all-vs-all world: a 200 kb genome, a pool of 5 kb reads and its
    PoolIndex (k15/w10, max_occ 32), and queries drawn from the genome."""
    rng = np.random.default_rng(5)
    genome = random_genome(rng, {"g": 200_000})
    pool = {r.rid: r.seq for r in simulate_reads(rng, genome, 120, mean_len=5000.0)}
    queries = {f"q{i}": r.seq for i, r in enumerate(
        simulate_reads(rng, genome, 24, mean_len=5000.0))}
    long = {f"L{i}": r.seq for i, r in enumerate(
        simulate_reads(rng, genome, 12, mean_len=18000.0, min_len=9000))}
    return genome, pool, queries, long


def _matrix(enc, L, junk=0, seed=0):
    mat = np.full((len(enc) + junk, L), 4, np.int8)
    for r, e in enumerate(enc):
        mat[r, : min(e.shape[0], L)] = e[:L]
    if junk:  # random codes incl. N: reads with few or no hits
        mat[len(enc):] = np.random.default_rng(seed).integers(0, 5, (junk, L))
    return mat


def _jax_candidates(mat, idx, tol):
    d = jseed.seed_candidates(mat, jseed.DeviceIndex(idx), ncand=4, tol=tol)
    return np.stack([d[f] for f in tseed.CAND_FIELDS], axis=1)


def _check_k9(mat, idx, tol):
    want = _jax_candidates(mat, idx, tol)
    got = tseed.seed_candidates(torch.from_numpy(mat), tseed.DeviceIndex(idx, "cpu"), ncand=4,
                                tol=tol).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape == (mat.shape[0], 6, 8)
    np.testing.assert_array_equal(got, want.astype(np.int32))
    return got


def test_seed_candidates_plain_matches_jax_corpus_small(corpus_small):
    idx, enc = corpus_small
    mat = _matrix(enc, 4096, junk=8)
    got = _check_k9(mat, idx, None)
    assert (got[:, 0] > 0).any(axis=1).mean() > 0.9          # the corpus maps
    assert (got[:, 0] == -1).any() and (got[:, 2] == 1 << 30).any()  # placeholders


@pytest.mark.parametrize("L,tol", [(8192, 256), (32768, 1024)])
def test_seed_candidates_plain_matches_jax_ava(ava_world, L, tol):
    _, pool, queries, long = ava_world
    pidx = java.PoolIndex(pool)
    reads = queries if L == 8192 else dict(list(long.items())[:6])
    mat = _matrix([encode(s) for s in reads.values()], L, junk=2, seed=L)
    assert tol == tseed.candidate_tol(L)
    got = _check_k9(mat, pidx.host, tol)
    assert (got[:-2, 0] >= 4).any(axis=1).mean() > 0.8


def test_host_seed_candidates_matches_jax(ava_world):
    _, pool, queries, long = ava_world
    pidx = tava.PoolIndex(pool, device="cpu")
    for L, reads, budget in ((8192, queries, None), (32768, long, None),
                             (131072, long, tava.ULTRALONG_BUDGET)):
        enc = [encode(s)[:L] for s in reads.values()]
        want = jhs.host_seed_candidates(enc, pidx.host, ncand=4, L=L, budget=budget)
        got = ths.host_seed_candidates(enc, pidx.host, ncand=4, L=L, budget=budget)
        for f, v in want.items():
            _same(got[f], v, f"{f} L={L}")
        # memoised scans stand in for the batch scan of reads that fit L
        fit = [s for s in reads.values() if len(s) <= L]
        scans = [tidx.scan_seq_minimizers(s, 15, 10) for s in fit]
        enc = [encode(s) for s in fit]
        want = jhs.host_seed_candidates(enc, pidx.host, ncand=4, L=L, budget=budget)
        pre = ths.host_seed_candidates(enc, pidx.host, ncand=4, L=L, budget=budget,
                                       pre_scans=scans)
        for f, v in want.items():
            _same(pre[f], v, f"{f} L={L} pre-scanned")


# ------------------------------------------------------- find_overlaps --

def _same_rows(a, b, what):
    assert a.keys() == b.keys(), what
    for f in a:
        assert a[f] == b[f], f"{what}: field {f} differs"


@pytest.mark.parametrize("merge", [False, True])
def test_find_overlaps_matches_jax(ava_world, merge):
    _, pool, queries, long = ava_world
    target = dict(pool, **queries, **long)
    new = dict(queries, **long)
    jp = java.PoolIndex(target)
    tp = tava.PoolIndex(target, device="cpu")
    want = java.find_overlaps(new, jp, merge=merge, host=False)
    _same_rows(java.find_overlaps(new, jp, merge=merge, host=True), want, "jax host vs device")
    assert len(want["qname"]) > 50
    for backend in ("auto", "host"):
        _same_rows(tava.find_overlaps(new, tp, merge=merge, backend=backend), want, backend)


def test_ultralong_overlap_single_unfragmented_dovetail():
    """Twin of test_aeons.py's: 100 kb ultralong reads at ~10% error give ONE
    overlap record covering the shared region, a proper dovetail, and the
    port's rows equal JAX's."""
    from bossruns_tpu.aeons.classify import classify
    from bossruns_tpu.utils.datagen import _simulate_alignment

    g = random_genome(np.random.default_rng(3), {"g": 160_000})["g"]
    a, _ = _simulate_alignment(np.random.default_rng(4), g[:120_000],
                               sub=0.02, ins=0.07, dele=0.01)
    b, _ = _simulate_alignment(np.random.default_rng(5), g[20_000:140_000],
                               sub=0.02, ins=0.07, dele=0.01)
    merged = tava.find_overlaps({"B": b}, tava.PoolIndex({"A": a}, device="cpu"), merge=True)
    _same_rows(merged, java.find_overlaps({"B": b}, java.PoolIndex({"A": a}), merge=True),
               "ultralong")
    assert len(merged["qname"]) == 1, merged["qname"]
    assert merged["qend"][0] - merged["qstart"][0] >= 0.9 * 100_000
    assert int(classify(tava.rows_to_records(merged)).c[0]) in (4, 5)


# ------------------------------------------------------------------ K10 --

def _contigs(rng, spec, cov):
    out = {}
    for name, L, arg in spec:
        s = Sequence(name, "A" * L)
        s.cov = cov(rng, L, arg).astype(np.float32)
        out[name] = s
    return out


def _case(name):
    rng = np.random.default_rng(0)
    if name == "shapes":  # test_contig_strategies_shapes_and_threshold
        return _contigs(rng, (("c1", 30_000, 30), ("c2", 12_345, 30)),
                        lambda r, L, hi: r.uniform(0, hi, L))
    if name == "mirror":  # test_contig_strategies_matches_numpy_mirror
        c = _contigs(rng, (("cA", 25_000, 3.0), ("cB", 9_000, 20.0), ("cC", 14_000, 8.0)),
                     lambda r, L, base: r.uniform(0, 2 * base, L))
        c["cB"].cap_l = True
        return c
    if name == "ends":  # test_uncapped_low_coverage_ends_are_kept
        s = Sequence("c", "A" * 40_000)
        s.cov = np.full(40_000, 60.0, np.float32)
        s.cov[:600] = 1.0
        s.cov[-600:] = 1.0
        return {"c": s}
    if name == "pool":  # bench.py's strat_triple shape, cut to 10 x 50 kb
        return _contigs(rng, [(f"u{j}", 50_000, 22) for j in range(10)],
                        lambda r, L, hi: r.integers(0, hi, L))
    if name == "long":  # one 5 Mb contig: the longest per-contig prefix chain
        return _contigs(rng, (("L", 5_000_000, 22),),
                        lambda r, L, hi: np.repeat(r.integers(0, hi, -(-L // 100)), 100)[:L])
    if name == "tiny":  # 2,000 contigs of 100-200 bases (one or two chunks each), each
        # with its own coverage level and ends capped at random
        lens, lv, caps = rng.integers(100, 201, 2000), rng.integers(1, 41, 2000), rng.integers(
            0, 4, 2000)
        c = _contigs(rng, [(f"t{j}", int(L), int(lv[j])) for j, L in enumerate(lens)],
                     lambda r, L, hi: r.integers(0, hi, L))
        for j, h in enumerate(c):
            c[h].cap_l, c[h].cap_r = bool(caps[j] & 1), bool(caps[j] & 2)
        return c
    # no nonzero benefit: every chunk saturated, both ends capped
    c = _contigs(rng, (("z", 20_000, 0),), lambda r, L, _: np.full(L, 100.0))
    c["z"].cap_l = c["z"].cap_r = True
    return c


def _flat(masks, names):
    return np.concatenate([masks[h].ravel() for h in names])


@pytest.mark.parametrize("case", ["shapes", "mirror", "ends", "pool", "flat", "long", "tiny"])
def test_contig_strategies_matches_host_and_jax(case):
    contigs = _case(case)
    names = list(contigs)
    plain, thr = tben.contig_strategies(contigs, CCL, 6000.0, lowcov=10, device="cpu")
    host, thr_h = tben.contig_strategies(contigs, CCL, 6000.0, lowcov=10, device="cpu",
                                         backend="host")
    jhost, thr_jh = jben.contig_strategies(contigs, CCL, 6000.0, lowcov=10, backend="host")
    jdev, thr_jd = jben.contig_strategies(contigs, CCL, 6000.0, lowcov=10, backend="device")
    mirror, thr_m = _numpy_contig_strategies(contigs, CCL, lam=6000.0, lowcov=10)
    for h in names:
        assert plain[h].dtype == bool and plain[h].shape == (-(-len(contigs[h].seq) // 100), 2)
    # the f64 host path: threshold to rel 1e-12, every mask bit
    assert thr == pytest.approx(thr_h, rel=1e-12, abs=0.0)
    assert thr == pytest.approx(thr_jh, rel=1e-12, abs=0.0)
    _same(_flat(plain, names), _flat(host, names), "mask vs host copy")
    _same(_flat(plain, names), _flat(jhost, names), "mask vs JAX host backend")
    # the sequential mirror and the f32 JAX kernel: the JAX test's bar
    # (threshold rel 1e-5, >= 99.9% of the mask bits)
    for ref, t_ref, what in ((mirror, thr_m, "mirror"), (jdev, thr_jd, "JAX _strategy_jit")):
        assert thr == pytest.approx(t_ref, rel=1e-5), what
        agree = float((_flat(plain, names) == _flat(ref, names)).mean())
        assert agree >= 0.999, (what, agree)
    if case == "flat":
        assert thr == 0.0 and all(m.all() for m in plain.values())
    else:
        assert thr > 0 and 0.0 < np.mean([m.mean() for m in plain.values()]) < 1.0
    if case == "ends":
        st = plain["c"]
        assert (st[0, 0] or st[0, 1]) and (st[-1, 0] or st[-1, 1]) and st.mean() < 0.9


def test_score_table_is_the_host_expression():
    """The 101-entry table gives bit for bit the scores _strategy_host
    computes on a contig's chunk means, at any slice position and length."""
    rng = np.random.default_rng(1)
    for lowcov in (10.0, 5.0, 12.5):
        table = tben.score_table(lowcov)
        for n in (1, 7, 16, 17, 1000):
            cov = rng.integers(0, 101, n + 3).astype(np.uint8)[3:]
            with np.errstate(over="ignore"):
                sc = (1.0 / (np.exp(cov.astype(np.float32) - np.float32(lowcov)) + 1.0)).astype(
                    np.float32)
            _same(table[cov], sc, f"lowcov {lowcov} n {n}")


def test_strategy_rejects_unknown_backend():
    with pytest.raises(ValueError, match="backend"):
        tben.contig_strategies(_case("ends"), CCL, 6000.0, device="cpu", backend="jit")
    with pytest.raises(ValueError, match="backend"):
        tava.find_overlaps({"a": "ACGT" * 100}, tava.PoolIndex({"b": "ACGT" * 100}, device="cpu"),
                           backend="gpu")
