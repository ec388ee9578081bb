"""The port's aligner (bossruns_torch.aligner) against the JAX package's.

* seeding: the port's plain seeding equals ``_seed_topn_jit`` exactly, in
  all 24 output rows including placeholders, on the ``corpus_small`` world
  of test_host_seed.py (k15/w10) and on 400-base prefixes at L=512 with a
  k13/w5 index; its voted candidates equal the port's host mirror;
* the stages: hash, canonical codes and minimizers with N's and a
  palindromic k-mer, the staggered-grid vote with negative diagonals and
  SENTINELs, and the index lookup's hits and ranks, by the sorted search
  and by the kernels' bucket table (a PyTorch mirror, empty index too);
* records: ``TorchAligner(device="cpu")`` is byte-identical to the JAX
  ``TpuAligner`` and to the port's ``CpuAligner`` (truncated, full,
  all_records) on the worlds of test_aligner.py and test_multi_align.py;
* F1: a bucket whose CIGARs all come back empty gives empty records.

Every comparison is exact: seeding and records are integers.
"""
import numpy as np
import pytest
import torch

from bossruns_tpu.aligner import LENGTH_BUCKETS as JAX_BUCKETS
from bossruns_tpu.aligner import TpuAligner
from bossruns_tpu.aligner import encode as jencode
from bossruns_tpu.aligner import seed as jseed
from bossruns_tpu.models.layout import build_layout
from bossruns_tpu.utils.datagen import (_simulate_alignment, random_genome,
                                        simulate_reads)
from bossruns_torch import aligner as tal
from bossruns_torch.aligner import native as tnative
from bossruns_torch.aligner import seed as tseed
from bossruns_torch.aligner.cpu_baseline import CpuAligner
from bossruns_torch.aligner.host_seed import host_seed_topn
from bossruns_torch.aligner.index import build_index

torch.set_num_threads(2)

PAF_FIELDS = ("qlen", "qstart", "qend", "rev", "tlen", "tstart", "tend", "nmatch",
              "blocklen", "mapq", "align_score", "s1", "primary")


def _pad_matrix(enc, L):
    mat = np.full((len(enc), L), 4, np.int8)
    for r, e in enumerate(enc):
        mat[r, : min(e.shape[0], L)] = e[:L]
    return mat


@pytest.fixture(scope="module")
def corpus_small():
    """test_host_seed.py's world: 120 kb with a planted 3 kb repeat, 300
    reads, k15/w10."""
    rng = np.random.default_rng(77)
    G = 120_000
    base = rng.integers(0, 4, G).astype(np.uint8)
    base[80_000:83_000] = base[20_000:23_000]
    genome = {"g": "".join(np.array(list("ACGT"))[base])}
    idx = build_index(base, np.ones(G, bool), k=15, w=10, max_occ=64)
    sim = simulate_reads(rng, genome, 300, mean_len=1500.0, sd_len=800.0)
    enc = [tal.encode(r.seq) for r in sim]
    L = next(b for b in tal.LENGTH_BUCKETS if max(e.shape[0] for e in enc) <= b)
    return idx, enc, L


@pytest.fixture(scope="module")
def prefixes_k13w5():
    """400-base read prefixes at L=512 on a k13/w5 index: the sim's
    decision pass."""
    rng = np.random.default_rng(13)
    G = 150_000
    base = rng.integers(0, 4, G).astype(np.uint8)
    base[100_000:104_000] = base[30_000:34_000]
    genome = {"g": "".join(np.array(list("ACGT"))[base])}
    idx = build_index(base, np.ones(G, bool), k=13, w=5, max_occ=64)
    sim = simulate_reads(rng, genome, 400, mean_len=2500.0, sd_len=1200.0)
    return idx, [tal.encode(r.seq[:400]) for r in sim], 512


def _jax_seeds(idx, mat, L):
    di = jseed.DeviceIndex(idx)
    return np.asarray(jseed._seed_topn_jit(
        jseed.pack_reads(mat), di.keys, di.pos_packed, idx.k, idx.w,
        jseed.anchor_budget(L, idx.w), L, jseed.NCAND))


def _port_seeds(idx, mat, L):
    di = tseed.DeviceIndex(idx, "cpu")
    return tseed.seed_topn(torch.from_numpy(tseed.pack_reads(mat).view(np.int32)), di, idx.k,
                           idx.w, tseed.anchor_budget(L, idx.w), L).numpy()


@pytest.mark.parametrize("world", ["corpus_small", "prefixes_k13w5"])
def test_plain_seeding_equals_jax_in_every_row(world, request):
    idx, enc, L = request.getfixturevalue(world)
    mat = _pad_matrix(enc, L)
    want = _jax_seeds(idx, mat, L)
    got = _port_seeds(idx, mat, L)
    assert got.dtype == np.int32 and got.shape == want.shape == (24, mat.shape[0])
    np.testing.assert_array_equal(got, want)
    votes0 = got[2]
    assert (votes0 >= 3).mean() > 0.8  # the world actually maps
    assert (got[2::6] == -1).any()     # and placeholders are compared too


@pytest.mark.parametrize("world", ["corpus_small", "prefixes_k13w5"])
def test_host_mirror_equals_plain_on_voted(world, request):
    idx, enc, L = request.getfixturevalue(world)
    got = _port_seeds(idx, _pad_matrix(enc, L), L)
    host = host_seed_topn([e[:L] for e in enc], idx, L)
    nf = len(tseed.SEED_FIELDS)
    dev = {f: np.stack([got[c * nf + i] for c in range(tseed.NCAND)], axis=1)
           for i, f in enumerate(tseed.SEED_FIELDS)}
    voted = dev["votes"] > 0
    for f in tseed.SEED_FIELDS:
        np.testing.assert_array_equal(host[f][voted], dev[f].astype(np.int64)[voted],
                                      err_msg=f)
    np.testing.assert_array_equal(host["votes"] > 0, voted)


def test_minimizer_stage_equals_jax_with_ns_and_palindromes():
    rng = np.random.default_rng(3)
    R, L = 6, 512
    mat = rng.integers(0, 4, (R, L)).astype(np.int8)
    mat[0, 100:103] = 4                                   # N's
    mat[1, 50:65] = jencode("ACGTACGTACGTACG")[:15]        # palindromic-ish run
    pal = jencode("AAAAAACGTTTTTT")                        # exact palindrome, k=14
    mat[2, 200:214] = pal
    mat[3, 400:] = 4                                       # padding tail
    mat[4, ::7] = 4
    for k, w in ((15, 10), (13, 5), (14, 3)):
        jc, js, jm = (np.asarray(a) for a in jseed.read_minimizers(mat, k, w))
        tc, ts, tm = tseed.read_minimizers(torch.from_numpy(mat), k, w)
        np.testing.assert_array_equal(tm.numpy(), jm, err_msg=f"is_min k{k} w{w}")
        valid = jm
        np.testing.assert_array_equal(tc.numpy()[valid], jc[valid])
        np.testing.assert_array_equal(ts.numpy()[valid], js[valid])
    # the palindromic 14-mer is never a minimizer
    _, _, tm = tseed.read_minimizers(torch.from_numpy(mat), 14, 3)
    assert not bool(tm[2, 200])
    x = rng.integers(0, 2**31 - 1, 20_000).astype(np.int64)
    x[:4] = [0, 1, 2**30 - 1, 2**31 - 2]
    h_port = tseed.hash31(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(h_port, np.asarray(jseed._hash31(x.astype(np.int32))))


def test_vote_stage_equals_jax():
    rng = np.random.default_rng(8)
    R, n = 64, 256
    keys = rng.integers(-3000, 6000, (R, n))
    keys[:, -40:] = tseed.SENTINEL
    keys[::3, 100:] = tseed.SENTINEL
    keys[5] = rng.integers(-600, 600, n)                  # negative cluster
    keys.sort(axis=1)
    want = np.asarray(jseed._vote(keys.astype(np.int32)))
    got = tseed.vote(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[keys >= tseed.SENTINEL] == -1).all() and (keys < 0).any() and got.max() > 5


def test_lookup_stage_equals_jax(corpus_small):
    idx, _, _ = corpus_small
    rng = np.random.default_rng(4)
    jdi = jseed.DeviceIndex(idx)
    keys = idx.keys.astype(np.int64)
    q = np.concatenate([rng.choice(keys, 3000), rng.integers(0, 2**30, 3000),
                        [0, keys[0], keys[-1], 2**30 - 1]])
    valid = rng.random(q.shape[0]) < 0.9
    jhit, jrank = (np.asarray(a) for a in jseed._lookup_join(
        jdi.keys, q.astype(np.int32), valid))
    thit, trank = tseed.lookup(tseed.DeviceIndex(idx, "cpu").keys, torch.from_numpy(q),
                               torch.from_numpy(valid))
    np.testing.assert_array_equal(thit.numpy(), jhit)
    np.testing.assert_array_equal(trank.numpy(), jrank)
    assert jhit.sum() > 2000


def table_lookup(dev_index, ck: torch.Tensor, valid: torch.Tensor):
    """The seeding kernels' lookup through ``DeviceIndex.bucket_off`` in
    PyTorch: the query's bucket of high bits, then a binary search for the
    first key above it inside the bucket."""
    keys = dev_index.keys.long()
    off = dev_index.bucket_off.long()
    b = (ck >> dev_index.shift).clamp(0, off.shape[0] - 2)
    first, hi = off[b], off[b + 1]
    lo = first
    for _ in range(int((off[1:] - off[:-1]).max()).bit_length()):
        mid = (lo + hi) // 2
        le = keys[mid.clamp_max(keys.shape[0] - 1)] <= ck
        lo, hi = torch.where((lo < hi) & le, mid + 1, lo), torch.where((lo < hi) & ~le, mid, hi)
    rank = (lo - 1).clamp_min(0)
    return valid & (lo > first) & (keys[rank] == ck), rank


@pytest.mark.parametrize("world", ["corpus_small", "prefixes_k13w5", "empty"])
def test_bucket_table_lookup_equals_jax(world, request):
    """The kernels' lookup through ``DeviceIndex.bucket_off`` (a bucket of
    the key's high bits, then a search inside it) gives ``_lookup_join``'s
    hit and rank, on both parity worlds and on an index with no key."""
    if world == "empty":
        idx = build_index(np.zeros(200, np.uint8), np.zeros(200, bool), k=13, w=5)
        assert idx.keys.shape[0] == 0
    else:
        idx = request.getfixturevalue(world)[0]
    rng = np.random.default_rng(6)
    keys = idx.keys.astype(np.int64)
    top = 4 ** idx.k
    q = np.concatenate([rng.choice(keys, 3000) if keys.size else np.zeros(0, np.int64),
                        rng.integers(0, top, 3000), [0, top - 1]])
    if keys.size:
        q = np.concatenate([q, [keys[0], keys[-1], keys[0] - 1, keys[-1] + 1]]).clip(0, top - 1)
    valid = rng.random(q.shape[0]) < 0.9
    jdi = jseed.DeviceIndex(idx)
    jhit, jrank = (np.asarray(a) for a in jseed._lookup_join(
        jdi.keys, q.astype(np.int32), valid))
    di = tseed.DeviceIndex(idx, "cpu")
    assert di.bucket_off.shape[0] - 1 == 1 << (2 * idx.k - di.shift)
    assert int(di.bucket_off[-1]) == di.keys.shape[0]
    # each bucket holds exactly the keys whose high bits name it (the
    # padding key of an empty index in the last bucket)
    nbk = di.bucket_off.shape[0] - 1
    j = torch.repeat_interleave(torch.arange(nbk), di.bucket_off[1:] - di.bucket_off[:-1])
    assert torch.equal(j, (di.keys.long() >> di.shift).clamp_max(nbk - 1))
    thit, trank = table_lookup(di, torch.from_numpy(q), torch.from_numpy(valid))
    np.testing.assert_array_equal(thit.numpy(), jhit)
    np.testing.assert_array_equal(trank.numpy(), jrank)
    assert (jhit.sum() > 2000) == bool(keys.size)


@pytest.fixture(scope="module")
def worlds():
    """test_aligner.py's two-contig world and test_multi_align.py's repeat
    world, each with its reads (the repeat world's include chimeras and
    repeat reads, so multi-record reads occur)."""
    rng = np.random.default_rng(5)
    genome = random_genome(rng, {"gA": 180_000, "gB": 120_000})
    reads = {r.rid: r.seq for r in simulate_reads(rng, genome, 150, mean_len=5000.0)}
    out = {"world": (build_layout(genome), reads)}
    rng = np.random.default_rng(11)
    g2 = random_genome(rng, {"gA": 120_000, "gB": 120_000})
    g2["gB"] = g2["gB"][:20_000] + g2["gA"][40_000:52_000] + g2["gB"][32_000:]
    noisy = lambda s: _simulate_alignment(rng, s)[0]  # noqa: E731
    r2 = {f"rep{j}": noisy(g2["gA"][s: s + 3000]) for j, s in enumerate(range(42_000, 49_000, 1000))}
    r2.update({f"u{j}": noisy(g2["gA"][s: s + 2500]) for j, s in enumerate(range(60_000, 90_000, 5000))})
    r2["chimera"] = noisy(g2["gA"][10_000:13_000]) + noisy(g2["gB"][60_000:63_000])
    r2["none"] = "ACGT" * 150
    out["repeat_world"] = (build_layout(g2), r2)
    return out


def _same_records(a, b, what):
    assert len(a) == len(b), what
    assert list(a.qname) == list(b.qname) and list(a.tname) == list(b.tname), what
    for f in PAF_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, (what, f)
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {f}")
    for x, y in zip(a.cigars, b.cigars):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y, err_msg=f"{what} cigar")


@pytest.mark.parametrize("name", ["world", "repeat_world"])
def test_records_equal_jax_and_host_seeded(worlds, name):
    lay, seqs = worlds[name]
    jax_al = TpuAligner(lay)
    port = tal.make_aligner(lay, device="cpu")
    host = tal.make_aligner(lay, device="cpu", backend="host")
    assert type(port) is tal.TorchAligner and type(host) is CpuAligner
    n_rec = {}
    for kw in (dict(trunc=True), dict(), dict(all_records=True)):
        want = jax_al.map_sequences(seqs, **kw)
        _same_records(port.map_sequences(seqs, **kw), want, f"{name} port {kw}")
        _same_records(host.map_sequences(seqs, **kw), want, f"{name} host {kw}")
        n_rec[str(kw)] = len(want)
    assert n_rec["{}"] > 0
    if name == "repeat_world":
        assert n_rec["{'all_records': True}"] > n_rec["{}"]  # secondaries exist


def test_empty_cigars_give_empty_records(worlds, monkeypatch):
    """F1: when every CIGAR of a bucket comes back empty the record
    assembly returns no records (the JAX assembly indexes an empty array)."""
    lay, seqs = worlds["world"]
    al = tal.TorchAligner(lay, device="cpu")
    assert len(al.map_sequences(seqs, trunc=True)) > 0

    def empty_cigars(q_cat, q_off, target, ws, we, pad, half, threads=8, cigar_cap=4096):
        n = int(q_off.shape[0] - 1)
        return (np.zeros(n, np.int32), np.zeros(n, np.int64), np.zeros(n, np.int64),
                [np.zeros(0, np.uint32) for _ in range(n)])

    monkeypatch.setattr(tnative, "align_batch", empty_cigars)
    for kw in (dict(trunc=True), dict(all_records=True)):
        rec = al.map_sequences(seqs, **kw)
        assert len(rec) == 0 and rec.cigars == []


def test_reads_past_4096_cigar_runs_map():
    """A read of 60-80 kb at ONT error rates needs more than 4,096 CIGAR
    runs; the port's DP sizes its buffer to the query and maps it whole
    (the JAX package's fixed 4,096 runs drop it)."""
    rng = np.random.default_rng(6)
    genome = random_genome(rng, {"g": 200_000})
    lay = build_layout(genome)
    seqs = {f"r{n}": _simulate_alignment(rng, genome["g"][5_000: 5_000 + n])[0]
            for n in (60_000, 80_000)}
    port = tal.TorchAligner(lay, k=13, w=5, min_votes=3, device="cpu")
    rec = port.map_sequences(seqs)
    _same_records(rec, CpuAligner(lay, k=13, w=5, min_votes=3).map_sequences(seqs), "long")
    assert sorted(rec.qname) == ["r60000", "r80000"]
    assert max(c.size for c in rec.cigars) > 4096
    for q0, q1, n in zip(rec.qstart, rec.qend, rec.qlen):
        assert q1 - q0 > 0.99 * n


def test_long_reads_cut_to_last_bucket_and_empty_index(worlds):
    """Reads beyond 32768 bases seed on their first 32768 (the last
    bucket) in both seeding paths; an index with no minimizer maps nothing."""
    lay, _ = worlds["world"]
    rng = np.random.default_rng(2)
    g = "".join(np.array(list("ACGT"))[lay.seq_int[lay.offsets[0]: lay.offsets[0] + 60_000]])
    seqs = {"long": _simulate_alignment(rng, g[5_000:45_000])[0], "short": g[100:900]}
    assert len(seqs["long"]) > JAX_BUCKETS[-1]
    port = tal.TorchAligner(lay, device="cpu")
    host = CpuAligner(lay)
    _same_records(port.map_sequences(seqs), host.map_sequences(seqs), "long reads")
    rec = port.map_sequences(seqs)
    assert "long" in set(rec.qname)
    tiny = build_layout({"t": "ACGTACGTAC"}, min_len=1)  # shorter than k
    empty = tal.TorchAligner(tiny, device="cpu")
    assert empty.index.keys.shape[0] == 0
    assert len(empty.map_sequences(seqs)) == 0
    with pytest.raises(ValueError, match="backend"):
        tal.make_aligner(lay, device="cpu", backend="tpu")
