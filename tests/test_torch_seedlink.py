"""The seeding link of the port: 4-bit packed reads, staged uploads, and the
strategy's pull after a step, against the JAX package.

* ``pack_reads`` equals the JAX package's byte for byte at every length
  bucket's width, with 0, 1 and 37 rows, N codes and all-pad rows, also
  when it writes into a slice of a larger buffer; ``unpack_reads`` equals
  JAX's decode; a code outside 0..4 and a width that is not a multiple of
  8 raise;
* the host entry points ``seed_and_vote`` and ``seed_candidates_from_numpy``
  on a CPU index equal JAX's ``seed_and_vote`` and ``seed_candidates`` on
  the ``corpus_small`` and ``prefixes_k13w5`` worlds of
  test_torch_aligner.py and one ``ava_world`` bucket of
  test_torch_aeons.py;
* staging, with a stand-in of plain host buffers whose events record when
  they are waited on (the card's pinned buffers and CUDA events need a
  GPU): a buffer is not refilled before the event of its last upload, the
  buckets of one call lie back to back inside its one staged copy, an
  upload of reads that were not packed into staging raises, and
  ``map_sequences`` through staging over five length buckets (also cut
  into calls of 7 rows) gives the records of the unstaged path and of the
  host-seeded ``CpuAligner``, with one staged copy a call;
* the strategy's pull: the sims publish the same masks when
  ``strat_dict`` takes the copy ``strat_to_host_async`` started, and a
  step drops a pending copy.

Every comparison is exact: the payload, seeds, candidates, records and
masks are integers or booleans.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bossruns_tpu.aeons import ava as java
from bossruns_tpu.aligner import seed as jseed
from bossruns_tpu.utils.datagen import random_genome, simulate_reads
from bossruns_tpu.utils.misc import read_strategy_npz
from bossruns_torch import aligner as tal
from bossruns_torch.aligner import seed as tseed
from bossruns_torch.aligner.cpu_baseline import CpuAligner
from bossruns_torch.models import runs as truns
from bossruns_torch.models.convert import batch_from_numpy
from bossruns_torch.models.layout import build_layout
from bossruns_torch.models.runs_sim import BossRunsSim
from bossruns_torch.utils.staging import PinnedCopy
from test_engine_parity import _random_batch
from test_torch_aeons import ava_world  # noqa: F401 (a fixture)
from test_torch_aligner import (_pad_matrix, _same_records, corpus_small,  # noqa: F401
                                prefixes_k13w5)
from test_torch_graph import CCL, HostStaging

torch.set_num_threads(2)


# ------------------------------------------------------------ the payload --

@pytest.mark.parametrize("rows", [0, 1, 37])
@pytest.mark.parametrize("L", tal.LENGTH_BUCKETS)
def test_pack_reads_equals_jax(L, rows):
    rng = np.random.default_rng(L + rows)
    mat = rng.integers(0, 5, (rows, L)).astype(np.int8)   # N codes (4) throughout
    if rows > 2:
        mat[1] = 4                                        # an all-pad row
        mat[2, L // 3:] = 4                               # a padded tail
    want = jseed.pack_reads(mat)
    got = tseed.pack_reads(mat)
    assert got.dtype == want.dtype == np.uint32 and got.shape == want.shape == (rows, L // 8)
    assert got.tobytes() == want.tobytes()
    n = rows * L // 8
    buf = np.zeros(n + 5, np.uint32)
    out = buf[3: 3 + n].reshape(rows, L // 8)
    assert tseed.pack_reads(mat, out=out) is out
    assert out.tobytes() == want.tobytes() and not buf[:3].any() and not buf[3 + n:].any()


@pytest.mark.parametrize("L", [512, 32768])
def test_pack_rows_equals_jax_of_the_padded_matrix(L):
    """Rows of a flat code array, cut or padded to L (empty, odd, exact and
    over-long rows), pack as JAX packs their padded matrix."""
    rng = np.random.default_rng(L)
    lens = rng.integers(0, L + 20, 37)
    lens[:5] = (0, L, L + 100, 7, 9)
    start = np.concatenate([[0], np.cumsum(lens)[:-1]])
    codes = rng.integers(0, 5, int(lens.sum())).astype(np.int8)
    mat = np.full((37, L), 4, np.int8)
    for r in range(37):
        n = min(int(lens[r]), L)
        mat[r, :n] = codes[start[r]: start[r] + n]
    out = np.empty((37, L // 8), np.uint32)
    assert tseed.pack_rows(codes, start, lens, L, out) is out
    assert out.tobytes() == jseed.pack_reads(mat).tobytes()


@pytest.mark.parametrize("L", [512, 8192])
def test_unpack_reads_equals_jax(L):
    mat = np.random.default_rng(L).integers(0, 5, (19, L)).astype(np.int8)
    packed = jseed.pack_reads(mat)
    want = np.asarray(jseed.unpack_reads(jnp.asarray(packed), L))
    got = tseed.unpack_reads(torch.from_numpy(packed.view(np.int32)), L)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), mat)


@pytest.mark.parametrize("case", ["code5", "negative", "width12", "int64_code9"])
def test_pack_reads_raises(case):
    mat = np.zeros((3, 16), np.int8)
    if case == "code5":
        mat[1, 7] = 5
    elif case == "negative":
        mat[2, 0] = -1
    elif case == "width12":
        mat = np.zeros((3, 12), np.int8)
    else:
        mat = np.zeros((3, 16), np.int64)
        mat[0, 3] = 9
    with pytest.raises(ValueError):
        tseed.pack_reads(mat)


# --------------------------------------------------------- host entries --

@pytest.mark.parametrize("world", ["corpus_small", "prefixes_k13w5"])
def test_seed_and_vote_equals_jax(world, request):
    idx, enc, L = request.getfixturevalue(world)
    mat = _pad_matrix(enc, L)
    want = jseed.seed_and_vote(mat, jseed.DeviceIndex(idx))
    got = tseed.seed_and_vote(mat, tseed.DeviceIndex(idx, "cpu"))
    assert got.keys() == want.keys() == set(tseed.SEED_FIELDS)
    for f in tseed.SEED_FIELDS:
        assert got[f].shape == want[f].shape == (mat.shape[0], tseed.NCAND), f
        np.testing.assert_array_equal(got[f], np.asarray(want[f]), err_msg=f)
    assert (got["votes"][:, 0] >= 3).mean() > 0.8


def _check_candidates(mat, idx, tol=None):
    want = jseed.seed_candidates(mat, jseed.DeviceIndex(idx), ncand=4, tol=tol)
    got = tseed.seed_candidates_from_numpy(mat, tseed.DeviceIndex(idx, "cpu"), ncand=4, tol=tol)
    assert got.keys() == want.keys() == set(tseed.CAND_FIELDS)
    for f in tseed.CAND_FIELDS:
        assert got[f].shape == (mat.shape[0], 8), f
        np.testing.assert_array_equal(got[f], np.asarray(want[f]), err_msg=f)
    return got


@pytest.mark.parametrize("world", ["corpus_small", "prefixes_k13w5"])
def test_seed_candidates_from_numpy_equals_jax(world, request):
    idx, enc, L = request.getfixturevalue(world)
    got = _check_candidates(_pad_matrix(enc, L), idx)
    assert (got["votes"] > 0).any(axis=1).mean() > 0.8


def test_seed_candidates_from_numpy_equals_jax_ava(ava_world):  # noqa: F811
    _, pool, queries, _ = ava_world
    pidx = java.PoolIndex(pool)
    mat = _pad_matrix([tal.encode(s) for s in queries.values()], 8192)
    got = _check_candidates(mat, pidx.host, tol=tseed.candidate_tol(8192))
    assert (got["votes"] >= 4).any(axis=1).mean() > 0.8


# ------------------------------------------------------------- staging --

class _Event:
    """A stand-in CUDA event: counts its records and, at each wait, how
    many it had."""

    def __init__(self):
        self.records, self.waits = 0, []

    def record(self):
        self.records += 1

    def synchronize(self):
        self.waits.append(self.records)


class SpyStaging(HostStaging):
    """Plain host buffers (``HostStaging``) with stand-in events, whose
    uploads record their address ranges."""

    def __init__(self):
        super().__init__()
        self.events, self.spans = [], []

    def _new_event(self):
        self.events.append(_Event())
        return self.events[-1]

    def upload(self, wire, dst):
        ok = super().upload(wire, dst)
        self.spans.append((wire.ctypes.data, wire.ctypes.data + wire.nbytes, ok))
        return ok


def _bucket_mats(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 5, (r, L)).astype(np.int8)
            for r, L in ((5, 512), (3, 1024), (4, 2048), (2, 4096))]


def test_staging_waits_for_a_buffers_last_upload_only(prefixes_k13w5):  # noqa: F811
    idx, _, _ = prefixes_k13w5
    di = tseed.DeviceIndex(idx, "cpu")
    di.staging = st = SpyStaging()
    mats = _bucket_mats()
    for m, x in zip(mats, tseed.upload_reads(mats, di)):      # buffer 0
        np.testing.assert_array_equal(x.numpy().view(np.uint32), jseed.pack_reads(m))
    tseed.upload_reads(mats, di)                              # buffer 1
    tseed.upload_reads(mats, di)                              # buffer 0 again
    ev0, ev1 = st.events                                      # one event a buffer
    # buffer 0 was refilled only after the event of its upload fired (it
    # had been recorded once then); buffer 1's copy is not waited for
    assert ev0.waits == [1] and ev1.waits == [] and ev0.records == 2 == 2 * ev1.records


def test_buckets_lie_at_offsets_that_do_not_overlap(prefixes_k13w5):  # noqa: F811
    idx, _, _ = prefixes_k13w5
    di = tseed.DeviceIndex(idx, "cpu")
    di.staging = st = SpyStaging()
    mats = _bucket_mats(1)
    got = tseed.upload_reads(mats, di)
    (span,) = st.spans                                        # one copy for the call
    assert span[2] and span[1] - span[0] == sum(m.size // 2 for m in mats)
    # each bucket a view of the one copy's tensor, back to back over all of it
    assert len({x.untyped_storage().data_ptr() for x in got}) == 1
    views = sorted((x.data_ptr(), x.data_ptr() + 4 * x.numel()) for x in got)
    assert views[-1][1] - views[0][0] == span[1] - span[0]
    assert all(a[1] == b[0] for a, b in zip(views, views[1:]))
    for m, x in zip(mats, got):
        np.testing.assert_array_equal(tseed.unpack_reads(x, m.shape[1]).numpy(), m)


def test_upload_not_from_staging_raises(prefixes_k13w5):  # noqa: F811
    idx, _, _ = prefixes_k13w5
    di = tseed.DeviceIndex(idx, "cpu")
    di.staging = SpyStaging()
    with pytest.raises(ValueError, match="staging"):
        tseed.put_packed(tseed.pack_reads(_bucket_mats()[0]), di)


@pytest.mark.parametrize("rows_cap", [None, 7])
def test_map_sequences_through_staging_over_five_buckets(rows_cap, monkeypatch):
    """The live-alignment sim's full reads (mean 2,500, sd 1,200) fill five
    length buckets; staged, unstaged and host-seeded records agree, also
    when every bucket is cut into calls of 7 rows (``rows_cap``: the staged
    and host-seeded aligners only, against the unstaged one's records)."""
    rng = np.random.default_rng(21)
    genome = random_genome(rng, {"gA": 120_000, "gB": 90_000})
    seqs = {r.rid: r.seq for r in simulate_reads(rng, genome, 160, mean_len=2500.0,
                                                 sd_len=1200.0)}
    assert len({tal.bucket_of(len(s)) for s in seqs.values()}) >= 4
    lay = build_layout({k: tal.encode(v).astype(np.uint8) for k, v in genome.items()})
    staged = tal.TorchAligner(lay, k=13, w=5, min_votes=3, device="cpu")
    staged.dev_index.staging = st = SpyStaging()
    plain = tal.TorchAligner(lay, k=13, w=5, min_votes=3, device="cpu")
    host = CpuAligner(lay, k=13, w=5, min_votes=3)
    rows = dict(tal.BUCKET_ROWS)
    for kw in (dict(trunc=True), dict(), dict(all_records=True)):
        n = len(st.spans)
        want = plain.map_sequences(seqs, **kw)
        if rows_cap:
            monkeypatch.setattr(tal, "BUCKET_ROWS", {L: rows_cap for L in rows})
        _same_records(staged.map_sequences(seqs, **kw), want, f"staged {kw}")
        _same_records(host.map_sequences(seqs, **kw), want, f"host {kw}")
        monkeypatch.setattr(tal, "BUCKET_ROWS", rows)
        assert len(st.spans) == n + 1 and st.spans[-1][2]     # one staged copy a call
        if not kw.get("trunc"):
            assert len(want) > 60


# ------------------------------------------------------ strategy's pull --

class HostCopy(PinnedCopy):
    """Stand-in for PinnedCopy on the CPU: a plain buffer, no event; counts
    the copies ``strat_dict`` took."""

    def __init__(self):
        super().__init__()
        self.taken = 0

    @staticmethod
    def _buffer(shape, dtype):
        return torch.empty(shape, dtype=dtype)

    @staticmethod
    def _new_event():
        return None

    def take(self, t):
        out = super().take(t)
        self.taken += out is not None
        return out


@pytest.mark.parametrize("gated", [True, False])
def test_sims_publish_the_same_masks_through_the_strategy_pull(corpus, tmp_path, gated):
    sims = [BossRunsSim(ref=corpus["ref"], fq=corpus["fq"], paf_full=corpus["paf_full"],
                        paf_trunc=corpus["paf_trunc"], name=name, batchsize=200, maxb=5,
                        out_base=tmp_path / name, gated=gated, device="cpu")
            for name in ("plain", "pulled")]
    sims[1].engine._strat_pull = pull = HostCopy()
    for step in range(5):
        for s in sims:
            s.process_batch()
        a, b = (read_strategy_npz(s.out_dir / "masks" / "boss.npz") for s in sims)
        assert a.keys() == b.keys()
        for name in a:
            np.testing.assert_array_equal(b[name], a[name], err_msg=f"{name} step {step}")
    assert pull.taken >= 1 and bool(sims[1].state.bucket_on.any())
    for s in sims:
        s.cleanup()


@pytest.mark.parametrize("path", ["step", "eager"])
def test_a_step_drops_a_pending_strategy_copy(path):
    rng = np.random.default_rng(4)
    lay = build_layout({"a": rng.integers(0, 4, 150_000).astype(np.uint8)})
    eng = truns.RunsEngine(lay, device="cpu")
    eng._strat_pull = pull = HostCopy()
    state, params = eng.init_state(), eng.make_params(CCL, 5300.0)
    eng.strat_to_host_async(state)
    batch = batch_from_numpy(_random_batch(rng, lay, n_obs=20_000), "cpu")
    step = eng.step if path == "step" else lambda *a: eng.eager("step", *a)
    state, _ = step(state, batch, params)
    assert pull.take(state.strat) is None                  # dropped by the step
    eng._strat_pull = None
    want = eng.strat_dict(state)                           # pulled
    eng._strat_pull = pull
    eng.strat_to_host_async(state)
    got = eng.strat_dict(state)
    assert pull.taken == 1
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
