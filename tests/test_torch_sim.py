"""The port's simulation mode (bossruns_torch.models.runs_sim) on the CPU.

* the port's BossRunsSim against the JAX BossRunsSim: same corpus, seed and
  batches -> equal coverage, decisions, pseudotime and masks, batch by batch;
* the port's gated flow == its classic flow, exactly (test_gated_sim.py);
* enrichment: BOSS sequences the rare contig's share up and saves
  pseudotime (test_enrichment.py);
* the masks npz layout of the verify recipe, checkpoints and resume.
"""
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bossruns_tpu.io.paf import parse_paf
from bossruns_tpu.models import runs as jruns
from bossruns_tpu.models.runs_sim import BossRunsSim as JaxSim
from bossruns_tpu.utils import checkpoint as jckpt
from bossruns_tpu.utils.datagen import write_corpus
from bossruns_tpu.utils.misc import read_strategy_npz
from bossruns_torch.models.convert import state_to_numpy
from bossruns_torch.models.runs_sim import BossRunsSim, SimOutcome, decision_tally
from bossruns_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)


def _sim(cls, corpus, tmp_path, name, **kw):
    return cls(ref=corpus["ref"], fq=corpus["fq"], paf_full=corpus["paf_full"],
               paf_trunc=corpus["paf_trunc"], name=name, batchsize=200, maxb=5,
               out_base=tmp_path / name, **kw)


def test_port_sim_matches_jax_sim(corpus, tmp_path):
    j = _sim(JaxSim, corpus, tmp_path, "jax")
    t = _sim(BossRunsSim, corpus, tmp_path, "port", device="cpu")
    assert j._gated and t._gated
    for step in range(5):
        j.process_batch()
        t.process_batch()
        got = state_to_numpy(t.state)
        for k in ("coverage", "zeroed", "bucket_on", "read_starts", "strat"):
            np.testing.assert_array_equal(got[k], np.asarray(getattr(j.state, k)),
                                          err_msg=f"{k} step {step}")
        assert t._last_decisions == j._last_decisions, step
        assert (t.read_cache.time_boss, t.read_cache.time_control) == (
            j.read_cache.time_boss, j.read_cache.time_control), step
        mj = read_strategy_npz(j.out_dir / "masks" / "boss.npz")
        mt = read_strategy_npz(t.out_dir / "masks" / "boss.npz")
        assert set(mj) == set(mt)
        for name in mj:
            np.testing.assert_array_equal(mt[name], mj[name], err_msg=f"{name} step {step}")
    assert bool(t.state.bucket_on.any())
    t.cleanup()


@pytest.mark.parametrize("quirks", [False, True])
def test_port_gated_matches_classic(corpus, tmp_path, quirks):
    a = _sim(BossRunsSim, corpus, tmp_path, f"c{int(quirks)}", gated=False,
             reference_quirks=quirks, device="cpu")
    b = _sim(BossRunsSim, corpus, tmp_path, f"g{int(quirks)}", gated=True,
             reference_quirks=quirks, device="cpu")
    for step in range(5):
        a.process_batch()
        b.process_batch()
        for k in ("coverage", "zeroed", "bucket_on", "read_starts", "strat"):
            assert torch.equal(getattr(a.state, k), getattr(b.state, k)), (k, step)
        assert a.read_cache.time_boss == b.read_cache.time_boss, step
        assert a.read_cache.time_control == b.read_cache.time_control, step
        assert a._last_decisions == b._last_decisions, step
    for name in a.strat_host:
        np.testing.assert_array_equal(a.strat_host[name], b.strat_host[name])
    a.cleanup()
    b.cleanup()


@pytest.mark.parametrize("accept_unmapped", [False, True])
def test_decision_tally_on_a_hand_made_batch(accept_unmapped):
    """The sims' one accept/reject tally against its bookkeeping written out:
    mapped reads in decision order (r3 accepted with a full record, r0
    rejected though it has one, r4 accepted in its prefix with none), then
    the unmapped ones in batch order (r1 with a full record, r2 and r5
    without)."""
    seqs = {f"r{i}": "ACGTTGCA" * (i + 1) for i in range(6)}
    decisions = {"r3": True, "r0": False, "r4": True}
    best_full = {"r3": 2, "r1": 0, "r0": 1}
    best_trunc = {"r3": 5, "r0": 4, "r4": 3}
    full = SimpleNamespace(qlen=np.array([100, 200, 300], np.int64))
    out = decision_tally(seqs, decisions, best_full, best_trunc, full, 6, accept_unmapped)
    cut = lambda *rids: dict(seqs, **{r: seqs[r][:6] for r in rids})  # noqa: E731
    if accept_unmapped:
        want = SimOutcome(n_mapped=3, n_unmapped=3, n_accepted=5, n_rejected=1,
                          reads_decision=cut("r0"),
                          cov_rows=[("full", 2), ("trunc", 4), ("full", 0)],
                          acc_rows=[2, 0], accepted_lengths=[300, 100],
                          accepted=["r3", "r4", "r1", "r2", "r5"])
    else:
        want = SimOutcome(n_mapped=3, n_unmapped=3, n_accepted=2, n_rejected=4,
                          reads_decision=cut("r0", "r1", "r2", "r5"),
                          cov_rows=[("full", 2), ("trunc", 4)],
                          acc_rows=[2], accepted_lengths=[300], accepted=["r3", "r4"])
    assert out == want
    assert list(out.reads_decision) == list(seqs)


def test_port_boss_enriches_rare_contig(tmp_path):
    paths = write_corpus(
        tmp_path / "data", rng=np.random.default_rng(99),
        contig_lengths={"abundant": 150_000, "rare": 150_000}, n_reads=2600,
        mean_len=5000.0, abundance={"abundant": 5.0, "rare": 1.0},
    )
    with open(paths["paf_full"]) as fh:
        rec = parse_paf(fh.read())
    origin = {rec.qname[i]: rec.tname[i] for i in range(len(rec))}
    sim = BossRunsSim(ref=paths["ref"], fq=paths["fq"], paf_full=paths["paf_full"],
                      paf_trunc=paths["paf_trunc"], name="enrich", batchsize=160, maxb=15,
                      out_base=tmp_path, device="cpu")
    control = {"abundant": 0, "rare": 0}
    boss = {"abundant": 0, "rare": 0}
    for _ in range(15):
        sim.process_batch()
        for rid, seq in sim.sampler.fq_stream.read_sequences.items():
            if origin.get(rid):
                control[origin[rid]] += len(seq)
        for rid, seq in sim._last_decisions.items():
            if origin.get(rid):
                boss[origin[rid]] += len(seq)
    assert sim.read_cache.time_boss < sim.read_cache.time_control
    assert bool(sim.state.bucket_on.any())
    share_control = control["rare"] / (control["rare"] + control["abundant"])
    share_boss = boss["rare"] / (boss["rare"] + boss["abundant"])
    assert share_boss > share_control, (share_boss, share_control)
    sd = sim.engine.strat_dict(sim.state)
    assert sd["abundant"].mean() <= sd["rare"].mean()
    sim.cleanup()


def test_port_masks_npz_and_run(corpus, tmp_path):
    sim = BossRunsSim(ref=corpus["ref"], fq=corpus["fq"], paf_full=corpus["paf_full"],
                      paf_trunc=corpus["paf_trunc"], name="t1", batchsize=150, maxb=6,
                      out_base=tmp_path, device="cpu")
    npz = Path(tmp_path) / "out_t1" / "masks" / "boss.npz"
    init = read_strategy_npz(npz)
    assert init["contigA"].shape == (2200, 2, 1) and init["contigA"].all()
    sim.run(6)
    final = read_strategy_npz(npz)
    assert final["contigA"].shape == (2200, 2, 1)
    assert final["contigB"].shape == (1300, 2, 1)
    assert 0 < sim.read_cache.time_boss < sim.read_cache.time_control
    assert (Path(tmp_path) / "00_reads" / "control_0.fa").exists()
    assert (Path(tmp_path) / "out_t1" / "metrics" / "batches.jsonl").exists()
    assert set(sim.phase_p50_ms()) == {"sample", "align", "decide", "coo", "overlap",
                                       "device", "write"}


def test_port_checkpoint_resume(corpus, tmp_path):
    a = _sim(BossRunsSim, corpus, tmp_path, "ck", device="cpu")
    a.checkpoint_every = 2
    for _ in range(2):
        a.process_batch()
    a.cleanup()
    b = _sim(BossRunsSim, corpus, tmp_path, "ck", device="cpu", resume=True)
    assert b.batch == 2
    assert b.read_cache.time_boss == a.read_cache.time_boss
    for k in ("coverage", "zeroed", "bucket_on", "read_starts", "strat"):
        assert torch.equal(getattr(a.state, k), getattr(b.state, k)), k
    np.testing.assert_array_equal(b.rl_dist.hist, a.rl_dist.hist)
    b.process_batch()
    b.cleanup()


def test_checkpoints_interchange_with_jax(rng, tmp_path):
    """The port writes the JAX package's format: each side loads the other's."""
    nb, G, Gd = 1, 1000, 10
    st = dict(
        coverage=rng.integers(0, 60000, (nb, 5, G)).astype(np.uint16),
        zeroed=rng.random((nb, G)) < 0.1, bucket_on=rng.random((nb, 8)) < 0.5,
        read_starts=rng.integers(0, 5, (8, 2)).astype(np.float32),
        strat=rng.random((nb, Gd, 2)) < 0.5,
    )
    jckpt.save_checkpoint(tmp_path / "j", jruns.GenomeState(**st), {"batch": 3},
                          extra_arrays={"rl_hist": np.arange(5)})
    state, host, extra = tckpt.load_checkpoint(tmp_path / "j", "cpu")
    assert host["batch"] == 3
    np.testing.assert_array_equal(extra["rl_hist"], np.arange(5))
    got = state_to_numpy(state)
    for k, v in st.items():
        np.testing.assert_array_equal(got[k], v)
        assert got[k].dtype == v.dtype
    tckpt.save_checkpoint(tmp_path / "t", state, {"batch": 4})
    jstate, jhost, _ = jckpt.load_checkpoint(tmp_path / "t", jruns.GenomeState)
    assert jhost["batch"] == 4
    for k, v in st.items():
        np.testing.assert_array_equal(np.asarray(getattr(jstate, k)), v)


@pytest.mark.parametrize("chunk", [1, 5_000, 1 << 22])
def test_read_dumps_match_jax_byte_for_byte(tmp_path, monkeypatch, chunk):
    """The port's read dumps, written in pieces, hold the bytes the JAX
    package's write a read gives, random ids included, on the same draws;
    a piece of one read, of several and of the whole dump."""
    import random

    from bossruns_tpu.models.runs_sim import ReadCache as JaxCache
    from bossruns_torch.models import runs_sim

    monkeypatch.setattr(runs_sim, "DUMP_CHUNK", chunk)
    rng = np.random.default_rng(11)
    seqs = {f"r{i}": "".join("ACGTN"[c] for c in rng.integers(0, 5, int(n)))
            for i, n in enumerate(rng.integers(1, 3_000, 40))}
    keep = {r: s[:400] for r, s in seqs.items() if len(s) % 3}
    files = {}
    for name, cls in (("jax", JaxCache), ("port", runs_sim.ReadCache)):
        cache = cls(batchsize=40, dumptime=10 ** 12, out_base=tmp_path / name)
        random.seed(7)
        cache.fill(seqs, keep, barcodes={r: i % 3 for i, r in enumerate(seqs)})
        cache.flush()
        files[name] = {p.name: p.read_bytes() for p in sorted(cache.out.iterdir())}
    assert files["port"] == files["jax"]
    assert files["port"]["control_1.fa"].count(b">") == len(seqs)
    assert files["port"]["boss_1.fa"].count(b">") == len(keep)
