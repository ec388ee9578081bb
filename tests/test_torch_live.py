"""The port's live-alignment paths against the JAX package's, on the CPU.

* ``BossRunsSim`` without precomputed PAFs (classic flow, two-phase live
  alignment): coverage, zeroed, bucket_on, read_starts, strat and masks
  exact, decisions and pseudotime equal to the JAX sim batch by batch;
* the live ``BossRuns`` over fastq files in a fake sequencer's directory,
  and its checkpoint/resume: masks and coverage equal to the JAX
  ``BossRuns`` on the same files (twins of test_live.py);
* the readfish hot loop with ``TorchMapperPlugin``: the same decisions as
  with the JAX ``TpuMapperPlugin`` (twin of test_multi_align.py).
"""
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from bossruns_tpu.config import BossConfig
from bossruns_tpu.live.conf import RFConf
from bossruns_tpu.live.mapper import TpuMapperPlugin
from bossruns_tpu.live.readfish_boss import Analysis
from bossruns_tpu.live.sequencer import Sequencer
from bossruns_tpu.models.experiment import BossRuns as JaxBossRuns
from bossruns_tpu.models.runs_sim import BossRunsSim as JaxSim
from bossruns_tpu.utils.datagen import _simulate_alignment, random_genome
from bossruns_tpu.utils.misc import read_strategy_npz, write_strategy_npz
from bossruns_torch.live.mapper import TorchMapperPlugin
from bossruns_torch.models.convert import state_to_numpy
from bossruns_torch.models.experiment import BossRuns
from bossruns_torch.models.runs_sim import BossRunsSim
from tests.test_readfish_loop import RF_TOML, FakeCaller, FakeClient, Result

torch.set_num_threads(2)

STATE = ("coverage", "zeroed", "bucket_on", "read_starts", "strat")


def _same_masks(a: Path, b: Path, what):
    ma, mb = read_strategy_npz(a / "masks" / "boss.npz"), read_strategy_npz(b / "masks" / "boss.npz")
    assert set(ma) == set(mb), what
    for name in ma:
        np.testing.assert_array_equal(ma[name], mb[name], err_msg=f"{what} {name}")


def test_live_alignment_sim_matches_jax(corpus, tmp_path):
    kw = dict(ref=corpus["ref"], fq=corpus["fq"], batchsize=200, maxb=4)
    j = JaxSim(name="j", out_base=tmp_path / "j", **kw)
    t = BossRunsSim(name="t", out_base=tmp_path / "t", device="cpu", **kw)
    assert t.aligner is not None and t._gated is False and j._gated is False
    assert (t.aligner.index.k, t.aligner.index.w, t.aligner.min_votes) == (13, 5, 3)
    for step in range(4):
        j.process_batch()
        t.process_batch()
        got = state_to_numpy(t.state)
        for k in STATE:
            np.testing.assert_array_equal(got[k], np.asarray(getattr(j.state, k)),
                                          err_msg=f"{k} step {step}")
        assert t._last_decisions == j._last_decisions, step
        assert (t.read_cache.time_boss, t.read_cache.time_control) == (
            j.read_cache.time_boss, j.read_cache.time_control), step
        _same_masks(t.out_dir, j.out_dir, f"step {step}")
    assert bool(t.state.bucket_on.any())
    assert t.phase_p50_ms()["align"] > 0
    t.cleanup()


def test_live_alignment_sim_refuses_gated(corpus, tmp_path):
    with pytest.raises(ValueError, match="gated"):
        BossRunsSim(ref=corpus["ref"], fq=corpus["fq"], name="g", batchsize=100,
                    out_base=tmp_path, gated=True, device="cpu")


def _live_dir(corpus, tmp_path):
    fqdir = tmp_path / "run" / "fastq_pass"
    fqdir.mkdir(parents=True)
    lines = Path(corpus["fq"]).read_text().splitlines(keepends=True)
    half = len(lines) // 8 // 4 * 4
    return fqdir, lines, half


def _args(corpus, name):
    args = BossConfig()
    args.general.name = name
    args.general.ref = corpus["ref"]
    args.general.wait = 1
    return args


def test_live_runs_loop_matches_jax(corpus, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    fqdir, lines, half = _live_dir(corpus, tmp_path)
    (fqdir / "batch1.fq").write_text("".join(lines[:half]))
    args = _args(corpus, "livetest")
    jexp = JaxBossRuns(args, out_base=tmp_path / "jax")
    texp = BossRuns(args, out_base=tmp_path / "port", device="cpu")
    assert type(texp.mapper).__name__ == "TorchAligner"
    seq = Sequencer(out_path=str(tmp_path / "run"))
    for exp in (jexp, texp):
        exp.fq_dir = str(fqdir)
        exp.channels = seq.channels

    def step_both():
        jexp.process_batch()
        texp.process_batch()
        got = state_to_numpy(texp.state)
        for k in STATE:
            np.testing.assert_array_equal(got[k], np.asarray(getattr(jexp.state, k)), err_msg=k)
        _same_masks(texp.out_dir, jexp.out_dir, f"batch {texp.batch}")

    step_both()
    assert texp.batch == 1 and int(texp.state.coverage.to(torch.int32).sum()) > 0
    assert texp.process_batch() == args.general.wait  # no new files: deferred
    (fqdir / "batch2.fq").write_text("".join(lines[half: 2 * half]))
    step_both()
    assert texp.batch == 2
    assert (tmp_path / "port" / "out_livetest" / "masks" / "boss.npz").exists()


def test_live_checkpoint_resume_matches_jax(corpus, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    fqdir, lines, half = _live_dir(corpus, tmp_path)
    (fqdir / "batch1.fq").write_text("".join(lines[:half]))
    args = _args(corpus, "ckpt")
    exps = {}
    for key, cls, kw in (("jax", JaxBossRuns, {}), ("port", BossRuns, {"device": "cpu"})):
        exp = cls(args, out_base=tmp_path / key, **kw)
        exp.checkpoint_every = 1
        exp.fq_dir = str(fqdir)
        exp.channels = set()
        exp.process_batch()
        exps[key] = exp
    assert (tmp_path / "port" / "out_ckpt" / "checkpoint" / "state.npz").exists()
    cov_before = int(exps["port"].state.coverage.to(torch.int64).sum())
    assert cov_before == int(np.asarray(exps["jax"].state.coverage).astype(np.int64).sum())

    # "crash" and restart with resume: same state, the file is not re-processed
    args.optional.resume = True
    exp2 = BossRuns(args, out_base=tmp_path / "port", device="cpu")
    exp2.fq_dir = str(fqdir)
    exp2.channels = set()
    assert exp2.batch == 1
    assert exp2.processed_files == {str(fqdir / "batch1.fq")}
    for k in STATE:
        assert torch.equal(getattr(exp2.state, k), getattr(exps["port"].state, k)), k
    assert exp2.process_batch() == args.general.wait
    assert int(exp2.state.coverage.to(torch.int64).sum()) == cov_before


def _noisy(rng, s):
    return _simulate_alignment(rng, s)[0]


def test_readfish_hot_loop_with_torch_mapper(tmp_path, monkeypatch):
    """Analysis.run with the port's mapper plugin makes the same decisions
    as with the JAX plugin on the repeat world of test_multi_align.py."""
    rng = np.random.default_rng(11)
    genome = random_genome(rng, {"gA": 120_000, "gB": 120_000})
    genome["gB"] = genome["gB"][:20_000] + genome["gA"][40_000:52_000] + genome["gB"][32_000:]
    fasta = tmp_path / "ref.fa"
    fasta.write_text("".join(f">{n}\n{s}\n" for n, s in genome.items()))
    reads = [
        (1, "on_gA", _noisy(rng, genome["gA"][60_000: 60_800])),
        (2, "on_gB", _noisy(rng, genome["gB"][60_000: 60_800])),
        (3, "rep", _noisy(rng, genome["gA"][44_000: 44_800])),
        (4, "nomap", "ACGT" * 150),
    ]
    masks = {
        "gA": np.ones((len(genome["gA"]) // 100 + 1, 2), bool),
        "gB": np.zeros((len(genome["gB"]) // 100 + 1, 2), bool),
    }
    outcome = {}
    for key, plugin in (("jax", TpuMapperPlugin(str(fasta))),
                        ("port", TorchMapperPlugin(str(fasta), device="cpu"))):
        run_dir = tmp_path / key
        run_dir.mkdir()
        monkeypatch.chdir(run_dir)
        (run_dir / "rf.toml").write_text(RF_TOML)
        conf = RFConf.from_file(run_dir / "rf.toml", channel_count=64)
        write_strategy_npz(run_dir / "out_runs", masks)
        batch = lambda: [Result(ch, rid, seq=s) for ch, rid, s in reads]  # noqa: E731
        client = FakeClient([batch(), batch()], channel_count=64, run_dir=run_dir)
        worker = Analysis(client, conf=conf, logger=logging.getLogger("t"),
                          caller=FakeCaller(), mapper=plugin, throttle=0.0, out_base=run_dir)
        worker.run(max_iterations=2)
        outcome[key] = (dict(worker.loop_statistics.decision_counts),
                        sorted(client.unblocked), sorted(client.stopped))
    assert outcome["port"] == outcome["jax"]
    counts, unblocked, stopped = outcome["port"]
    assert counts.get("multi_on", 0) >= 1 and counts.get("no_map", 0) >= 1
    assert (2, "on_gB") in unblocked and (1, "on_gA") in stopped
    assert "TorchMapperPlugin" in TorchMapperPlugin(str(fasta), device="cpu").describe([])


def test_torch_mapper_defaults_to_the_card(tmp_path):
    """Without a device the plugin asks for the CUDA card: no silent CPU."""
    fasta = tmp_path / "t.fa"
    fasta.write_text(">t\n" + "ACGT" * 300 + "\n")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchMapperPlugin(str(fasta))
    assert not TorchMapperPlugin().initialised
