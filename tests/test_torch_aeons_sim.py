"""The AEONS path of the port as a whole against the JAX package, on the CPU.

* ``BossAeonsSim(device="cpu")`` and the JAX ``BossAeonsSim`` on
  test_aeons.py's end-to-end corpus (100 kb, 1300 reads, batch 140, binit
  4) for 3 batches: identical contigs, strategy masks, accept/reject/
  unmapped counts and pseudotimes, thresholds equal to rel 1e-12;
* a checkpoint written by either package resumes in the other, and the run
  then matches an uninterrupted JAX run;
* the live ``BossAeons.process_batch`` over two fastq files matches JAX's;
* ``python -m bossruns_torch --toml aeons.toml --device cpu`` runs an AEONS
  simulation in a subprocess in which ``jax`` cannot be imported.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bossruns_tpu.aeons.simulation import BossAeonsSim as JaxSim
from bossruns_tpu.config import BossConfig
from bossruns_tpu.utils.datagen import write_corpus
from bossruns_torch.aeons.simulation import BossAeonsSim as TorchSim
from test_torch_host import CLI_JAX_BLOCKED, REPO, _toml

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def aeons_corpus(tmp_path_factory):
    out = tmp_path_factory.mktemp("aeons_corpus")
    return write_corpus(out, rng=np.random.default_rng(21), contig_lengths={"gA": 100_000},
                        n_reads=1300, mean_len=5000.0)


def _args(fq, name, maxb=3, resume=False):
    args = BossConfig()
    args.general.name = name
    args.simulation.fq = fq
    args.simulation.batchsize = 140
    args.simulation.maxb = maxb
    args.simulation.binit = 4
    args.optional.min_seq_len = 2500
    args.optional.min_contig_len = 10_000
    args.optional.resume = resume
    return args


def _contigs(exp):
    return {sid: s.seq for sid, s in exp.pool.declare_contigs(10_000).sequences.items()}


def _thresholds(exp):
    path = Path(exp.out_dir) / "metrics" / "batches.jsonl"
    return [json.loads(line)["threshold"] for line in path.read_text().splitlines()]


def _same_state(a, b, what):
    """Contigs (ids are content hashes, so ids too) and strategy masks."""
    assert _contigs(a) == _contigs(b), what
    assert a.strat.keys() == b.strat.keys(), what
    for h in a.strat:
        np.testing.assert_array_equal(a.strat[h], b.strat[h], err_msg=f"{what}: {h}")


def test_aeons_sim_matches_jax(aeons_corpus, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jsim = JaxSim(_args(aeons_corpus["fq"], "jx"), out_base=tmp_path / "jx")
    tsim = TorchSim(_args(aeons_corpus["fq"], "pt"), out_base=tmp_path / "pt", device="cpu")
    _same_state(jsim, tsim, "initial assembly")
    engaged = 0
    for b in range(3):
        jsim.process_batch()
        tsim.process_batch()
        _same_state(jsim, tsim, f"batch {b}")
        counts = (tsim.accept_count, tsim.reject_count, tsim.unmapped_count)
        assert counts == (jsim.accept_count, jsim.reject_count, jsim.unmapped_count), b
        assert (tsim.read_cache.time_boss, tsim.read_cache.time_control) == (
            jsim.read_cache.time_boss, jsim.read_cache.time_control), b
        engaged += tsim.accept_count + tsim.reject_count
    tt, tj = _thresholds(tsim), _thresholds(jsim)
    assert len(tt) == len(tj) == 3
    for a, b in zip(tt, tj):
        assert a == pytest.approx(b, rel=1e-12, abs=0.0)
    assert engaged > 0 and tsim.strat
    assert tsim.read_cache.time_boss <= tsim.read_cache.time_control
    out = tmp_path / "pt" / "out_pt"
    assert (out / "masks" / "boss.npz").exists() and (out / "contigs" / "aeons.fa").exists()


@pytest.mark.parametrize("first,second", [(JaxSim, TorchSim), (TorchSim, JaxSim)],
                         ids=["jax_to_torch", "torch_to_jax"])
def test_aeons_checkpoint_resumes_across_packages(aeons_corpus, tmp_path, monkeypatch,
                                                  first, second):
    """Twin of test_aeons_sim_crash_resume: 2 batches in one package with a
    checkpoint every batch, resume in the other, 2 more batches; the result
    equals 4 uninterrupted batches of the JAX sim."""
    monkeypatch.chdir(tmp_path)
    fq = aeons_corpus["fq"]

    def make(cls, args, base):
        kw = {"device": "cpu"} if cls is TorchSim else {}
        return cls(args, out_base=base, **kw)

    full = make(JaxSim, _args(fq, "ref", maxb=4), tmp_path / "ref")
    full.checkpoint_every = 0
    for _ in range(4):
        full.process_batch()
    sim1 = make(first, _args(fq, "r", maxb=4), tmp_path)
    sim1.checkpoint_every = 1
    for _ in range(2):
        sim1.process_batch()
    at_crash = sim1.batch
    del sim1
    sim2 = make(second, _args(fq, "r", maxb=4, resume=True), tmp_path)
    assert sim2.batch == at_crash
    for _ in range(2):
        sim2.process_batch()
    _same_state(full, sim2, "resumed run")
    assert (sim2.read_cache.time_boss, sim2.read_cache.time_control) == (
        full.read_cache.time_boss, full.read_cache.time_control)


def test_live_process_batch_matches_jax(aeons_corpus, tmp_path, monkeypatch):
    """Live BossAeons: initial assembly from a first fastq file, then one
    process_batch over two new files, in both packages."""
    from bossruns_tpu.aeons.core import BossAeons as JaxAeons
    from bossruns_torch.aeons.core import BossAeons as TorchAeons

    monkeypatch.chdir(tmp_path)
    lines = Path(aeons_corpus["fq"]).read_text().splitlines(keepends=True)
    fqdir = tmp_path / "run" / "fastq_pass"
    fqdir.mkdir(parents=True)
    per = 4 * 140
    (fqdir / "f0.fq").write_text("".join(lines[: 4 * per]))
    exps = []
    for cls, kw, name in ((JaxAeons, {}, "ljx"), (TorchAeons, {"device": "cpu"}, "lpt")):
        args = _args(aeons_corpus["fq"], name)
        args.live.data_wait = 0
        exp = cls(args, out_base=tmp_path / name, **kw)
        exp.fq_dir, exp.channels = str(fqdir), set()
        exp.first_live_asm()
        exps.append(exp)
    _same_state(*exps, "initial live assembly")
    for i in (1, 2):
        (fqdir / f"f{i}.fq").write_text("".join(lines[(3 + i) * per: (4 + i) * per]))
    for exp in exps:
        exp.process_batch()
        assert exp.batch == 1 and len(exp.processed_files) == 3
    _same_state(*exps, "after one live batch")
    assert exps[1].strat and _thresholds(exps[1]) == pytest.approx(_thresholds(exps[0]),
                                                                   rel=1e-12, abs=0.0)


def test_cli_runs_aeons_sim_without_jax(aeons_corpus, tmp_path):
    toml = _toml(tmp_path / "aeons.toml", "cliaeons",
                 simulation=dict(fq=aeons_corpus["fq"], batchsize=140, maxb=2, binit=4),
                 optional=dict(min_seq_len=2500, min_contig_len=10_000))
    proc = subprocess.run([sys.executable, "-c", CLI_JAX_BLOCKED, str(REPO), str(toml)],
                          capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0 and "CLI_OK" in proc.stdout, proc.stderr[-3000:]
    out = tmp_path / "out_cliaeons"
    assert (out / "masks" / "boss.npz").exists()
    assert (out / "contigs" / "aeons.fa").read_text().startswith(">")
    assert (out / "metrics" / "batches.jsonl").read_text().count("\n") == 2
