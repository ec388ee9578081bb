"""The benchmark's plain AEONS reference (``benchmark/reference/aeons.py``)
against the port's reference-free sim.

* overlaps: on three seeded pools (the third holding a read over 32,768
  bases, which the host seeds), ``overlaps`` gives the rows that
  ``find_overlaps(merge=True)`` gives, field for field;
* strategy: on three contig sets (mixed coverage and caps, short contigs,
  and one covered so deeply that it accepts everything) ``strategy`` gives
  ``contig_strategies``' masks bit for bit and its threshold within 1e-12
  relative;
* decisions: on a small sim's batch, ``decisions`` accepts and rejects
  the reads that ``make_decisions`` does and maps as many;
* the chunk sums are float32's, as the program's, on a set whose float32
  and float64 sums give different chunk means;
* the float32 control (one float32 prefix sum over the pool) moves mask
  bits of a pool built to show it.
"""
import numpy as np
import pytest
import torch

from benchmark.reference import aeons as RAE
from bossruns_torch.aeons.ava import PoolIndex, find_overlaps
from bossruns_torch.aeons.benefit import contig_strategies
from bossruns_torch.aeons.pool import Sequence
from bossruns_torch.aeons.simulation import BossAeonsSim
from bossruns_torch.config import BossConfig
from bossruns_torch.utils.datagen import _simulate_alignment, random_genome, write_corpus

torch.set_num_threads(2)

CCL = np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400])
_RC = str.maketrans("ACGT", "TGCA")


def _rows(rows: dict) -> list[tuple]:
    return [tuple(rows[f][i] for f in RAE.FIELDS) for i in range(len(rows["qname"]))]


def _pool(seed: int, genome_len: int, lengths: list[int]) -> dict[str, str]:
    rng = np.random.default_rng(seed)
    g = random_genome(rng, {"g": genome_len})["g"]
    out = {}
    for i, n in enumerate(lengths):
        s = int(rng.integers(0, genome_len - n))
        seq = _simulate_alignment(rng, g[s: s + n])[0]
        out[f"r{seed}_{i}"] = seq.translate(_RC)[::-1] if rng.random() < 0.5 else seq
    return out


@pytest.mark.parametrize("seed,genome_len,n_reads,long_read", [
    (1, 90_000, 40, 0), (2, 140_000, 60, 0), (3, 120_000, 30, 40_000)])
def test_overlaps_equal_find_overlaps(seed, genome_len, n_reads, long_read):
    rng = np.random.default_rng(100 + seed)
    lengths = [int(x) for x in rng.integers(2600, 14_000, n_reads)]
    if long_read:
        lengths[0] = long_read
    pool = _pool(seed, genome_len, lengths)
    names = list(pool)
    queries = {n: pool[n] for n in names[: n_reads // 2]}
    got = _rows(find_overlaps(queries, PoolIndex(pool, device="cpu"), merge=True))
    ref = RAE.overlaps(queries, pool, "cpu")
    assert len(got) > n_reads
    assert sorted(got) == sorted(ref)
    if long_read:
        assert any(r[0] == names[0] for r in ref)


def _contigs(seed: int, lengths: list[int], deep: bool = False) -> dict[str, Sequence]:
    rng = np.random.default_rng(seed)
    out = {}
    for i, n in enumerate(lengths):
        seq = "".join(rng.choice(list("ACGT"), n))
        if deep:
            cov = np.full(n, 150.0, np.float32)
        else:
            level = rng.uniform(0.5, 25.0)
            cov = (level + rng.normal(0, 3, n)).clip(0).astype(np.float32)
            cov[: int(rng.integers(0, n // 3))] /= 3.0
        s = Sequence(f"c{seed}_{i}", seq, cov=cov, cap_l=bool(rng.random() < 0.4 or deep),
                     cap_r=bool(rng.random() < 0.4 or deep))
        out[s.header] = s
    return out


@pytest.mark.parametrize("seed,lengths,deep", [
    (5, [60_000, 31_000, 12_345, 250_000], False),
    (6, [10_050, 11_000, 10_999, 15_001, 18_000, 40_000], False),
    (7, [50_000, 20_000], True)])
def test_strategy_equals_contig_strategies(seed, lengths, deep):
    contigs = _contigs(seed, lengths, deep)
    lam = 6200.0
    got, thr = contig_strategies(contigs, ccl=CCL, lam=lam, lowcov=10, device="cpu")
    ref, rthr = RAE.strategy([(h, s.cov, s.cap_l, s.cap_r) for h, s in contigs.items()],
                             CCL, lam, 10)
    assert got.keys() == ref.keys()
    for h in got:
        np.testing.assert_array_equal(got[h], ref[h], err_msg=h)
    assert RAE.strat_mismatch(got, ref) == (0, sum(m.shape[0] for m in got.values()))
    assert abs(thr - rthr) <= 1e-12 * abs(rthr)
    if deep:
        assert rthr == 0.0 and all(m.all() for m in ref.values())


def test_strategy_takes_float32_chunk_sums():
    """Chunks of 99 bases at coverage 1 and one just under it sum to 100 in
    float32 and to just under 100 in float64, so the two give the chunk
    means 1 and 0; the reference takes the float32 sums, as the program
    does, and agrees with it exactly on a set whose largest benefit lies in
    those chunks."""
    chunk = np.ones(100, np.float32)
    chunk[-1] = np.float32(1 - 2 ** -24)
    assert np.add.reduceat(chunk, [0])[0] == 100.0 > chunk.astype(np.float64).sum()
    cov = np.tile(chunk, 300)
    contigs = {"edge": Sequence("edge", "A" * cov.shape[0], cov=cov, cap_l=True, cap_r=True)}
    rng = np.random.default_rng(9)
    for i in range(3):
        c = (40 + rng.normal(0, 3, 20_000)).astype(np.float32)
        contigs[f"d{i}"] = Sequence(f"d{i}", "A" * 20_000, cov=c, cap_l=True, cap_r=True)
    got, thr = contig_strategies(contigs, ccl=CCL, lam=6200.0, lowcov=10, device="cpu")
    ref, rthr = RAE.strategy([(h, s.cov, s.cap_l, s.cap_r) for h, s in contigs.items()],
                             CCL, 6200.0, 10)
    assert RAE.strat_mismatch(got, ref) == (0, 900)
    assert thr == rthr


def test_float32_control_moves_mask_bits():
    """A 10 Mb contig at no coverage (scores of about 1) carries one
    float32 prefix sum past 100,000, where its last bit is worth 2^-3; the
    contigs after it alternate chunk means 9 and 11 (scores 0.73 and 0.27),
    so their benefits lie around the threshold, and rounded prefix sums
    move some of them across it. Summed in float64 per contig, the program
    and the reference agree bit for bit."""
    rng = np.random.default_rng(8)
    contigs = {"lead": Sequence("lead", "A" * 10_000_000,
                                cov=np.zeros(10_000_000, np.float32), cap_l=True, cap_r=True)}
    for i in range(40):
        cov = np.repeat(rng.choice([9.0, 11.0], 2000), 100).astype(np.float32)
        contigs[f"t{i}"] = Sequence(f"t{i}", "A" * cov.shape[0], cov=cov, cap_l=True,
                                    cap_r=True)
    got, thr = contig_strategies(contigs, ccl=CCL, lam=6200.0, lowcov=10, device="cpu")
    items = [(h, s.cov, s.cap_l, s.cap_r) for h, s in contigs.items()]
    ref, rthr = RAE.strategy(items, CCL, 6200.0, 10)
    ctl, _ = RAE.strategy(items, CCL, 6200.0, 10, dtype=torch.float32)
    assert RAE.strat_mismatch(got, ref)[0] == 0 and thr == rthr
    bad, rows = RAE.strat_mismatch(got, ctl)
    assert bad / rows > 1e-4, (bad, rows)


@pytest.fixture(scope="module")
def small_sim(tmp_path_factory):
    out = tmp_path_factory.mktemp("aeons_ref")
    paths = write_corpus(out / "data", rng=np.random.default_rng(31),
                         contig_lengths={"gA": 90_000, "gB": 60_000}, n_reads=1100,
                         mean_len=5000.0)
    args = BossConfig()
    args.general.name = "ref"
    args.simulation.fq = paths["fq"]
    args.simulation.batchsize = 120
    args.simulation.maxb = 4
    args.simulation.binit = 3
    sim = BossAeonsSim(args, out_base=out, device="cpu")
    for _ in range(2):
        sim.process_batch()
    return sim


def test_decisions_equal_make_decisions(small_sim):
    sim = small_sim
    seqs, *_ = sim.sampler.sample()
    contigs = sim.pool.declare_contigs(sim.args.optional.min_contig_len).seqdict()
    strat = dict(sim.strat)
    decided = sim.make_decisions(seqs)
    accept, mapped = RAE.decisions(seqs, contigs, strat, "cpu")
    assert mapped == len(seqs) - sim.unmapped_count > len(seqs) // 2
    long = [r for r in seqs if len(seqs[r]) > 400]
    assert {r: len(decided[r]) == len(seqs[r]) for r in long} == {r: accept[r] for r in long}
    assert sum(not a for a in accept.values()) == sim.reject_count


@pytest.mark.parametrize("hash_seed,execs", [(None, True), ("1", True), ("0", False)])
def test_driver_fixes_the_hash_seed(hash_seed, execs):
    """The AEONS cell's driver replaces its process by the same command
    under PYTHONHASHSEED=0 exactly when the variable is unset or not 0."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONHASHSEED"}
    if hash_seed is not None:
        env["PYTHONHASHSEED"] = hash_seed
    code = ("import os, sys; from benchmark.hashseed import fix_hash_seed; "
            "print('before', os.environ.get('PYTHONHASHSEED'), flush=True); "
            "fix_hash_seed([sys.executable, '-c', "
            "'import os; print(\"after\", os.environ[\"PYTHONHASHSEED\"], hash(\"a\"))']); "
            "print('stayed', hash('a'))")
    runs = [subprocess.run([sys.executable, "-c", code], cwd=root, env=env, text=True,
                           capture_output=True, check=True).stdout.split("\n")
            for _ in range(2)]
    for out in runs:
        assert out[0] == f"before {hash_seed}"
        assert out[1].startswith("after 0 " if execs else "stayed ")
    assert runs[0][1] == runs[1][1]   # under seed 0 every run hashes alike
