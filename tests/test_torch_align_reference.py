"""The benchmark's plain reference aligner (``benchmark/reference/align.py``)
against the port's aligner, record for record.

* records: on a seeded world of three contigs (300 kb) and 400 reads of
  200-8,000 bases (either strand, chimeric, random and N-containing ones
  among them), ``RefAligner.map`` gives every read the records that
  ``TorchAligner`` (the plain seeding on the CPU) and ``CpuAligner`` (host
  seeding) give it, field for field and CIGAR for CIGAR, for the prefixes
  and the full reads, with the sim's k13/w5 index and the map-ont k15/w10;
* the banded DP: hand-made jobs with tied optimal paths (homopolymer and
  tandem-repeat indels, a mismatch against a gap pair) and seeded random
  jobs at the band's edges give the port's native DP's cost, ends and
  CIGAR.

Every comparison is exact: both sides are integer code.
"""
import numpy as np
import pytest
import torch

from benchmark.reference import align as RA
from benchmark.reference.layout import Genome
from bossruns_torch.aligner import TorchAligner
from bossruns_torch.aligner import native as tnative
from bossruns_torch.aligner.cpu_baseline import CpuAligner
from bossruns_torch.models.layout import build_layout
from bossruns_torch.utils.datagen import _simulate_alignment, random_genome

torch.set_num_threads(2)

FIELDS = ("qlen", "qstart", "qend", "rev", "tname", "tlen", "tstart", "tend", "nmatch",
          "blocklen", "mapq", "align_score", "s1", "primary")
_RC = str.maketrans("ACGTN", "TGCAN")
MIN_LEN = 50_000


def _revcomp(s: str) -> str:
    return s.translate(_RC)[::-1]


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(21)
    genome = random_genome(rng, {"cA": 130_000, "cB": 100_000, "cC": 70_000})
    names = list(genome)
    reads = {}

    def piece(n: int) -> str:
        g = genome[names[int(rng.integers(len(names)))]]
        s = int(rng.integers(0, len(g) - n))
        seq = _simulate_alignment(rng, g[s: s + n])[0]
        return _revcomp(seq) if rng.random() < 0.5 else seq

    for i in range(340):   # lengths log-uniform over 200-8,000
        reads[f"sim{i}"] = piece(int(np.exp(rng.uniform(np.log(200), np.log(8000)))))
    for i in range(20):
        reads[f"chimera{i}"] = piece(int(rng.integers(600, 3000))) + piece(
            int(rng.integers(600, 3000)))
    for i in range(20):
        reads[f"random{i}"] = "".join(rng.choice(list("ACGT"), int(rng.integers(200, 4000))))
    for i in range(20):
        s = list(piece(int(rng.integers(300, 3000))))
        for at in rng.integers(0, len(s), len(s) // 50):
            s[at] = "N"
        reads[f"withN{i}"] = "".join(s)
    layout = build_layout(genome, min_len=MIN_LEN)
    ref_genome = Genome({n: RA.encode(s) for n, s in genome.items()}, min_len=MIN_LEN)
    return layout, ref_genome, reads


def _by_read(rec) -> dict:
    out = {}
    for i in range(len(rec)):
        d = {f: getattr(rec, f)[i] for f in FIELDS}
        d = {f: (v if isinstance(v, str) else int(v)) for f, v in d.items()}
        d["cigar"] = tnative.cigar_to_string(rec.cigars[i])
        out.setdefault(rec.qname[i], []).append(d)
    return out


@pytest.mark.parametrize("trunc", [True, False], ids=["prefixes", "full"])
@pytest.mark.parametrize("kwv", [(13, 5, 3), (15, 10, 4)], ids=["k13w5", "k15w10"])
def test_records_equal_the_ports(world, trunc, kwv):
    layout, genome, reads = world
    k, w, votes = kwv
    ref = RA.RefAligner(genome, k, w, votes, "cpu")
    want = {r: [{f: v for f, v in d.items() if f != "qname"} for d in recs]
            for r, recs in ref.map(reads, trunc=trunc).items() if recs}
    for port in (TorchAligner(layout, k=k, w=w, min_votes=votes, device="cpu"),
                 CpuAligner(layout, k=k, w=w, min_votes=votes)):
        got = _by_read(port.map_sequences(reads, trunc=trunc))
        assert set(got) == set(want), type(port).__name__
        for r in got:
            assert got[r] == want[r], (type(port).__name__, r)
    mapped = {r.rstrip("0123456789") for r in want}
    assert mapped == {"sim", "chimera", "withN"}           # no random read maps
    assert sum(r.startswith("sim") for r in want) > 0.75 * 340
    if not trunc:   # split reads give two primary records
        assert sum(len(want[r]) == 2 for r in want if r.startswith("chimera")) >= 10
    assert {d["rev"] for recs in want.values() for d in recs} == {0, 1}


def _native(qs, ts, half, pad):
    q_off = np.concatenate([[0], np.cumsum([len(q) for q in qs])]).astype(np.int64)
    t_off = np.concatenate([[0], np.cumsum([len(t) for t in ts])]).astype(np.int64)
    cost, ts0, te0, cig = tnative.align_batch(
        np.concatenate(qs).astype(np.int8), q_off, np.concatenate(ts).astype(np.int8),
        t_off[:-1].copy(), t_off[1:].copy(), np.asarray(pad, np.int32),
        np.asarray(half, np.int32), 2)
    return [(int(c), int(a - o), int(b - o), tnative.cigar_to_string(g)) if c >= 0
            else (-1,) for c, a, b, o, g in zip(cost, ts0, te0, t_off, cig)]


def test_dp_ties_and_band_edges_equal_the_native_dp():
    rng = np.random.default_rng(8)
    enc = lambda s: RA.encode(s).astype(np.int8)  # noqa: E731
    flank = "".join(rng.choice(list("ACGT"), 150))
    tail = "".join(rng.choice(list("ACGT"), 150))
    qs, ts, half, pad = [], [], [], []
    # tied optimal paths: a base dropped from a homopolymer or a tandem
    # repeat, an extra one, a mismatch beside a gap pair, an N
    for q_mid, t_mid in (("TTTTT", "TTTT"), ("TTTT", "TTTTT"), ("ACACACAC", "ACACAC"),
                         ("ACAC", "ACACACAC"), ("GATTACA", "GACTACA"), ("GAATTC", "GATATC"),
                         ("CCNCC", "CCCC"), ("AGGGGA", "AGGGA")):
        q, t = enc(flank + q_mid + tail), enc(flank + t_mid + tail)
        for h, p in ((32, 0), (64, 16), (40, 70)):
            qs.append(q), ts.append(t), half.append(h), pad.append(p)
    # random jobs: related (10% edits, 5% deletions), unrelated, repeats,
    # windows cut short and pads past the band
    for _ in range(160):
        m, h = int(rng.integers(1, 700)), int(rng.integers(32, 160))
        g = rng.integers(0, 4, m + 2 * h + 300).astype(np.int8)
        kind = int(rng.integers(4))
        if kind == 0:
            o = int(rng.integers(0, 2 * h + 50))
            q = g[o: o + m].copy()
            edit = rng.random(q.shape[0]) < 0.1
            q[edit] = rng.integers(0, 5, int(edit.sum()))
            q = np.delete(q, rng.integers(0, q.shape[0], q.shape[0] // 20))
        elif kind == 1:
            q = rng.integers(0, 4, m).astype(np.int8)
        elif kind == 2:
            q = np.repeat(rng.integers(0, 4, m // 3 + 1), 3)[:m].astype(np.int8)
            g = np.repeat(rng.integers(0, 4, g.shape[0] // 3 + 1), 3)[: g.shape[0]].astype(np.int8)
        else:
            q = g[:m].copy()
            g = g[: int(rng.integers(1, g.shape[0]))]
        qs.append(q if q.shape[0] else g[:1].copy())
        ts.append(g)
        half.append(h)
        pad.append(int(rng.integers(0, 3 * h)))
    want = _native(qs, ts, half, pad)
    cost, a, b, runs = RA.banded_align(qs, ts, half, pad, "cpu")
    got = [(int(c), int(x), int(y), "".join(f"{n}{'MID'[o]}" for n, o in zip(*r))) if c >= 0
           else (-1,) for c, x, y, r in zip(cost, a, b, runs)]
    assert got == want
    assert sum(c < 0 for c in cost) > 0 and sum(c >= 0 for c in cost) > 150
    # the ties: the walk back takes the diagonal first, so a homopolymer's
    # gap lands at the run's left end
    assert got[0][3] == "150M1I154M" and got[3][3] == "150M1D154M"
