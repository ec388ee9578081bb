"""Synthetic nanopore-style data generator for tests and benchmarks.

The reference's conformance corpus (data/BOSS_test_data git submodule) is not
vendored in this snapshot, so we generate an equivalent, fully ground-truthed
corpus: a random multi-contig genome, error-bearing long reads sampled from it
(substitutions/insertions/deletions with known edit scripts), and the exact
PAF files — full-length and mu-truncated — that the simulation data plane
consumes (mirroring scripts/prepare_simulation_data.smk's minimap2 outputs,
but with alignments known by construction instead of re-discovered).

CIGARs are emitted in target-forward orientation like minimap2's cg:Z tag;
truncated-read alignments are the exact prefix (in read direction) of the
full alignment cut at mu read bases.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_genome(rng, contig_lengths: dict[str, int]) -> dict[str, str]:
    return {
        name: BASES[rng.integers(0, 4, size=n)].tobytes().decode()
        for name, n in contig_lengths.items()
    }


_COMP = bytes.maketrans(b"ACGT", b"TGCA")


def revcomp_str(s: str) -> str:
    return s.encode().translate(_COMP)[::-1].decode()


@dataclass
class SimRead:
    rid: str
    seq: str
    qual: str
    tname: str
    tstart: int
    tend: int
    rev: int
    # unit ops along target-forward orientation: 1=M, 2=D(target only), 3=I(read only)
    ops: np.ndarray
    barcode: int | None = None


_BASE_IDX = np.zeros(256, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _BASE_IDX[_b] = _i


def _simulate_alignment(rng, target: str, sub=0.03, ins=0.02, dele=0.02):
    """Read sequence (target-forward orientation) + unit ops for a target slice.

    Fully vectorised: per target position an M or D op, optionally followed
    by an I op, interleaved via cumulative-insertion index mapping.
    """
    t = np.frombuffer(target.encode(), dtype=np.uint8)
    n = t.shape[0]
    r = rng.random(n)
    is_del = r < dele
    is_sub = (r >= dele) & (r < dele + sub)
    is_ins = rng.random(n) < ins
    n_ins = int(is_ins.sum())

    cum_ins = np.cumsum(is_ins)
    main_pos = np.arange(n) + np.concatenate([[0], cum_ins[:-1]])
    ins_pos = main_pos[is_ins] + 1
    total = n + n_ins
    ops = np.empty(total, dtype=np.int8)
    ops[main_pos] = np.where(is_del, 2, 1).astype(np.int8)
    ops[ins_pos] = 3

    read_base = t.copy()
    shift = rng.integers(1, 4, size=n)
    read_base[is_sub] = BASES[(_BASE_IDX[t[is_sub]] + shift[is_sub]) % 4]
    bases = np.empty(total, dtype=np.uint8)
    bases[main_pos] = read_base
    bases[ins_pos] = BASES[rng.integers(0, 4, size=n_ins)]
    read = bases[ops != 2]
    return read.tobytes().decode(), ops


def ops_to_cigar(ops: np.ndarray) -> str:
    if ops.shape[0] == 0:
        return ""
    sym = np.array(["", "M", "D", "I"])
    change = np.flatnonzero(np.diff(ops)) + 1
    bounds = np.concatenate([[0], change, [ops.shape[0]]])
    return "".join(
        f"{bounds[k+1]-bounds[k]}{sym[ops[bounds[k]]]}" for k in range(bounds.shape[0] - 1)
    )


def simulate_reads(
    rng,
    genome: dict[str, str],
    n_reads: int,
    mean_len: float = 6000.0,
    sd_len: float = 4000.0,
    min_len: int = 200,
    barcodes: list[int] | None = None,
    abundance: dict[str, float] | None = None,
) -> list[SimRead]:
    """abundance: optional per-contig sampling weights (molar abundance);
    default is length-weighted (uniform per-site coverage)."""
    names = list(genome)
    lengths = np.array([len(genome[n]) for n in names], dtype=np.float64)
    if abundance is not None:
        w = np.array([abundance.get(n, 1.0) for n in names]) * lengths
        p = w / w.sum()
    else:
        p = lengths / lengths.sum()
    reads = []
    for k in range(n_reads):
        c = int(rng.choice(len(names), p=p))
        tlen = len(genome[names[c]])
        L = int(np.clip(rng.normal(mean_len, sd_len), min_len, 60000))
        ts = int(rng.integers(0, max(tlen - L, 1)))
        te = min(ts + L, tlen)
        seq_fwd, ops = _simulate_alignment(rng, genome[names[c]][ts:te])
        rev = int(rng.integers(0, 2))
        seq = revcomp_str(seq_fwd) if rev else seq_fwd
        bc = int(rng.choice(barcodes)) if barcodes else None
        rid = f"read{k:06d}"
        qual = "I" * len(seq)
        reads.append(SimRead(rid, seq, qual, names[c], ts, te, rev, ops, bc))
    return reads


def _paf_line(r: SimRead, qlen, qstart, qend, tstart, tend, ops, tlen) -> str:
    nmatch = int((ops == 1).sum())
    blocklen = int(ops.shape[0])
    cg = ops_to_cigar(ops)
    strand = "-" if r.rev else "+"
    return (
        f"{r.rid}\t{qlen}\t{qstart}\t{qend}\t{strand}\t{r.tname}\t{tlen}\t"
        f"{tstart}\t{tend}\t{nmatch}\t{blocklen}\t60\ttp:A:P\tAS:i:{2*nmatch}\t"
        f"s1:i:{nmatch}\tcg:Z:{cg}"
    )


def paf_records(reads: list[SimRead], genome: dict[str, str], mu: int = 400):
    """(full_paf_lines, trunc_paf_lines) for the simulated reads."""
    full, trunc = [], []
    for r in reads:
        tlen = len(genome[r.tname])
        qlen = len(r.seq)
        full.append(_paf_line(r, qlen, 0, qlen, r.tstart, r.tend, r.ops, tlen))
        if qlen <= mu:
            continue
        # cut at mu read bases measured from the read's 5' end
        reads_read = r.ops != 2  # ops consuming read bases, target orientation
        read_cum = np.cumsum(reads_read)
        if r.rev:
            # read 5' end = target-forward END: take the ops suffix whose
            # read consumption is mu
            consumed_from_end = read_cum[-1] - read_cum
            keep = consumed_from_end < mu
            ops_t = r.ops[keep]
            t_consumed = int((ops_t != 3).sum())
            tstart_t, tend_t = r.tend - t_consumed, r.tend
        else:
            keep = read_cum <= mu
            ops_t = r.ops[keep]
            t_consumed = int((ops_t != 3).sum())
            tstart_t, tend_t = r.tstart, r.tstart + t_consumed
        # drop flanking D ops so the alignment starts/ends on read bases
        nz = np.flatnonzero(ops_t != 2)
        if nz.size == 0:
            continue
        lead_d = int((ops_t[: nz[0]] == 2).sum())
        tail_d = int((ops_t[nz[-1] + 1 :] == 2).sum())
        ops_t = ops_t[nz[0] : nz[-1] + 1]
        if r.rev:
            tstart_t += tail_d
            tend_t -= lead_d
        else:
            tstart_t += lead_d
            tend_t -= tail_d
        qend_t = int((ops_t != 2).sum())
        trunc.append(_paf_line(r, mu, 0, qend_t, tstart_t, tend_t, ops_t, tlen))
    return full, trunc


def write_corpus(
    out_dir: str | Path,
    rng=None,
    contig_lengths: dict[str, int] | None = None,
    n_reads: int = 4000,
    mean_len: float = 6000.0,
    mu: int = 400,
    barcodes: list[int] | None = None,
    abundance: dict[str, float] | None = None,
) -> dict[str, str]:
    """Write ref.fa, reads.fq, full.paf, trunc.paf; return their paths."""
    rng = rng or np.random.default_rng(7)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    contig_lengths = contig_lengths or {"contigA": 300_000, "contigB": 150_000}
    genome = random_genome(rng, contig_lengths)
    reads = simulate_reads(
        rng, genome, n_reads, mean_len=mean_len, barcodes=barcodes, abundance=abundance
    )
    ref = out / "ref.fa"
    with open(ref, "w") as fh:
        for n, s in genome.items():
            fh.write(f">{n}\n{s}\n")
    fq = out / "reads.fq"
    with open(fq, "w") as fh:
        for r in reads:
            bc = getattr(r, "barcode", None)
            comment = f" barcode=barcode{bc:02d} ch=1" if bc is not None else " ch=1"
            fh.write(f"@{r.rid}{comment}\n{r.seq}\n+\n{r.qual}\n")
    full, trunc = paf_records(reads, genome, mu=mu)
    (out / "full.paf").write_text("\n".join(full) + "\n")
    (out / "trunc.paf").write_text("\n".join(trunc) + "\n")
    return {
        "ref": str(ref),
        "fq": str(fq),
        "paf_full": str(out / "full.paf"),
        "paf_trunc": str(out / "trunc.paf"),
    }
