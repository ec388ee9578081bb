"""The benchmark's one generator of inputs, driven by a traffic file.

Copies of the repository's sound generators, kept here so that the
yardstick does not move with the program:

* ``random_genome``, ``simulate_reads``, ``paf_records`` and the corpus
  writer are bossruns_torch's ``utils/datagen`` (``write_corpus``,
  ``simulate_reads``), line for line but for the read-length clip, which
  the traffic file sets. The seed is the traffic file's ``corpus_seed``:
  the corpus is a fixed pool of reads, as the upstream's data set is,
  written once per checkout; a run samples its batches from it in an
  order drawn from ``--seed`` (``drivers/sim_epochs.py``).
* ``chrom_genome``, ``chrom_reads`` and ``dense_coverage`` are
  ``chip_smoke.py``'s ``CHR1``/``chrom_genome``, ``chrom_batches`` and
  ``dense_coverage``. They take the run's ``--seed``; the sequence and
  the coverage are drawn on the device with a seeded ``torch.Generator``
  in a few large calls, the reads on the host with NumPy. ``chrom_reads``
  keeps ``chrom_batches``' draw (lengths, the hot window's share, 5% random
  symbols) and returns raw reads; the read-start windows follow each
  read's own start instead of a uniform draw. With no hot window it is
  the scoreboard's ``build_inputs`` draw, which is therefore not copied
  separately.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import torch

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = bytes.maketrans(b"ACGT", b"TGCA")
_BASE_IDX = np.zeros(256, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _BASE_IDX[_b] = _i


# ------------------------------------------------------- the sim's corpus --

def random_genome(rng, contig_lengths: dict[str, int]) -> dict[str, str]:
    return {name: BASES[rng.integers(0, 4, size=n)].tobytes().decode()
            for name, n in contig_lengths.items()}


def revcomp_str(s: str) -> str:
    return s.encode().translate(_COMP)[::-1].decode()


def _simulate_alignment(rng, target: str, sub=0.03, ins=0.02, dele=0.02):
    """Read (target orientation) and unit ops (1 M, 2 D, 3 I) of a slice."""
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
    return bases[ops != 2].tobytes().decode(), ops


def ops_to_cigar(ops: np.ndarray) -> str:
    if ops.shape[0] == 0:
        return ""
    sym = np.array(["", "M", "D", "I"])
    change = np.flatnonzero(np.diff(ops)) + 1
    bounds = np.concatenate([[0], change, [ops.shape[0]]])
    return "".join(f"{bounds[k + 1] - bounds[k]}{sym[ops[bounds[k]]]}"
                   for k in range(bounds.shape[0] - 1))


def simulate_reads(rng, genome: dict[str, str], n_reads: int, mean_len: float,
                   sd_len: float, min_len: int, max_len: int):
    """Length-weighted reads: (rid, seq, tname, tstart, tend, rev, ops)."""
    names = list(genome)
    lengths = np.array([len(genome[n]) for n in names], dtype=np.float64)
    p = lengths / lengths.sum()
    reads = []
    for k in range(n_reads):
        c = int(rng.choice(len(names), p=p))
        tlen = len(genome[names[c]])
        L = int(np.clip(rng.normal(mean_len, sd_len), min_len, max_len))
        ts = int(rng.integers(0, max(tlen - L, 1)))
        te = min(ts + L, tlen)
        seq_fwd, ops = _simulate_alignment(rng, genome[names[c]][ts:te])
        rev = int(rng.integers(0, 2))
        seq = revcomp_str(seq_fwd) if rev else seq_fwd
        reads.append((f"read{k:06d}", seq, names[c], ts, te, rev, ops))
    return reads


def _paf_line(rid, rev, tname, qlen, qstart, qend, tstart, tend, ops, tlen) -> str:
    nmatch = int((ops == 1).sum())
    return (f"{rid}\t{qlen}\t{qstart}\t{qend}\t{'-' if rev else '+'}\t{tname}\t{tlen}\t"
            f"{tstart}\t{tend}\t{nmatch}\t{int(ops.shape[0])}\t60\ttp:A:P\tAS:i:{2 * nmatch}\t"
            f"s1:i:{nmatch}\tcg:Z:{ops_to_cigar(ops)}")


def paf_records(reads, genome: dict[str, str], mu: int):
    """(full, truncated) PAF lines: the truncated record is the exact prefix
    (in read direction) of the full alignment cut at ``mu`` read bases."""
    full, trunc = [], []
    for rid, seq, tname, ts, te, rev, ops in reads:
        tlen, qlen = len(genome[tname]), len(seq)
        full.append(_paf_line(rid, rev, tname, qlen, 0, qlen, ts, te, ops, tlen))
        if qlen <= mu:
            continue
        read_cum = np.cumsum(ops != 2)
        if rev:
            keep = (read_cum[-1] - read_cum) < mu
            ops_t = ops[keep]
            t_used = int((ops_t != 3).sum())
            ts_t, te_t = te - t_used, te
        else:
            keep = read_cum <= mu
            ops_t = ops[keep]
            t_used = int((ops_t != 3).sum())
            ts_t, te_t = ts, ts + t_used
        nz = np.flatnonzero(ops_t != 2)
        if nz.size == 0:
            continue
        lead_d = int((ops_t[: nz[0]] == 2).sum())
        tail_d = int((ops_t[nz[-1] + 1:] == 2).sum())
        ops_t = ops_t[nz[0]: nz[-1] + 1]
        if rev:
            ts_t, te_t = ts_t + tail_d, te_t - lead_d
        else:
            ts_t, te_t = ts_t + lead_d, te_t - tail_d
        trunc.append(_paf_line(rid, rev, tname, mu, 0, int((ops_t != 2).sum()), ts_t, te_t,
                               ops_t, tlen))
    return full, trunc


def corpus_paths(root: Path) -> dict:
    return {"ref": str(root / "ref.fa"), "fq": str(root / "reads.fq"),
            "paf_full": str(root / "full.paf"), "paf_trunc": str(root / "trunc.paf")}


def write_corpus(base: Path, config: dict, traffic: dict) -> dict:
    """The sim's corpus, written once into a directory of ``base`` named
    by its parameters: the configuration's contigs as ref.fa and a pool of
    ``n_reads`` reads as a FASTQ with its full and truncated PAFs; reused
    once ``.complete`` is there."""
    c = traffic["corpus"]
    spec = json.dumps({"contigs": config["contigs"], "corpus": c, "mu": traffic["mu"]},
                      sort_keys=True)
    root = Path(base) / f"{config['name']}-{hashlib.sha256(spec.encode()).hexdigest()[:12]}"
    paths = corpus_paths(root)
    done = root / ".complete"
    if done.exists() and done.read_text() == spec:
        return paths
    rng = np.random.default_rng(c["corpus_seed"])
    genome = random_genome(rng, config["contigs"])
    root.mkdir(parents=True, exist_ok=True)
    with open(paths["ref"], "w") as fh:
        for n, s in genome.items():
            fh.write(f">{n}\n{s}\n")
    reads = simulate_reads(rng, genome, c["n_reads"], c["mean_len"], c["sd_len"],
                           c["min_len"], c["max_len"])
    with open(paths["fq"], "w") as fh:
        for rid, seq, *_ in reads:
            fh.write(f"@{rid} ch=1\n{seq}\n+\n{'I' * len(seq)}\n")
    full, trunc = paf_records(reads, genome, traffic["mu"])
    Path(paths["paf_full"]).write_text("\n".join(full) + "\n")
    Path(paths["paf_trunc"]).write_text("\n".join(trunc) + "\n")
    done.write_text(spec)
    return paths


# --------------------------------------------------- the chromosome cell --

def chrom_genome(contigs: dict[str, int], gen: torch.Generator, device) -> dict[str, np.ndarray]:
    """Uniform codes 0..3 per contig, drawn on ``device`` and brought to the
    host (the layout is built there)."""
    return {n: torch.randint(0, 4, (L,), generator=gen, device=device,
                             dtype=torch.uint8).cpu().numpy()
            for n, L in contigs.items()}


def chrom_reads(rng, genome: dict[str, np.ndarray], n_reads: int, mean_len: float,
                sd_len: float, min_len: int, max_len: int, hot: tuple | None,
                hot_share: float, error_rate: float) -> dict:
    """Raw reads: contig index, start, length, strand, barcode (0) and the
    concatenated observed symbols (0..3, 4 = deletion; ``error_rate`` of
    them redrawn uniformly from 0..4). ``hot_share`` of the reads start in
    ``hot`` = (contig, start, end); the rest are length-weighted."""
    names = list(genome)
    lens = np.array([len(genome[n]) for n in names], np.int64)
    rlen = np.clip(rng.normal(mean_len, sd_len, n_reads), min_len, max_len).astype(np.int64)
    n_hot = int(n_reads * hot_share) if hot else 0
    cid = np.empty(n_reads, np.int64)
    start = np.empty(n_reads, np.int64)
    if n_hot:
        hc, h0, h1 = hot
        cid[:n_hot] = names.index(hc)
        start[:n_hot] = h0 + (rng.random(n_hot) * (h1 - h0 - rlen[:n_hot])).astype(np.int64)
    rest = n_reads - n_hot
    cid[n_hot:] = rng.choice(len(lens), rest, p=lens / lens.sum())
    start[n_hot:] = (rng.random(rest) * (lens[cid[n_hot:]] - rlen[n_hot:])).astype(np.int64)
    cat = np.concatenate([genome[n] for n in names])
    coff = np.concatenate([[0], np.cumsum(lens)[:-1]])
    first = np.repeat(coff[cid] + start, rlen)
    within = np.arange(int(rlen.sum())) - np.repeat(np.cumsum(rlen) - rlen, rlen)
    sym = cat[first + within].astype(np.int8)
    flip = rng.random(sym.shape[0]) < error_rate
    sym[flip] = rng.integers(0, 5, int(flip.sum()))
    strand = rng.integers(0, 2, n_reads).astype(np.int64)
    return dict(cid=cid, start=start, length=rlen, strand=strand,
                bc=np.zeros(n_reads, np.int64), sym=sym)


#: sites drawn per call of ``dense_coverage`` (bounds its temporaries)
DENSE_BLOCK = 1 << 24


def dense_coverage(valid: torch.Tensor, ref: torch.Tensor, gen: torch.Generator,
                   p_ref: float = 0.9) -> torch.Tensor:
    """[1, 5, G] uint16 coverage: every valid site holds a coverage sum
    drawn from 1..29 (unfrozen, nonzero), each count on the reference
    symbol with probability ``p_ref`` and the rest split evenly over the
    other four symbols; padding sites hold none. The mid-run state of an
    experiment, where every site needs the full contraction. Drawn in
    blocks of DENSE_BLOCK sites."""
    G = ref.shape[0]
    dev = ref.device
    out = torch.zeros((1, 5, G), dtype=torch.uint16, device=dev)
    for s in range(0, G, DENSE_BLOCK):
        e = min(s + DENSE_BLOCK, G)
        total = torch.randint(1, 30, (e - s,), generator=gen, device=dev).to(torch.float32)
        total *= valid[s:e]
        n_ref = torch.binomial(total, torch.full_like(total, p_ref), generator=gen)
        rest = total - n_ref
        cov = torch.zeros((5, e - s), dtype=torch.int32, device=dev)
        r = ref[s:e].long()
        cov.scatter_(0, r[None], n_ref.to(torch.int32)[None])
        for k in range(4):  # the other symbols, in plane order, split the rest
            o = torch.binomial(rest, torch.full_like(rest, 1.0 / (4 - k)), generator=gen) \
                if k < 3 else rest
            rest = rest - o
            cov.scatter_add_(0, (k + (k >= r).long())[None], o.to(torch.int32)[None])
        out[0, :, s:e] = cov.to(torch.uint16)
    return out
