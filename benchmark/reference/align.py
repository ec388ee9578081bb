"""Plain reference of the port's read aligner, in PyTorch with NumPy glue.

What ``TorchAligner.map_sequences`` states it computes (primary records,
the sim's two passes), written again from the contigs and the reads alone:

* **Index.** Over the padded genome axis of ``layout.Genome`` (the sites
  of a contig hold its codes, padding holds code 4), every k-mer without a
  code 4 whose forward code differs from its reverse complement's has a
  canonical code (the smaller, 2 bits a base) and a strand (1 where the
  reverse complement is the smaller). Its selection hash is the 31-bit mix
  of ``canonical ^ (canonical >> 15)`` (``_mix31``); any other k-mer hashes
  to 2^31 - 1. A k-mer is a minimizer where its hash equals the least hash
  within w - 1 positions on either side (the axis's ends cut the reach).
  Each canonical code with at most 64 minimizer occurrences keeps its first
  4 (OCC_CAP) by position; more than 64 drop the code.
* **Seeding.** A read is seeded on its first min(len, 32768) bases, padded
  with code 4 to its length bucket L (512 ... 32768). Its first
  ``budget`` minimizers by position (``_budget(L, w)``) look up the index;
  an occurrence on the read's strand gives the forward diagonal
  ``gpos - qpos``, one on the other strand the reverse diagonal ``gpos +
  qpos``. Each space keeps its ``2 budget`` smallest diagonals (ties by
  the minimizer's rank, then the occurrence's), and each kept diagonal
  votes the larger of the counts of kept diagonals in its cell of two
  grids of width 2 DIAG_TOL, offset by DIAG_TOL. Four candidates are peeled:
  the first best vote of each space, the reverse space's only if it is
  larger; the candidate's cluster is its space's kept diagonals within
  DIAG_TOL of its diagonal (spread ``dspan``, query span ``qmin``..
  ``qmax``), and every diagonal within 2 DIAG_TOL of it stops voting.
* **Plan.** Candidates are used while their votes reach ``min_votes``;
  one that overlaps (half of the shorter query span) a used one needs half
  its votes. Used candidates with no disjoint used sibling align the whole
  read; siblings cut the read at the midpoints between their spans. The
  band half-width is ``dspan // 2 + 48 + slen // 200`` (plus the overhang
  of a cut segment), clipped to 64..1024; the target window is the
  predicted start less half + 16 to its end plus half + 16, inside the
  contig's block, at least ``min_len`` long. mapq: 60 (30 below twice
  ``min_votes``) times one less the best overlapping competitor's votes
  over the candidate's.
* **Extension.** Edit distance (match 0, mismatch or N 1, gap 1) of the
  whole segment (reverse-complemented on the reverse strand) against the
  window, free at the window's ends, in the port's band: the query's rows
  in blocks of 64, a target column computing the blocks from the one that
  holds row ``j - pad - half`` to the one that holds ``j - pad + half``;
  a block entering at the bottom starts as a run of insertions below the
  block above, and a top block below the first takes a value one more
  than its last column's above it. The alignment ends at the first least
  cost in row m of the band and is traced back diagonal first, then up,
  then left, by the values the band holds (``_dp_block``).
* **Records.** Leading and trailing insertion runs become clips; an
  alignment is kept if its cost is at most 0.35 of the segment, it spans
  ``min_len`` target bases and lies in one contig. A read's kept
  alignments become primary by (mapq, score) unless they overlap a primary
  one by half; primaries are emitted.

Departures from the program, none of which changes a record:

* The plan's two rules in floating point (the divergence limit and mapq)
  are evaluated in float64 as the program states them; everything else is
  integer arithmetic (``slen // 200`` for the program's ``slen * 0.005``
  truncated, equal for every length a read can have).
* The anchors' cells are counted by binary search over the kept,
  sorted diagonals; the band is computed cell by cell (a running minimum
  down the column) instead of 64 rows a machine word; the traceback
  follows a code per stored cell (int8), found while the band is
  computed, instead of reading the values back; a path that leaves the
  stored band at a top block's first row climbs to row 1 as the port's
  does, in one step. Jobs run side by side a column (and a step back) at
  a time; on a card each 64 of these replay one CUDA graph.
* Reads are seeded and extended in blocks of any size and order; a read's
  records come in the order of its candidates, as the program's do.
* The contigs are taken as A/C/G/T (the corpus has no other letter).
"""
from __future__ import annotations

import numpy as np
import torch

from .layout import Genome

LENGTH_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 32768)
ANCHOR_BUDGET = 1024
OCC_CAP = 4
MAX_OCC = 64
DIAG_TOL = 256
SENTINEL = 2 ** 31 - 2 ** 24
NCAND = 4
SEED_FIELDS = ("strand", "bkey", "votes", "dspan", "qmin", "qmax")
INT32_MAX = 2 ** 31 - 1
BIG = 1 << 30
INF = 1 << 28
MAX_DIVERGENCE = 0.35
#: bytes of traceback codes a DP block may hold, by device type
DP_BLOCK_BYTES = {"cuda": 24 << 30, "cpu": 768 << 20}
DP_BLOCK_JOBS = 16384
#: on the CPU a block's longest window is at most twice its shortest (the
#: work is the cells; on a card it is the columns, so blocks are as large as
#: they may be)
DP_BLOCK_RATIO = {"cpu": 2}

_CODES = np.full(256, 4, np.int8)
for _i, _b in enumerate(b"ACGT"):
    _CODES[_b] = _i
    _CODES[_b + 32] = _i
_COMPLEMENT = np.array([3, 2, 1, 0, 4], np.int8)
_OPS = np.array(list("MID"))


def encode(seq) -> np.ndarray:
    """A/C/G/T (either case) -> 0..3, anything else 4."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _CODES[np.frombuffer(seq, np.uint8)]


def bucket(n: int) -> int:
    return next((b for b in LENGTH_BUCKETS if n <= b), LENGTH_BUCKETS[-1])


def _budget(L: int, w: int) -> int:
    """Minimizer slots of a read of bucket L: the power of two (at least
    64) that holds 2.2 L / (w + 1) + 16, at most ANCHOR_BUDGET."""
    need = int(2.2 * L / (w + 1)) + 16
    p = 64
    while p < need:
        p *= 2
    return min(p, ANCHOR_BUDGET)


def _mix31(x: torch.Tensor) -> torch.Tensor:
    m = 0xFFFFFFFF
    h = x & m
    h = h ^ (h >> 16)
    h = (h * 0x45D9F3B) & m
    h = h ^ (h >> 16)
    h = (h * 0x45D9F3B) & m
    h = h ^ (h >> 16)
    return h >> 1


def minimizers(codes: torch.Tensor, k: int, w: int):
    """(canonical, strand, is_min) of the k-mers of each row of ``codes``
    (int64 [R, L], 0..4), each [R, L - k + 1]."""
    R, L = codes.shape
    n = L - k + 1
    fwd = torch.zeros((R, n), dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    bad = torch.zeros((R, n), dtype=torch.bool, device=codes.device)
    for j in range(k):
        c = codes[:, j: j + n]
        fwd = fwd * 4 + (c & 3)
        rc = rc + ((3 - (c & 3)) << (2 * j))
        bad |= c > 3
    ok = ~bad & (fwd != rc)
    canonical = torch.minimum(fwd, rc)
    strand = (rc < fwd).to(torch.int64)
    h = torch.where(ok, _mix31(canonical ^ (canonical >> 15)), INT32_MAX)
    pad = torch.full((R, w - 1), INT32_MAX, dtype=torch.int64, device=codes.device)
    hp = torch.cat([pad, h, pad], dim=1)
    least = h.clone()
    for s in range(2 * w - 1):
        least = torch.minimum(least, hp[:, s: s + n])
    return canonical, strand, ok & (h == least)


class Index:
    """The minimizer index of ``genome``: ``keys`` sorted canonical codes
    [U] int64 and ``occ`` [U, OCC_CAP] int64, each an occurrence's
    ``position << 1 | strand`` or -1."""

    def __init__(self, genome: Genome, k: int, w: int, device, max_occ: int = MAX_OCC):
        dev = torch.device(device)
        seq = np.where(genome.site_valid, genome.seq, 4).astype(np.int64)
        canonical, strand, is_min = minimizers(torch.as_tensor(seq, device=dev)[None], k, w)
        pos = torch.nonzero(is_min[0])[:, 0]
        key = canonical[0, pos]
        st = strand[0, pos]
        del canonical, strand, is_min
        key, order = torch.sort(key, stable=True)
        pos, st = pos[order], st[order]
        uniq, counts = torch.unique_consecutive(key, return_counts=True)
        first = torch.cumsum(counts, 0) - counts
        keep = counts <= max_occ
        self.keys = uniq[keep]
        first, counts = first[keep], counts[keep]
        self.occ = torch.full((self.keys.shape[0], OCC_CAP), -1, dtype=torch.int64, device=dev)
        for o in range(OCC_CAP):
            has = counts > o
            at = first[has] + o
            self.occ[has, o] = (pos[at] << 1) | st[at]
        self.k, self.w = k, w


def _first_max(v: torch.Tensor):
    """(index of the first largest entry of each row, the entry)."""
    top = v.max(dim=1).values
    idx = torch.arange(v.shape[1], device=v.device).expand_as(v)
    return torch.where(v == top[:, None], idx, v.shape[1]).min(dim=1).values, top


def _seed_rows(codes: torch.Tensor, index: Index, L: int) -> dict:
    """NCAND candidates per row of ``codes`` (int64 [R, L]), each field
    int64 [R, NCAND]."""
    k, w = index.k, index.w
    a = _budget(L, w)
    canonical, strand, is_min = minimizers(codes, k, w)
    R, n = canonical.shape
    dev = codes.device
    rank = torch.cumsum(is_min.to(torch.int64), dim=1) - 1
    take = is_min & (rank < a)
    slot = torch.where(take, rank, a)
    ck = torch.zeros((R, a + 1), dtype=torch.int64, device=dev).scatter_(1, slot, canonical)
    cs = torch.zeros((R, a + 1), dtype=torch.int64, device=dev).scatter_(1, slot, strand)
    pos = torch.arange(n, device=dev).expand(R, n)
    cp = torch.zeros((R, a + 1), dtype=torch.int64, device=dev).scatter_(1, slot, pos)
    cv = torch.zeros((R, a + 1), dtype=torch.bool, device=dev).scatter_(1, slot, take)
    ck, cs, cp, cv = ck[:, :a], cs[:, :a], cp[:, :a], cv[:, :a]
    U = index.keys.shape[0]
    if U:
        at = torch.searchsorted(index.keys, ck.contiguous()).clamp_max(U - 1)
        hit = cv & (index.keys[at] == ck)
        occ = index.occ[at]                                       # [R, a, OCC_CAP]
    else:
        hit = torch.zeros_like(cv)
        occ = torch.full((R, a, OCC_CAP), -1, dtype=torch.int64, device=dev)
    here = hit[:, :, None] & (occ >= 0)
    gpos, gstr = occ >> 1, occ & 1
    qpos = cp[:, :, None]
    same = gstr == cs[:, :, None]
    spaces = []
    for key in (torch.where(here & same, gpos - qpos, SENTINEL),
                torch.where(here & ~same, gpos + qpos, SENTINEL)):
        key = key.reshape(R, a * OCC_CAP)
        key, order = torch.sort(key, dim=1, stable=True)
        key = key[:, : 2 * a].contiguous()
        qp = torch.gather(qpos.expand(R, a, OCC_CAP).reshape(R, a * OCC_CAP), 1,
                          order[:, : 2 * a])
        counts = []
        for off in (0, DIAG_TOL):
            lo = torch.div(key + off, 2 * DIAG_TOL, rounding_mode="floor") * (2 * DIAG_TOL) - off
            counts.append(torch.searchsorted(key, lo + 2 * DIAG_TOL)
                          - torch.searchsorted(key, lo))
        vote = torch.where(key < SENTINEL, torch.maximum(*counts), -1)
        spaces.append([key, qp, vote])
    out = {f: [] for f in SEED_FIELDS}
    for _ in range(NCAND):
        (kf, qf, vf), (kr, qr, vr) = spaces
        bi_f, bv_f = _first_max(vf)
        bi_r, bv_r = _first_max(vr)
        rev = bv_r > bv_f
        key = torch.where(rev[:, None], kr.gather(1, bi_r[:, None]),
                          kf.gather(1, bi_f[:, None]))[:, 0]
        K = torch.where(rev[:, None], kr, kf)
        Qp = torch.where(rev[:, None], qr, qf)
        dist = (K - key[:, None]).abs()
        inside = (dist <= DIAG_TOL) & (K < SENTINEL)
        dmax = torch.where(inside, K, -BIG).max(dim=1).values
        dmin = torch.where(inside, K, BIG).min(dim=1).values
        out["strand"].append(rev.to(torch.int64))
        out["bkey"].append(key)
        out["votes"].append(torch.maximum(bv_f, bv_r))
        out["dspan"].append((dmax - dmin).clamp_min(0))
        out["qmin"].append(torch.where(inside, Qp, BIG).min(dim=1).values.clamp_min(0))
        out["qmax"].append(torch.where(inside, Qp, -BIG).max(dim=1).values.clamp_min(0))
        peel = dist <= 2 * DIAG_TOL
        spaces[0][2] = torch.where(~rev[:, None] & peel, -1, vf)
        spaces[1][2] = torch.where(rev[:, None] & peel, -1, vr)
    return {f: torch.stack(v, dim=1).cpu().numpy() for f, v in out.items()}


def seed(reads: list[np.ndarray], index: Index, device, rows_per_call: int = 1 << 22) -> dict:
    """NCAND candidates of each read (codes), field -> int64 [len(reads), NCAND]."""
    out = {f: np.zeros((len(reads), NCAND), np.int64) for f in SEED_FIELDS}
    by_L: dict[int, list[int]] = {}
    for i, r in enumerate(reads):
        by_L.setdefault(bucket(len(r)), []).append(i)
    for L, idx in sorted(by_L.items()):
        step = max(1, rows_per_call // L)
        for s in range(0, len(idx), step):
            part = idx[s: s + step]
            mat = np.full((len(part), L), 4, np.int64)
            for row, i in enumerate(part):
                q = reads[i][:L]
                mat[row, : len(q)] = q
            got = _seed_rows(torch.as_tensor(mat, device=device), index, L)
            for f in out:
                out[f][part] = got[f]
    return out


# ------------------------------------------------------------- extension --

#: columns (and walk-back steps) run as one chunk: on a card one CUDA graph
_COLS = 64


def _chunks(dev, n: int, fill, body, drain) -> None:
    """``fill(c)``, ``body()``, ``drain(c)`` for each of ``n`` chunks. On a
    card ``body`` is captured once as a CUDA graph (after ``fill(None)``,
    the inputs of a chunk that changes no state, and one run of it) and
    replayed: a chunk's launches go to the card at once."""
    if dev.type != "cuda":
        for c in range(n):
            fill(c)
            body()
            drain(c)
        return
    fill(None)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    for c in range(n):
        fill(c)
        graph.replay()
        drain(c)


def _dp_block(qs: list, ts: list, half: np.ndarray, pad: np.ndarray, dev) -> tuple:
    """Banded alignments of queries ``qs`` against windows ``ts`` (int8
    codes), all at once on ``dev``: (cost, tstart, tend, forward op runs
    (lengths, ops)), cost -1 where no cell of row m lies in the band.

    Each job's column is held in a frame of rows ``64 bf .. 64 bf + BW``
    (bf the column's top block, slot 0 its top boundary); the frame moves
    down 64 rows when the top block does. Below the column's last block
    the frame holds the insertion run down from its last row, which is
    where a block that enters at the next column starts. A column's value
    is the running minimum down the frame of min(diagonal, left) less the
    row, plus the row. The code of each stored cell (0 M, 1 I, 2 D, 3 and
    4 a climb to row 1 ending in M or I) is what the port's traceback
    takes there; it is kept per (job, column, slot) for the walk back."""
    J = len(qs)
    C = _COLS
    t64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)  # noqa: E731
    floor64 = lambda x: torch.div(x, 64, rounding_mode="floor")  # noqa: E731
    m_np = np.array([len(q) for q in qs], np.int64)
    n_np = np.array([len(t) for t in ts], np.int64)
    half = np.asarray(half, np.int64)
    BW = int((64 * ((2 * half) // 64 + 2)).max())
    FW = BW + 1 + 64
    N = int(n_np.max())
    n_chunks = -(-N // C)
    QW = 64 * int((m_np.max() + 63) // 64) + 64
    Q = np.full((J, QW), 5, np.int8)          # 5: no query row; 6: an N
    T = np.full((n_chunks * C, J), 4, np.int8)
    for r in range(J):
        Q[r, : m_np[r]] = np.where(qs[r] > 3, 6, qs[r])
        T[: n_np[r], r] = ts[r]
    Q = torch.as_tensor(Q, device=dev)
    T = torch.as_tensor(T, device=dev)
    m, n, h, p = t64(m_np), t64(n_np), t64(half), t64(pad)
    nb = (m + 63) // 64
    lb = (m - 1) // 64
    trace = torch.zeros((J, N, BW), dtype=torch.int8, device=dev)
    at_m = torch.full((J, N), INF, dtype=torch.int32, device=dev)   # row m's value a column

    s_all = torch.arange(FW, device=dev, dtype=torch.int32)
    s1 = s_all[1: BW + 1]
    F = s_all.expand(J, FW).clone()                   # column 0: row r holds r
    V = torch.full((J, FW), INF, dtype=torch.int32, device=dev)

    def band(jc):
        """Per (column, job): on, top block, frame rows in use."""
        rl, rh = jc - p - h, jc - p + h
        on = (jc >= 1) & (jc <= n) & (rh >= 1) & (rl <= m)
        bf = torch.where(rl <= 1, 0, floor64(rl - 1))
        bl = torch.minimum(nb - 1, floor64(torch.minimum(rh, m) - 1))
        return rl, rh, on, bf, bl, 64 * (bl - bf + 1)

    # a chunk's per-(column, job) inputs, and its outputs
    zc = lambda dt: torch.zeros((C, J), dtype=dt, device=dev)  # noqa: E731
    x = {k: zc(torch.bool) for k in ("shift", "on", "d1", "bf0", "ans", "hit1")}
    x.update({k: zc(torch.int32) for k in ("top_add", "S", "dlim", "llim", "lr1", "bf64")})
    x.update({k: zc(torch.int64) for k in ("qbase", "aidx")})
    x["tc"] = zc(torch.int8)
    codes = torch.zeros((C, J, BW), dtype=torch.int8, device=dev)
    vals = torch.zeros((C, J), dtype=torch.int32, device=dev)

    def fill(c):
        if c is None:      # nothing on: the frame keeps its values
            for v in x.values():
                v.zero_()
            return
        jc = torch.arange(c * C + 1, (c + 1) * C + 1, device=dev)[:, None]
        rl, rh, on, bf, bl, S = band(jc)
        _, _, on_p, bf_p, _, S_p = band(jc - 1)
        col0 = jc == 1
        hi_p = S_p - 64 * (bf - bf_p)
        d1 = col0 | (bf == 0) | (on_p & (bf > bf_p) & (hi_p >= 0))
        tc = T[c * C: (c + 1) * C]
        for k, v in (("shift", on & on_p & (bf > bf_p)), ("on", on), ("d1", d1),
                     ("bf0", bf == 0), ("top_add", bf > 0), ("S", S),
                     ("dlim", torch.where(col0, BIG, torch.where(on_p, hi_p + 1, 0))),
                     ("llim", torch.where(col0, BIG, torch.where(on_p, hi_p, 0))),
                     ("lr1", torch.where(d1, 0, torch.where(bf == 0, 1, 3))),
                     ("bf64", 64 * bf), ("hit1", Q[:, 0][None] == tc),
                     ("ans", on & (lb >= bf) & (lb <= bl) & (rl <= m) & (m <= rh)),
                     ("qbase", 64 * bf - 1), ("aidx", (m - 64 * bf).clamp(0, FW - 1)),
                     ("tc", tc)):
            x[k].copy_(v)

    def columns():
        for t in range(C):
            F.copy_(torch.where(x["shift"][t][:, None], torch.roll(F, -64, dims=1), F))
            qc = Q.gather(1, (x["qbase"][t][:, None] + s1).clamp_(0, QW - 1))
            diag = F[:, :BW] + (qc != x["tc"][t][:, None])
            left = F[:, 1: BW + 1] + 1
            torch.minimum(diag, left, out=V[:, 1: BW + 1])
            V[:, 0] = F[:, 0] + x["top_add"][t]
            V.masked_fill_(x["S"][t][:, None] < s_all, INF)
            D = torch.cummin(V - s_all, dim=1).values + s_all
            Dn, Du = D[:, 1: BW + 1], D[:, :BW]
            okd = s1 <= x["dlim"][t][:, None]
            okd[:, 0] = x["d1"][t]
            cu = Du + 1 == Dn
            cu[:, 0] &= x["bf0"][t]
            cl = (left == Dn) & (s1 <= x["llim"][t][:, None])
            fb = (~okd).to(torch.int8)
            # the band's first row above its first block: a climb (3 or 4)
            lr1 = x["lr1"][t]
            fb[:, 0] = lr1 + ((lr1 == 3) & (Dn[:, 0] - x["bf64"][t] == 1) & x["hit1"][t])
            codes[t] = torch.where((diag == Dn) & okd, 0, torch.where(cu, 1, torch.where(
                cl, 2, fb)))
            F.copy_(torch.where(x["on"][t][:, None], D, F))
            vals[t] = torch.where(x["ans"][t], D.gather(1, x["aidx"][t][:, None])[:, 0], INF)

    def store(c):
        w = min(C, N - c * C)
        trace[:, c * C: c * C + w] = codes[:w].transpose(0, 1)
        at_m[:, c * C: c * C + w] = vals[:w].T

    _chunks(dev, n_chunks, fill, columns, store)
    # the alignment's end: the first least cost in row m (column 0 first)
    least = at_m.min(dim=1).values.to(torch.int64)
    first = torch.where(at_m == least[:, None].to(torch.int32),
                        torch.arange(N, device=dev), N).min(dim=1).values + 1
    at0 = m + p - h <= 0
    best = torch.where(at0 & (m <= least), m, least)
    jbest = torch.where(at0 & (m <= least), 0, first)

    # the walk back, every job a step at a time: a step reads the code of
    # the job's cell and moves by it. The codes taken are kept; a climb (its
    # code the last) and a stop at column 0 above row 0 become the head of
    # the CIGAR on the host
    walking = (best < INF) & (jbest > 0)
    i, jj = m.clone(), jbest.clone()
    steps = int((m + jbest).max().item()) if J else 0
    n_walk = -(-steps // C)
    ops = torch.full((max(n_walk, 1) * C, J), -1, dtype=torch.int8, device=dev)
    flat = trace.view(-1)
    cols = torch.arange(N + 1, device=dev)[None]
    c_ = cols - (p + h)[:, None]
    # flat index of (job, column, frame slot 0) less row 64 bf + 1, a column
    # at a time: a cell's code is at base[job, column] + row
    base = (torch.arange(J, device=dev)[:, None] * (N * BW) + (cols - 1) * BW
            - 64 * torch.where(c_ <= 1, 0, floor64(c_ - 1)) - 1)
    last = J * N * BW - 1
    # moves by code + 1 (-1 none, 0 M, 1 I, 2 D, 3 a climb ending in M, 4 in I)
    d_i = torch.tensor([0, 1, 1, 0, 0, 0], device=dev)
    d_j = torch.tensor([0, 1, 0, 1, 1, 0], device=dev)
    taken = torch.zeros((C, J), dtype=torch.int8, device=dev)
    kept = walking.clone()

    def start(c):
        if c is None:      # nobody walks: no state moves
            walking.zero_()
        elif c == 0:
            walking.copy_(kept)

    def walk():
        for t in range(C):
            at = (base.gather(1, jj[:, None])[:, 0] + i).clamp_(0, last)
            code = torch.where(walking, flat[at], -1)
            taken[t] = code
            k = code.to(torch.int64) + 1
            i.sub_(d_i[k])
            jj.sub_(d_j[k])
            walking.logical_and_((code < 3) & (i > 0) & (jj > 0))

    def keep(c):
        ops[c * C: (c + 1) * C] = taken

    _chunks(dev, n_walk, start, walk, keep)
    cost = torch.where(best < INF, best, -1).cpu().numpy()
    tstart = jj.cpu().numpy()
    tend = jbest.cpu().numpy()
    i = i.cpu().numpy()
    ops_np = ops.cpu().numpy().T
    runs = []
    for r in range(J):
        if cost[r] < 0:
            runs.append((np.zeros(0, np.int64), np.zeros(0, np.int64)))
            continue
        walked = ops_np[r][: int((ops_np[r] >= 0).sum())].astype(np.int64)
        head = []
        if walked.shape[0] and walked[-1] >= 3:        # the climb: I up to row 1, then M or I
            head = [walked[-1:] - 3, np.ones(int(i[r]) - 1, np.int64)]
            walked = walked[:-1]
        elif i[r] > 0:                                   # column 0: I up to row 0
            head = [np.ones(int(i[r]), np.int64)]
        seq = np.concatenate(head + [walked[::-1]])
        starts = np.concatenate([[0], np.flatnonzero(np.diff(seq)) + 1])
        runs.append((np.diff(np.concatenate([starts, [seq.shape[0]]])), seq[starts]))
    return cost, tstart, tend, runs


def banded_align(qs: list, ts: list, half, pad, device) -> tuple:
    """``_dp_block`` over any number of jobs, in blocks of jobs by window
    length (bands over 512 rows apart) whose traceback codes (jobs x
    columns x frame rows) stay within ``DP_BLOCK_BYTES``."""
    dev = torch.device(device)
    J = len(qs)
    half = np.asarray(half, np.int64)
    pad = np.asarray(pad, np.int64)
    if np.any(half < 32):
        raise ValueError("banded_align: a band half-width below 32 is outside the port's plan")
    cost = np.full(J, -1, np.int64)
    tstart = np.zeros(J, np.int64)
    tend = np.zeros(J, np.int64)
    runs = [(np.zeros(0, np.int64), np.zeros(0, np.int64))] * J
    n = np.array([len(t) for t in ts], np.int64)
    m = np.array([len(q) for q in qs], np.int64)
    bw = 64 * ((2 * half) // 64 + 2)
    todo = np.flatnonzero((m > 0) & (n > 0))
    todo = todo[np.lexsort((n[todo], bw[todo] > 512))]
    budget = DP_BLOCK_BYTES.get(dev.type, DP_BLOCK_BYTES["cpu"])
    ratio = DP_BLOCK_RATIO.get(dev.type, 1 << 30)
    s = 0
    while s < len(todo):
        e, wide = s + 1, int(bw[todo[s]])
        while (e < len(todo) and e - s < DP_BLOCK_JOBS and n[todo[e]] <= ratio * n[todo[s]]
               and (bw[todo[e]] > 512) == (bw[todo[s]] > 512)):
            w = max(wide, int(bw[todo[e]]))
            if (e + 1 - s) * int(n[todo[e]]) * w > budget:
                break
            wide = w
            e += 1
        blk = todo[s:e]
        c, a, b, rr = _dp_block([qs[x] for x in blk], [ts[x] for x in blk], half[blk],
                                pad[blk], dev)
        cost[blk], tstart[blk], tend[blk] = c, a, b
        for x, r in zip(blk, rr):
            runs[x] = r
        s = e
    return cost, tstart, tend, runs


# --------------------------------------------------------------- mapping --

class RefAligner:
    """The port's aligner on ``genome`` (``layout.Genome``) at (k, w,
    min_votes), on ``device``."""

    def __init__(self, genome: Genome, k: int, w: int, min_votes: int, device, mu: int = 400,
                 max_divergence: float = MAX_DIVERGENCE):
        self.g, self.k, self.w, self.min_votes = genome, k, w, min_votes
        self.mu, self.max_divergence = mu, max_divergence
        self.dev = torch.device(device)
        self.index = Index(genome, k, w, self.dev)
        self.target = np.where(genome.site_valid, genome.seq, 4).astype(np.int8)
        self.starts = genome.offsets.astype(np.int64)
        self.ends = (genome.offsets + genome.lengths).astype(np.int64)

    def _plan(self, s: dict, mlen: np.ndarray, min_len: int) -> dict:
        k, v = self.k, s["votes"]
        n, C = v.shape
        lo = s["qmin"]
        hi = np.minimum(mlen[:, None], s["qmax"] + k)
        voted = np.logical_and.accumulate(v >= self.min_votes, axis=1)
        span = hi - lo
        inter = (np.minimum(hi[:, :, None], hi[:, None, :])
                 - np.maximum(lo[:, :, None], lo[:, None, :]))
        short = np.maximum(1, np.minimum(span[:, :, None], span[:, None, :]))
        ovl = 2 * np.maximum(inter, 0) >= short
        use = np.zeros((n, C), bool)
        use[:, 0] = voted[:, 0]
        for c in range(1, C):
            clash = (ovl[:, c, :c] & use[:, :c]).any(axis=1)
            use[:, c] = voted[:, c] & (~clash | (2 * v[:, c] >= v[:, 0]))
        mid = lo + hi
        sib = use[:, :, None] & use[:, None, :] & ~ovl & ~np.eye(C, dtype=bool)[None]
        left = sib & (mid[:, None, :] < mid[:, :, None])
        right = sib & ~(mid[:, None, :] < mid[:, :, None])
        qs = np.where(left, np.minimum(lo[:, :, None], (hi[:, None, :] + lo[:, :, None]) // 2),
                      0).max(axis=2)
        qe = np.where(right, np.maximum(hi[:, :, None], (hi[:, :, None] + lo[:, None, :]) // 2),
                      mlen[:, None, None]).min(axis=2)
        slen = qe - qs
        several = use.sum(axis=1) > 1
        use &= slen >= 50
        cut = several[:, None] & ((qs > 0) | (qe < mlen[:, None]))
        over = np.where(cut, np.maximum(np.maximum(lo - qs, qe - hi), 0), 0)
        half = np.clip(s["dspan"] // 2 + 48 + slen // 200 + over, 64, 1024)
        tsp = np.where(s["strand"] == 0, s["bkey"] + qs, s["bkey"] - qe + k)
        cid = np.clip(np.searchsorted(self.starts, np.maximum(tsp, 0), side="right") - 1, 0,
                      len(self.starts) - 1)
        ws = np.maximum(self.starts[cid], tsp - half - 16)
        we = np.minimum(self.ends[cid], tsp + slen + half + 16)
        use &= (we - ws) >= min_len
        rival = ovl & (v > 0)[:, None, :] & ~np.eye(C, dtype=bool)[None]
        second = np.where(rival, v[:, None, :], 0).max(axis=2)
        uniq = 1.0 - np.minimum(1.0, second / np.maximum(1, v))
        mapq = np.where(v >= 2 * self.min_votes, np.minimum(60, 60 * uniq),
                        30 * uniq).astype(np.int64)
        return dict(use=use, qs=qs, qe=qe, half=half, tsp=tsp, ws=ws, we=we, mapq=mapq)

    def map(self, reads: dict, trunc: bool = False, min_len: int | None = None) -> dict:
        """{read id: its primary records, in candidate order}; a record is a
        dict of the PAF fields, its CIGAR a cg:Z string."""
        min_len = self.mu // 2 if min_len is None else min_len
        rids = list(reads)
        codes = [encode(reads[r][: self.mu] if trunc else reads[r]) for r in rids]
        out = {r: [] for r in rids}
        if not rids:
            return out
        s = seed(codes, self.index, self.dev)
        mlen = np.array([len(c) for c in codes], np.int64)
        p = self._plan(s, mlen, min_len)
        use = p["use"] & (mlen >= 50)[:, None]
        jr, jc = np.nonzero(use)
        if jr.shape[0] == 0:
            return out
        qs, qe = p["qs"][jr, jc], p["qe"][jr, jc]
        strand = s["strand"][jr, jc]
        segs = []
        for r, a, b, st in zip(jr, qs, qe, strand):
            seg = codes[r][a:b]
            segs.append(_COMPLEMENT[seg][::-1] if st else seg)
        ws, we = p["ws"][jr, jc], p["we"][jr, jc]
        pad = np.maximum(p["tsp"][jr, jc] - ws, 0)
        cost, a0, b0, runs = banded_align(segs, [self.target[x:y] for x, y in zip(ws, we)],
                                          p["half"][jr, jc], pad, self.dev)
        slen = qe - qs
        mapq = p["mapq"][jr, jc]
        s1 = s["votes"][jr, jc]
        kept = []
        for x in range(jr.shape[0]):
            lens, ops = runs[x]
            if cost[x] < 0 or lens.shape[0] == 0:
                continue
            if not cost[x] <= self.max_divergence * max(int(slen[x]), 1):
                continue
            lo, hi = 0, lens.shape[0]
            clip_s = int(lens[0]) if ops[0] == 1 else 0
            lo += ops[0] == 1
            clip_e = int(lens[-1]) if hi - 1 >= lo and ops[-1] == 1 else 0
            hi -= clip_e > 0
            if hi <= lo:
                continue
            ts, te = int(ws[x] + a0[x]), int(ws[x] + b0[x])
            if te - ts < min_len:
                continue
            c = int(np.searchsorted(self.starts, ts, side="right")) - 1
            if c < 0 or ts >= self.ends[c] or te > self.ends[c]:
                continue
            L, O = lens[lo:hi], ops[lo:hi]
            n_m, n_i, n_d = (int(L[O == o].sum()) for o in range(3))
            mism = int(cost[x]) - (n_i + n_d + clip_s + clip_e)
            nmatch = max(0, n_m - max(0, mism))
            if strand[x]:  # the segment was reverse-complemented: its head clip is the read's end
                q0, q1 = int(qs[x]) + clip_e, int(qe[x]) - clip_s
            else:
                q0, q1 = int(qs[x]) + clip_s, int(qe[x]) - clip_e
            kept.append(dict(
                read=int(jr[x]), qname=rids[jr[x]], qlen=int(mlen[jr[x]]), qstart=q0, qend=q1,
                rev=int(strand[x]), tname=self.g.names[c], tlen=int(self.g.lengths[c]),
                tstart=ts - int(self.starts[c]), tend=te - int(self.starts[c]), nmatch=nmatch,
                blocklen=n_m + n_i + n_d, mapq=int(mapq[x]), align_score=2 * nmatch - int(cost[x]),
                s1=int(s1[x]), primary=1,
                cigar="".join(f"{a}{b}" for a, b in zip(L.tolist(), _OPS[O].tolist()))))
        by_read: dict[int, list] = {}
        for rec in kept:
            by_read.setdefault(rec["read"], []).append(rec)
        for r, recs in by_read.items():
            order = sorted(range(len(recs)), key=lambda i: (-recs[i]["mapq"],
                                                             -recs[i]["align_score"], i))
            spans = []
            prim = set()
            for i in order:
                a, b = recs[i]["qstart"], recs[i]["qend"]
                if all(2 * (min(b, y) - max(a, x)) < max(1, min(b - a, y - x)) for x, y in spans):
                    spans.append((a, b))
                    prim.add(i)
            out[rids[r]] = [{k: v for k, v in recs[i].items() if k != "read"}
                            for i in range(len(recs)) if i in prim]
        return out


def best_paf(records: dict) -> dict:
    """{read id: (qlen, qstart, qend, rev, tname, tstart, tend, cigar)} of
    each read's best record, highest (mapq, score) and the last of full
    ties, as ``dataplane.read_paf`` gives a PAF file's."""
    out = {}
    for rid, recs in records.items():
        best = None
        for rec in recs:
            key = (rec["mapq"], rec["align_score"])
            if best is None or key >= best[0]:
                best = (key, rec)
        if best is not None:
            r = best[1]
            out[rid] = (r["qlen"], r["qstart"], r["qend"], bool(r["rev"]), r["tname"],
                        r["tstart"], r["tend"], r["cigar"].encode())
    return out
