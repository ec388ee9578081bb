"""Seed lookup + diagonal voting on PyTorch: the device half of the aligner.

The port of ``bossruns_tpu.aligner.seed`` (its ``_seed_topn_jit``, K8, and
``_seed_candidates_jit``, K9, and the host entry points around them).
It replaces minimap2's seed-and-chain stage (the reference calls mappy's C
implementation per read in a thread pool). A length bucket of reads is one
padded [R, L] int8 code matrix (0..3, 4 = N or padding), shipped to the
device 4 bits a base (``pack_reads``: [R, L//8] words, base j of word i at
bits 4*(j % 8), byte for byte the JAX package's payload) and decoded where
the kernels load it. Per read:

  1. 2-bit forward and reverse-complement k-mer codes, validity (no N in
     the window, not palindromic), canonical code, strand;
  2. a 31-bit mix hash and (k, w) window minima pick canonical minimizers —
     the same scheme as the host-built index, so read and reference select
     the same minimizers;
  3. the first ``budget`` minimizers (position order) are kept;
  4. each is looked up by binary search in the index's sorted keys, and up
     to OCC_CAP occurrences of a hit become anchors: forward-space diagonal
     (gpos - qpos) on the same strand, reverse-space (gpos + qpos) on the
     other, SENTINEL elsewhere;
  5. each strand space is sorted by (diagonal, anchor slot) and cut to its
     ``cw`` smallest diagonals; anchors vote over two staggered grids of
     width 2*DIAG_TOL; NCAND clusters are peeled jointly over both spaces.

The result is one int32 [len(SEED_FIELDS) * ncand, R] block: row c*6 + i
holds field i of candidate c, exactly as ``_seed_topn_jit`` lays it out.

``seed_topn`` takes the packed payload: a CPU tensor takes
``seed_topn_plain`` (``unpack_reads``, then PyTorch, any device), a CUDA
tensor launches kernel H5 (``csrc/seed.cu``) or raises. The plain version
sorts with ``stable=True``, the kernel by the (diagonal, slot) pair, so
both keep the same anchors when a read has more than ``cw`` real ones.

``seed_candidates`` is the all-vs-all seeding of the AEONS overlap search
(K9): stages 1-4 as above, then each strand space on its own is sorted by
(diagonal, slot) with the read and genome positions as payload, cut to
``cw``, voted with the caller's tolerance and peeled ``ncand`` times. Its
result is one int32 [R, len(CAND_FIELDS), 2 * ncand] block, column
s * ncand + c holding round c of space s, as ``_seed_candidates_jit`` lays
it out. A CPU tensor takes ``seed_candidates_plain``, a CUDA tensor
launches kernel H6 (``csrc/seed.cu``) or raises.

The link: a call's buckets (rows of a flat code array, each cut or padded
to its bucket's L) are packed into one host buffer, each at its own
offset, which then ``land``s on the index's device with one copy, each
bucket's payload a view of it. On the card that buffer is pinned staging
(``utils.staging.PinnedStaging``), the kernel library's host loop packs
straight into it, and the copy is non-blocking on the current stream, so a
caller queues it and every bucket's launch without waiting for the card;
an upload that is not from staging raises. On the CPU the rows are padded
and packed in NumPy, and the packed words themselves are the tensors.
``upload_reads`` does all of it for padded matrices; ``encode_rows``
encodes a batch's text and stages its rows in one pass, for the aligner,
whose dispatch then only lands the buffer and launches. ``seed_and_vote`` and
``seed_candidates_from_numpy`` are the JAX package's host entry points
(``seed_and_vote``, ``seed_candidates``): a host matrix in, one pull out.

Left out of the JAX module: ``_pad_hysteresis`` and the row tiers of its
callers (power-of-two padding against XLA recompiles; H5 and H6 compile
once for every shape, and the port's index keeps its own size).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels as K
from .index import K as K_DEFAULT
from .index import W, MinimizerIndex

ANCHOR_BUDGET = 1024   # minimizer slots kept per read (A)
OCC_CAP = 4            # index occurrences used per minimizer (C)
DIAG_TOL = 256         # diagonal clustering tolerance (bases)
SENTINEL = int(2**31 - 2**24)  # beyond any real diagonal
NCAND = 4              # diagonal clusters peeled per read
SEED_FIELDS = ("strand", "bkey", "votes", "dspan", "qmin", "qmax")
CAND_FIELDS = ("votes", "strand", "qmin", "qmax", "tmin", "tmax")

INT32_MAX = int(np.iinfo(np.int32).max)
PACK_PAD = -1          # pos_packed slot with no occurrence (0xFFFFFFFF as int32)
_M32 = 0xFFFFFFFF
_BIG = 1 << 30


def _pow2(n: int, floor: int = 1 << 10) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def anchor_budget(L: int, w: int, cap: int = ANCHOR_BUDGET) -> int:
    """Minimizer-slot budget for reads of padded length L: expected density
    is 2/(w+1) positions, so a power of two just above that (plus slack)
    loses no anchors while keeping the vote sorts ~L/w wide."""
    need = int(2.2 * L / (w + 1)) + 16
    return min(_pow2(need, floor=64), cap)


# ------------------------------------------------------------ the payload --


def pack_reads(mat: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """[R, L] base codes (0..4) -> [R, L//8] uint32, 4 bits a base: base j
    of word i at bits 4*(j % 8), byte for byte the JAX package's
    ``pack_reads``. ``out``: a C-contiguous 4-byte [R, L//8] array to write
    into (a slice of a staging buffer), returned.

    The kernels read the words as int32 (torch has no uint32 arithmetic,
    ROADMAP F2): a code is at most 4, so the top nibble never sets the sign
    bit, and a code outside 0..4 raises. L must be a multiple of 8 (every
    length bucket is)."""
    mat = np.asarray(mat)
    r, L = mat.shape
    if L % 8:
        raise ValueError(f"pack_reads: L={L} is not a multiple of 8")
    if mat.dtype == np.int8 or mat.dtype == np.uint8:
        m = mat.view(np.uint8)               # a negative int8 code reads as >= 128
        bad = m.size and int(m.max()) > 4
    else:
        bad = mat.size and (int(mat.min()) < 0 or int(mat.max()) > 4)
        m = mat.astype(np.uint8)
    if bad:
        raise ValueError("pack_reads: base codes must lie in 0..4")
    if out is None:
        out = np.empty((r, L // 8), np.uint32)
    if out.shape != (r, L // 8) or out.itemsize != 4 or not out.flags.c_contiguous:
        raise ValueError(f"pack_reads: out must be a contiguous 4-byte [{r}, {L // 8}] array")
    # two codes a byte, low nibble first: read as little-endian uint16, a
    # pair of codes (lo, hi) is lo + 256 * hi, and (x | x >> 4) holds
    # lo | hi << 4 in its low byte. The bytes of a word are then its bases
    # 0-1, 2-3, 4-5, 6-7: the JAX layout (on a little-endian host)
    pairs = np.ascontiguousarray(m).view("<u2")
    low = pairs >> 4
    low |= pairs
    np.copyto(out.view(np.uint8).reshape(r, L // 2), low, casting="unsafe")
    return out


def unpack_reads(packed: torch.Tensor, L: int) -> torch.Tensor:
    """The plain decode of ``pack_reads``: int32 [R, L//8] words on any
    device -> [R, L] int8 codes."""
    shifts = torch.arange(0, 32, 4, dtype=torch.int32, device=packed.device)
    x = (packed[:, :, None] >> shifts) & 0xF
    return x.reshape(packed.shape[0], L).to(torch.int8)


def pack_rows(codes: np.ndarray, start: np.ndarray, length: np.ndarray, L: int,
              out: np.ndarray, *, compiled: bool = False) -> np.ndarray:
    """Rows of the flat code array ``codes`` (0..4) packed as ``pack_reads``
    packs their [R, L] matrix: row r is the ``length[r]`` codes at
    ``codes[start[r]:]``, cut or padded (code 4) to L. Written into the
    4-byte [R, L//8] ``out``, returned. ``compiled``: the kernel library's
    host loop (csrc/seed.cu ``bk_pack_rows``, one pass from the codes into
    ``out``; built with the kernels, so only where they are), else the
    padded matrix in NumPy and ``pack_reads``."""
    R = len(start)
    if compiled:
        return _host_pack(np.ascontiguousarray(codes, np.int8), None, start, length, L, out)
    mat = np.full((R, L), 4, np.int8)
    for r, (s0, n) in enumerate(zip(start, length)):
        n = min(int(n), L)
        mat[r, :n] = codes[s0: s0 + n]
    return pack_reads(mat, out=out)


def _host_pack(src: np.ndarray, codes_out: np.ndarray | None, start, length, L: int,
               out: np.ndarray) -> np.ndarray:
    """The library's host loop (csrc/seed.cu ``bk_pack_rows``) on rows of
    ``src``: codes, or with ``codes_out`` text that it also encodes there."""
    start = np.ascontiguousarray(start, np.int64)
    length = np.ascontiguousarray(length, np.int64)
    R = start.shape[0]
    if out.shape != (R, L // 8) or out.itemsize != 4 or not out.flags.c_contiguous:
        raise ValueError(f"pack_rows: out must be a contiguous 4-byte [{R}, {L // 8}] array")
    K.HOST["pack_rows"](src.ctypes.data, int(codes_out is not None),
                        None if codes_out is None else codes_out.ctypes.data,
                        start.ctypes.data, length.ctypes.data, R, L, out.ctypes.data)
    return out


def _stage(shapes: list[tuple], dev_index: "DeviceIndex") -> tuple:
    """A host buffer for payloads of the given [R, W] shapes, each at its
    own offset: on the card one of the index's two pinned staging buffers,
    taken in turns; on the CPU a new array. (buffer, the payloads' views.)"""
    bounds = np.cumsum([0, *(r * w for r, w in shapes)])
    st = dev_index.staging
    host = np.empty(bounds[-1], np.uint32) if st is None else st.take(int(bounds[-1]))
    return host, [host[a: z].reshape(shape)
                  for a, z, shape in zip(bounds[:-1], bounds[1:], shapes)]


def land(staged: tuple, dev_index: "DeviceIndex") -> list[torch.Tensor]:
    """A ``_stage`` buffer on the index's device with one copy, each payload
    a view of it (on the card non-blocking on the current stream, so every
    launch on a payload queues behind the copy, and nothing waits)."""
    host, outs = staged
    dev = put_packed(host, dev_index)
    views, a = [], 0
    for o in outs:
        views.append(dev[a: a + o.size].view(o.shape))
        a += o.size
    return views


def encode_rows(text: bytes, buckets: list[tuple], dev_index: "DeviceIndex") -> tuple:
    """One pass over a batch's bases ``text`` for the aligner: (codes,
    staged). ``codes`` int8 [len(text)] are the aligner's encode of the text
    (``_ENC``: A/a 0, C/c 1, G/g 2, T/t 3, any other byte 4), which its
    host DP reads; ``staged`` is a ``_stage`` buffer holding each bucket's
    packed payload, for ``land``. A bucket is the (start, length, L) of its
    rows in the text, every base of the text in exactly one row. On the
    card the library's host loop encodes and packs row by row, straight
    into pinned staging; on the CPU NumPy encodes, then ``pack_rows``."""
    staged = _stage([(len(b[0]), b[2] // 8) for b in buckets], dev_index)
    raw = np.frombuffer(text, np.uint8)
    if dev_index.device.type != "cuda":
        from . import _ENC

        codes = _ENC[raw]
        for (start, length, L), out in zip(buckets, staged[1]):
            pack_rows(codes, start, length, L, out)
        return codes, staged
    codes = np.empty(raw.shape[0], np.int8)
    for (start, length, L), out in zip(buckets, staged[1]):
        _host_pack(raw, codes, start, length, L, out)
    return codes, staged


def upload_reads(mats: list[np.ndarray], dev_index: "DeviceIndex") -> list[torch.Tensor]:
    """Each padded [R, L] code matrix's packed payload, int32 [R, L//8], on
    the index's device: packed into one ``_stage`` buffer (``pack_rows``,
    on the card by the library's host loop) and ``land``ed with one copy."""
    staged = _stage([(m.shape[0], m.shape[1] // 8) for m in mats], dev_index)
    compiled = dev_index.device.type == "cuda"
    for m, out in zip(mats, staged[1]):
        R, L = m.shape
        pack_rows(m.reshape(-1), np.arange(R) * L, np.full(R, L), L, out, compiled=compiled)
    return land(staged, dev_index)


def put_packed(packed: np.ndarray, dev_index: "DeviceIndex") -> torch.Tensor:
    """``packed`` on the index's device as int32. With staging (always on
    the card) it must lie in one of the staging buffers, and lands with one
    non-blocking copy on the current stream; anything else raises (no
    pageable copy). Without, the host words themselves."""
    st = dev_index.staging
    if st is None:
        return torch.from_numpy(packed.view(np.int32))
    dst = torch.empty(packed.shape, dtype=torch.int32, device=dev_index.device)
    if not st.upload(packed, dst):
        raise ValueError("upload of reads that were not packed into the index's staging")
    return dst


class DeviceIndex:
    """The minimizer index on ``device``.

    ``keys`` [U] int32 sorted distinct canonical codes. ``pos_packed``
    [U, OCC_CAP] int32 holds the uint32 bit pattern (position << 1) | strand
    of a key's first OCC_CAP occurrences, PACK_PAD (-1) where a key has
    fewer: a fixed stride per key turns the anchor fetch into one
    contiguous 16-byte load indexed by the key's rank. An empty index keeps
    one INT32_MAX key with no occurrence, which no 30-bit query matches.

    ``bucket_off`` [2^T + 1] int32 is a direct-address table on the keys'
    top T bits (T about log2 of the key count, at most 2k): the keys whose
    code >> ``shift`` is j are ``keys[bucket_off[j]:bucket_off[j + 1]]``, so
    the kernels find a key in a bucket of about one key instead of a search
    of the whole table.
    ``max_pos`` is the largest indexed position.

    ``staging`` (on a CUDA device; None on the CPU) holds the two pinned
    buffers the reads seeded against this index are packed into
    (``upload_reads``).
    """

    def __init__(self, idx: MinimizerIndex, device: str | torch.device):
        from ..device import as_device
        from ..utils.staging import PinnedStaging

        assert idx.positions.max(initial=0) < 2**31
        self.device = as_device(device)
        self.staging = PinnedStaging() if self.device.type == "cuda" else None
        self.k, self.w = idx.k, idx.w
        nk = int(idx.keys.shape[0])
        self.n_keys = nk
        keys = np.full(max(nk, 1), INT32_MAX, np.int32)
        keys[:nk] = idx.keys
        packed = np.full((max(nk, 1), OCC_CAP), 0xFFFFFFFF, np.uint32)
        off = idx.offsets
        pos_u = idx.positions.astype(np.uint32)
        str_u = idx.strands.astype(np.uint32)
        cnt = np.minimum(off[1:] - off[:-1], OCC_CAP).astype(np.int64)
        for c in range(OCC_CAP):
            rows = np.flatnonzero(cnt > c)
            src = off[rows] + c
            packed[rows, c] = (pos_u[src] << np.uint32(1)) | str_u[src]
        self.keys = torch.from_numpy(keys).to(self.device)
        self.pos_packed = torch.from_numpy(packed.view(np.int32)).to(self.device)
        self.max_pos = int(idx.positions.max(initial=0))
        bits = 2 * self.k
        t = min(bits, max(8, nk.bit_length()))
        self.shift = bits - t
        nbk = 1 << t
        # the padding key of an empty index lands in the last bucket
        cnt = torch.bincount((self.keys.long() >> self.shift).clamp_max(nbk - 1), minlength=nbk)
        self.bucket_off = torch.cat([cnt.new_zeros(1), torch.cumsum(cnt, 0)]).to(torch.int32)


# ------------------------------------------------------------ plain stages --


def hash31(x: torch.Tensor) -> torch.Tensor:
    """31-bit selection hash of non-negative int64 codes; MUST match
    index.selection_hash. uint32 wraparound done in int64 with a 32-bit
    mask (torch has no uint32 multiply on the CPU)."""
    h = x & _M32
    h = h ^ (h >> 16)
    h = (h * 0x45D9F3B) & _M32
    h = h ^ (h >> 16)
    h = (h * 0x45D9F3B) & _M32
    h = h ^ (h >> 16)
    return h >> 1


def read_minimizers(reads: torch.Tensor, k: int = K_DEFAULT, w: int = W):
    """Canonical minimizers of a padded read matrix.

    reads: [R, L] int8 codes (0..3, >= 4 pad/N). Returns (canonical [R, n]
    int64, strand [R, n] int64, is_min [R, n] bool) with n = L - k + 1.
    """
    r, L = reads.shape
    n = L - k + 1
    c = reads.to(torch.int64)
    fwd = torch.zeros((r, n), dtype=torch.int64, device=reads.device)
    rc = torch.zeros_like(fwd)
    cmax = c[:, :n].clone()
    for j in range(k):
        fwd = (fwd << 2) | (c[:, j: j + n] & 3)
        rc = (rc << 2) | (3 - (c[:, k - 1 - j: k - 1 - j + n] & 3))
        cmax = torch.maximum(cmax, c[:, j: j + n])
    canonical = torch.minimum(fwd, rc)
    strand = (rc < fwd).to(torch.int64)
    valid = (cmax < 4) & (fwd != rc)
    h = torch.where(valid, hash31(canonical ^ (canonical >> 15)),
                    torch.full_like(fwd, INT32_MAX))
    # m2[i] = min(h[i-w+1 .. i+w-1]) over [0, n): every w-window holding i
    pad = torch.full((r, w - 1), INT32_MAX, dtype=torch.int64, device=reads.device)
    hp = torch.cat([pad, h, pad], dim=1)
    m2 = hp[:, : n]
    for j in range(1, 2 * w - 1):
        m2 = torch.minimum(m2, hp[:, j: j + n])
    return canonical, strand, valid & (h == m2)


def compact_minimizers(canonical, strand, is_min, budget: int = ANCHOR_BUDGET):
    """The first ``budget`` minimizer slots per read in position order (a
    read with fewer fills its tail with non-minimizer slots, not valid).
    Returns (ck, cs, cpos, cvalid), each [R, budget]."""
    r, n = canonical.shape
    posidx = torch.arange(n, dtype=torch.int64, device=canonical.device).expand(r, n)
    sort_key = torch.where(is_min, posidx, n + posidx)
    order = torch.argsort(sort_key, dim=1, stable=True)[:, :budget]
    take = lambda a: torch.gather(a, 1, order)  # noqa: E731
    return take(canonical), take(strand), order, take(is_min)


def lookup(keys: torch.Tensor, ck: torch.Tensor, valid: torch.Tensor):
    """Index lookup: (hit, rank) with rank the row of the last key <= the
    query (clamped at 0) — the rank and hit ``_lookup_join`` returns."""
    rank = torch.searchsorted(keys.to(torch.int64), ck, right=True) - 1
    rank = rank.clamp_min(0)
    hit = valid & (keys.to(torch.int64)[rank] == ck)
    return hit, rank


def _check_index(dev_index: DeviceIndex, L: int, dev) -> None:
    """Raise unless the index is on ``dev`` in the layout the kernels read,
    with every reverse-space diagonal (position + read offset) below
    SENTINEL, which the kernels' anchor compaction assumes."""
    K.check(dev_index.keys, "keys", torch.int32, None, dev)
    K.check(dev_index.pos_packed, "pos_packed", torch.int32,
            (dev_index.keys.shape[0], OCC_CAP), dev)
    K.check(dev_index.bucket_off, "bucket_off", torch.int32, None, dev)
    if dev_index.max_pos + L >= SENTINEL:
        raise ValueError(f"index positions up to {dev_index.max_pos} + read length {L} reach "
                         f"the diagonal sentinel {SENTINEL}")


def _floor_div(x: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(x, d, rounding_mode="floor")


def vote(keys_sorted: torch.Tensor, tol: int = DIAG_TOL) -> torch.Tensor:
    """votes[i] = anchors sharing i's best staggered diagonal bucket (grids
    of width 2*tol at offsets 0 and tol); -1 for SENTINEL keys.
    keys_sorted MUST be ascending per row."""
    r, n = keys_sorted.shape
    dev = keys_sorted.device
    idx = torch.arange(n, dtype=torch.int64, device=dev).expand(r, n)
    big = torch.full((r, 1), n, dtype=torch.int64, device=dev)

    def run_counts(bucket):
        newrun = torch.ones_like(bucket, dtype=torch.bool)
        newrun[:, 1:] = bucket[:, 1:] != bucket[:, :-1]
        start = torch.cummax(torch.where(newrun, idx, -1), dim=1).values
        nxt_src = torch.where(newrun, idx, n)
        suf_min = torch.flip(torch.cummin(torch.flip(nxt_src, [1]), dim=1).values, [1])
        nxt = torch.cat([suf_min[:, 1:], big], dim=1)
        return nxt - start

    width = 2 * tol
    votes = torch.maximum(run_counts(_floor_div(keys_sorted, width)),
                          run_counts(_floor_div(keys_sorted + tol, width)))
    return torch.where(keys_sorted < SENTINEL, votes, -1)


def seed_topn_plain(reads_packed: torch.Tensor, dev_index: DeviceIndex, k: int, w: int,
                    budget: int, L: int, ncand: int = NCAND) -> torch.Tensor:
    """Plain PyTorch version of H5 on any device: the packed payload
    int32 [R, L//8] -> int32 [len(SEED_FIELDS) * ncand, R], row for row
    ``_seed_topn_jit``."""
    assert reads_packed.shape[1] * 8 == L
    reads = unpack_reads(reads_packed, L)
    canonical, strand, is_min = read_minimizers(reads, k, w)
    ck, cs, cpos, cvalid = compact_minimizers(canonical, strand, is_min, budget)
    r, a = ck.shape
    hit, rank = lookup(dev_index.keys, ck.reshape(-1), cvalid.reshape(-1))
    hit = hit.view(r, a)
    packed = dev_index.pos_packed[rank.view(r, a)].to(torch.int64) & _M32  # [r, a, C]
    occ_ok = hit[:, :, None] & (packed != _M32)
    gpos = packed >> 1
    same = (packed & 1) == cs[:, :, None]
    cp = cpos[:, :, None]
    key_f0 = torch.where(occ_ok & same, gpos - cp, SENTINEL).reshape(r, a * OCC_CAP)
    key_r0 = torch.where(occ_ok & ~same, gpos + cp, SENTINEL).reshape(r, a * OCC_CAP)
    rp0 = cp.expand(r, a, OCC_CAP).reshape(r, a * OCC_CAP)

    # fwd and rev spaces stacked as rows i and r+i; sort by (key, slot) and
    # keep the cw smallest diagonals of each row
    cw = (a * OCC_CAP) // 2
    key_all, order = torch.sort(torch.cat([key_f0, key_r0]), dim=1, stable=True)
    key_fr = key_all[:, :cw]
    rp_fr = torch.gather(torch.cat([rp0, rp0]), 1, order[:, :cw])
    v = vote(key_fr)
    real = key_fr < SENTINEL

    rows = torch.arange(r, device=reads.device)
    out = []
    for _ in range(ncand):
        b = torch.argmax(v, dim=1)
        bv = v.gather(1, b[:, None])[:, 0]
        bk = key_fr.gather(1, b[:, None])[:, 0]
        rev = bv[r:] > bv[:r]
        votes_i = torch.maximum(bv[:r], bv[r:])
        key_i = torch.where(rev, bk[r:], bk[:r])
        row = rows + rev.to(torch.int64) * r            # the chosen space's row
        kc, rpc = key_fr[row], rp_fr[row]
        dist = (kc - key_i[:, None]).abs()
        in_cl = (dist <= DIAG_TOL) & real[row]
        dmax = torch.where(in_cl, kc, -_BIG).amax(dim=1)
        dmin = torch.where(in_cl, kc, _BIG).amin(dim=1)
        qmax = torch.where(in_cl, rpc, -_BIG).amax(dim=1)
        qmin = torch.where(in_cl, rpc, _BIG).amin(dim=1)
        out += [rev.to(torch.int64), key_i, votes_i, (dmax - dmin).clamp_min(0),
                qmin.clamp_min(0), qmax.clamp_min(0)]
        # peel: kill this cluster (and its fringe) on its strand only
        v[row] = torch.where(dist <= 2 * DIAG_TOL, -1, v[row])
    return torch.stack(out).to(torch.int32)


# ------------------------------------------------------------ kernel H5 --


def seed_topn(reads_packed: torch.Tensor, dev_index: DeviceIndex, k: int, w: int,
              budget: int, L: int, ncand: int = NCAND) -> torch.Tensor:
    """H5: top-``ncand`` diagonal clusters per read of the packed payload
    int32 [R, L//8], int32 [len(SEED_FIELDS) * ncand, R]. A CPU tensor takes
    the plain version; a CUDA tensor launches csrc/seed.cu (one launch) or
    raises."""
    if reads_packed.device.type == "cpu":
        return seed_topn_plain(reads_packed, dev_index, k, w, budget, L, ncand)
    r = reads_packed.shape[0]
    dev = reads_packed.device
    n = L - k + 1
    K.check(reads_packed, "reads_packed", torch.int32, (r, L // 8))
    _check_index(dev_index, L, dev)
    if not (1 <= k <= 15 and k == dev_index.k and 1 <= w <= 16 and w <= n and budget <= n
            and budget >= 64 and budget & (budget - 1) == 0 and budget <= ANCHOR_BUDGET
            and 1 <= ncand <= 8 and L % 8 == 0):
        raise ValueError(f"seed_topn: unsupported k={k} w={w} budget={budget} L={L} "
                         f"ncand={ncand}")
    out = torch.empty((len(SEED_FIELDS) * ncand, r), dtype=torch.int32, device=dev)
    if r == 0:
        return out
    K.KERNELS["seed_topn"](
        K.ptr(reads_packed), r, L, k, w, budget, ncand, K.ptr(dev_index.keys),
        K.ptr(dev_index.bucket_off), dev_index.shift, dev_index.bucket_off.shape[0] - 1,
        K.ptr(dev_index.pos_packed), K.ptr(out), K.stream_ptr(reads_packed),
    )
    return out


def seed_fields(packed: np.ndarray, ncand: int = NCAND) -> dict[str, np.ndarray]:
    """H5's [len(SEED_FIELDS) * ncand, R] block -> field -> [R, ncand]."""
    nf = len(SEED_FIELDS)
    return {f: np.stack([packed[c * nf + i] for c in range(ncand)], axis=1)
            for i, f in enumerate(SEED_FIELDS)}


def seed_and_vote(reads: np.ndarray, dev_idx: DeviceIndex, ncand: int = NCAND):
    """[R, L] padded HOST read matrix (int8 codes) -> per-read top-ncand
    candidate dict of [R, ncand] arrays (fields: SEED_FIELDS), as the JAX
    package's ``seed_and_vote``: candidate 0 is the best-voted cluster, and
    a read is unmapped when votes[:, 0] <= 0. The reads go packed through
    the index's staging (``upload_reads``), H5 runs on them, and the result
    comes back in one device-to-host copy."""
    L = int(reads.shape[1])
    (x,) = upload_reads([np.asarray(reads)], dev_idx)
    out = seed_topn(x, dev_idx, dev_idx.k, dev_idx.w, anchor_budget(L, dev_idx.w), L, ncand)
    return seed_fields(out.cpu().numpy(), ncand)


# ------------------------------------------------------------ kernel H6 --


def candidate_tol(L: int) -> int:
    """Default diagonal tolerance of all-vs-all seeding at padded length L:
    long sequences accumulate indel drift of about 1% of their length."""
    return max(DIAG_TOL, L // 32)


def seed_candidates_plain(reads_packed: torch.Tensor, dev_index: DeviceIndex,
                          ncand: int = NCAND, tol: int = DIAG_TOL) -> torch.Tensor:
    """Plain PyTorch version of H6 on any device: the packed payload int32
    [R, L//8] -> int32 [R, len(CAND_FIELDS), 2 * ncand], entry for entry
    ``_seed_candidates_jit`` (placeholders included: a round with no vote
    left reports votes -1 and the spans of the cluster around the space's
    first kept diagonal, +-2^30 when that is SENTINEL; nothing is clamped)."""
    k, w = dev_index.k, dev_index.w
    L = 8 * reads_packed.shape[1]
    canonical, strand, is_min = read_minimizers(unpack_reads(reads_packed, L), k, w)
    ck, cs, cpos, cvalid = compact_minimizers(canonical, strand, is_min, anchor_budget(L, w))
    r, a = ck.shape
    hit, rank = lookup(dev_index.keys, ck.reshape(-1), cvalid.reshape(-1))
    hit = hit.view(r, a)
    packed = dev_index.pos_packed[rank.view(r, a)].to(torch.int64) & _M32  # [r, a, C]
    occ_ok = hit[:, :, None] & (packed != _M32)
    gpos = packed >> 1
    same = (packed & 1) == cs[:, :, None]
    cp = cpos[:, :, None]
    rp0 = cp.expand(r, a, OCC_CAP).reshape(r, a * OCC_CAP)
    gp0 = gpos.reshape(r, a * OCC_CAP)
    cw = (a * OCC_CAP) // 2
    cols: list[list[torch.Tensor]] = [[] for _ in CAND_FIELDS]
    for space, key0 in ((0, torch.where(occ_ok & same, gpos - cp, SENTINEL)),
                        (1, torch.where(occ_ok & ~same, gpos + cp, SENTINEL))):
        keys_flat, order = torch.sort(key0.reshape(r, a * OCC_CAP), dim=1, stable=True)
        keys_flat, order = keys_flat[:, :cw], order[:, :cw]
        rp, gp = torch.gather(rp0, 1, order), torch.gather(gp0, 1, order)
        real = keys_flat < SENTINEL
        v = vote(keys_flat, tol)
        for _ in range(ncand):
            best = torch.argmax(v, dim=1, keepdim=True)
            bkey = keys_flat.gather(1, best)
            bvote = v.gather(1, best)[:, 0]
            dist = (keys_flat - bkey).abs()
            cl = (dist <= tol) & real
            for i, x in enumerate((
                bvote, torch.full_like(bvote, space),
                torch.where(cl, rp, _BIG).amin(dim=1), torch.where(cl, rp, -_BIG).amax(dim=1),
                torch.where(cl, gp, _BIG).amin(dim=1), torch.where(cl, gp, -_BIG).amax(dim=1),
            )):
                cols[i].append(x)
            v = torch.where(dist <= 2 * tol, -1, v)
    return torch.stack([torch.stack(c, dim=1) for c in cols], dim=1).to(torch.int32)


def seed_candidates(reads_packed: torch.Tensor, dev_index: DeviceIndex, ncand: int = NCAND,
                    tol: int | None = None) -> torch.Tensor:
    """H6: top-``ncand`` diagonal clusters per strand space of the packed
    payload int32 [R, L//8], int32 [R, len(CAND_FIELDS), 2 * ncand]; tol
    defaults to candidate_tol(L). A CPU tensor takes the plain version; a
    CUDA tensor launches csrc/seed.cu (one launch) or raises."""
    r, L = reads_packed.shape[0], 8 * reads_packed.shape[1]
    tol = candidate_tol(L) if tol is None else int(tol)
    if reads_packed.device.type == "cpu":
        return seed_candidates_plain(reads_packed, dev_index, ncand, tol)
    dev = reads_packed.device
    k, w = dev_index.k, dev_index.w
    n = L - k + 1
    budget = anchor_budget(L, w)
    K.check(reads_packed, "reads_packed", torch.int32, (r, L // 8))
    _check_index(dev_index, L, dev)
    if not (1 <= k <= 15 and 1 <= w <= 16 and w <= n and budget <= n
            and budget >= 64 and budget & (budget - 1) == 0 and budget <= ANCHOR_BUDGET
            and 1 <= ncand <= 8 and 1 <= tol <= (1 << 24) and L % 8 == 0):
        raise ValueError(f"seed_candidates: unsupported k={k} w={w} budget={budget} L={L} "
                         f"ncand={ncand} tol={tol}")
    out = torch.empty((r, len(CAND_FIELDS), 2 * ncand), dtype=torch.int32, device=dev)
    if r == 0:
        return out
    K.KERNELS["seed_candidates"](
        K.ptr(reads_packed), r, L, k, w, budget, ncand, tol, K.ptr(dev_index.keys),
        K.ptr(dev_index.bucket_off), dev_index.shift, dev_index.bucket_off.shape[0] - 1,
        K.ptr(dev_index.pos_packed), K.ptr(out), K.stream_ptr(reads_packed),
    )
    return out


def seed_candidates_from_numpy(reads: np.ndarray, dev_idx: DeviceIndex, ncand: int = 4,
                               tol: int | None = None) -> dict[str, np.ndarray]:
    """[R, L] padded HOST read matrix -> top diagonal clusters per strand
    space, field (CAND_FIELDS) -> [R, 2 * ncand]: the JAX package's host
    ``seed_candidates`` (the device-level ``seed_candidates`` above takes
    the packed payload). The reads go packed through the index's staging,
    H6 runs on them, and the result comes back in one device-to-host copy.
    tol: diagonal clustering tolerance, candidate_tol(L) by default."""
    from ..utils import spans

    (x,) = upload_reads([np.asarray(reads)], dev_idx)
    packed = seed_candidates(x, dev_idx, ncand=ncand, tol=tol).cpu().numpy()
    spans.count("bytes.d2h", packed.nbytes)
    return {f: packed[:, i] for i, f in enumerate(CAND_FIELDS)}
