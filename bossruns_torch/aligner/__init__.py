"""Read-to-reference aligner of the port (the mappy/minimap2 replacement).

Pipeline per batch: host encode -> seeding on the aligner's device
(``seed.seed_topn``: kernel H5 on CUDA, the plain PyTorch version on the
CPU) -> native banded-DP extension with CIGAR traceback
(native/banded_align.cpp, shared with the JAX package) -> PafRecords.

The port of ``bossruns_tpu.aligner``'s facade: ``TorchAligner`` is the
counterpart of ``TpuAligner`` and emits the same records. As in the
reference's Mapper, reads can yield several alignments: the top voted
diagonal clusters are DP-extended; split (chimeric) reads give several
primary records over disjoint query spans, repeat copies give secondary
records. ``map_sequences`` drops secondaries by default (the reference's
primary-only parse) and the live mapper plugin keeps them. mapq encodes the
uniqueness of a record's diagonal cluster against competing clusters over
the same query span.

This package imports nothing of its own at its top (submodules are
imported where they are used), so ``from bossruns_torch.aligner import
native`` — which the PAF parser does — never pulls in the seeding module.
"""
from __future__ import annotations

import logging
import os

import numpy as np

logger = logging.getLogger("boss_torch")

_ENC = np.full(256, 4, dtype=np.int8)
for _i, _b in enumerate(b"ACGT"):
    _ENC[_b] = _i
    _ENC[_b + 32] = _i
_RC = np.array([3, 2, 1, 0, 4], dtype=np.int8)

LENGTH_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 32768)

#: most read rows per seeding call, per length bucket: about 2M read
#: positions a call, so a batch of thousands of reads is a handful of
#: calls that queue on the device while the host extends earlier buckets.
#: A call's rows are its group's size (no padding to fixed row tiers: the
#: JAX package's ``tier_rows`` keeps XLA's compile cache warm, and H5
#: compiles once for every shape).
BUCKET_ROWS = {512: 4096, 1024: 2048, 2048: 1024, 4096: 512,
               8192: 256, 16384: 128, 32768: 64}

#: overlapping-span competitor candidates are DP-extended (and may be emitted
#: as secondary records) only at >= this vote ratio vs the best candidate
#: (minimap2's pri_ratio analogue); disjoint-span (split-read) candidates
#: bypass the ratio — each segment is its own primary.
SECONDARY_RATIO = 0.5
#: minimum query-span overlap fraction for two candidates to count as
#: alternatives of each other (vs segments of a split read)
OVERLAP_FRAC = 0.5


def encode(seq: str) -> np.ndarray:
    return _ENC[np.frombuffer(seq.encode(), dtype=np.uint8)]


def bucket_of(n: int) -> int:
    """The length bucket of an n-base read (longer reads are cut to the last)."""
    return next((b for b in LENGTH_BUCKETS if n <= b), LENGTH_BUCKETS[-1])


def length_groups(lens: np.ndarray) -> list[np.ndarray]:
    """The seeding calls of a batch of reads of lengths ``lens``: their
    indices in length order, in runs of one length bucket cut at
    ``BUCKET_ROWS``."""
    order = np.argsort(lens, kind="stable")
    bucket = np.minimum(np.searchsorted(LENGTH_BUCKETS, np.asarray(lens)[order]),
                        len(LENGTH_BUCKETS) - 1)
    groups = []
    for k in np.unique(bucket):
        lo, hi = np.searchsorted(bucket, [k, k + 1])
        step = BUCKET_ROWS[LENGTH_BUCKETS[k]]
        groups += [order[a: min(a + step, hi)] for a in range(lo, hi, step)]
    return groups


def make_aligner(layout, *, device, backend: str = "auto", **kw):
    """The aligner factory.

    backend 'auto' or 'device': ``TorchAligner`` seeding on ``device``
    (kernel H5 on a CUDA device). 'host': ``CpuAligner``, host seeding on a
    thread pool, with DP threads at the core count capped at 16. Both emit
    byte-identical records. There is no size cutoff between them yet: where
    host seeding beats the card has not been measured (PERF.md).
    """
    if backend in ("auto", "device"):
        return TorchAligner(layout, device=device, **kw)
    if backend == "host":
        from .cpu_baseline import CpuAligner

        kw.setdefault("threads", max(2, min(os.cpu_count() or 4, 16)))
        return CpuAligner(layout, **kw)
    raise ValueError(f"unknown aligner backend {backend!r}")


def _overlap_frac(a: tuple[int, int], b: tuple[int, int]) -> float:
    """Overlap of two query intervals as a fraction of the shorter one."""
    inter = min(a[1], b[1]) - max(a[0], b[0])
    if inter <= 0:
        return 0.0
    return inter / max(1, min(a[1] - a[0], b[1] - b[0]))


class TorchAligner:
    def __init__(
        self,
        layout,
        k: int | None = None,
        w: int | None = None,
        max_occ: int = 64,
        min_votes: int = 4,
        max_divergence: float = 0.35,
        mu: int = 400,
        threads: int = 8,
        source: str | None = None,
        *,
        device,
    ):
        """source: path of the fasta the layout came from — enables the
        on-disk index cache (the reference's .mmi analogue). device: where
        the seeding runs ("cuda" launches H5)."""
        from ..device import as_device
        from ..utils import spans
        from .seed import DeviceIndex

        self.device = as_device(device)
        with spans.span("align.index"):
            self._init_host(layout, k, w, max_occ, min_votes, max_divergence, mu, threads,
                            source)
            self.dev_index = DeviceIndex(self.index, self.device)

    def _init_host(self, layout, k, w, max_occ, min_votes, max_divergence, mu, threads,
                   source) -> None:
        from .index import K, W, build_index_layout, load_or_build_index

        k = K if k is None else k
        w = W if w is None else w
        self.layout = layout
        self.mu = mu
        self.min_votes = min_votes
        self.max_divergence = max_divergence
        self.threads = threads
        self.target = np.where(layout.site_valid(), layout.seq_int, 4).astype(np.int8)
        # in-memory layouts (source=None) build from per-contig memoised scans
        self.index = (
            build_index_layout(layout, k=k, w=w, max_occ=max_occ)
            if source is None
            else load_or_build_index(
                layout.seq_int, layout.site_valid(), source, k=k, w=w, max_occ=max_occ
            )
        )
        logger.info(f"index: {self.index.n_minimizers} minimizers, "
                    f"{self.index.keys.shape[0]} distinct k-mers")
        # host tables for coordinate translation
        self._block_starts = layout.offsets.astype(np.int64)
        self._block_ends = (layout.offsets + layout.lengths).astype(np.int64)

    def _rebuild_kw(self) -> dict:
        return {"device": self.device}

    def load_index(self, fasta: str) -> None:
        """Rebuild the index from a new fasta (the readfish side calls this
        when the contig file changes)."""
        from ..models.layout import build_layout
        from ..models.runs_sim import load_reference_contigs

        layout = build_layout(load_reference_contigs(fasta), min_len=500)
        self.__init__(
            layout, k=self.index.k, w=self.index.w, min_votes=self.min_votes,
            max_divergence=self.max_divergence, mu=self.mu, threads=self.threads,
            **self._rebuild_kw(),
        )

    # ----------------------------------------------------------- seeding ----

    def _encode(self, text: bytes, offs: np.ndarray, groups: list[np.ndarray]) -> tuple:
        """One pass over the batch's bases (read i at ``text[offs[i]:offs[i
        + 1]]``): (codes, staged), the int8 codes the host DP reads and each
        seeding call's rows (a group, cut or padded to its bucket's length)
        packed 4 bits a base into one staging buffer, each call at its own
        offset (``seed.encode_rows``: on the card the kernel library's host
        loop, straight into pinned staging)."""
        from .seed import encode_rows

        lens = np.diff(offs)
        return encode_rows(text, [(offs[g], lens[g], bucket_of(int(lens[g].max())))
                                  for g in groups], self.dev_index)

    def _seed_bucket_dispatch(self, codes: np.ndarray, offs: np.ndarray,
                              groups: list[np.ndarray], staged) -> list:
        """Queue the seeding of every call WITHOUT waiting for any, and
        return one handle a call: the staged payload lands with one copy
        (on the card non-blocking) and each call's H5 launch follows, so
        the whole batch's seeding queues on the stream while the host
        extends earlier buckets (map_sequences pulls and extends call by
        call)."""
        from .seed import NCAND, anchor_budget, land, seed_topn

        di = self.dev_index
        return [seed_topn(x, di, di.k, di.w, anchor_budget(8 * x.shape[1], di.w),
                          8 * x.shape[1], NCAND) for x in land(staged, di)]

    @staticmethod
    def _pull_seeds(out_dev, n: int):
        """Wait for one bucket's seeding and unpack its
        [len(SEED_FIELDS) * NCAND, n] result to field -> [n, NCAND]."""
        from ..utils import spans
        from .seed import NCAND, seed_fields

        host = out_dev.cpu().numpy()
        spans.count("bytes.d2h", host.nbytes)
        return seed_fields(host[:, :n], NCAND)

    # ----------------------------------------------------------- mapping ----

    def map_sequences(self, sequences: dict[str, str], trunc: bool = False,
                      min_len: int | None = None, all_records: bool = False):
        """Align a batch; returns PafRecords with target-forward CIGARs.

        trunc: align only the first mu bases. min_len: drop alignments
        spanning less target than this (defaults to mu/2 like the
        reference's mapper). all_records: keep secondary alignments (primary
        flag 0); split-read segments are primary and always kept.
        """
        from ..utils import spans

        with spans.span("align.map", trunc=bool(trunc), reads=len(sequences)):
            return self._map(sequences, trunc, min_len, all_records)

    def _map(self, sequences: dict[str, str], trunc: bool, min_len: int | None,
             all_records: bool):
        from ..io.paf import PafRecords
        from ..utils import spans

        min_len = int(self.mu / 2) if min_len is None else min_len
        rids = list(sequences)
        if not rids:
            return _empty_records()
        with spans.span("align.encode"):
            # one encode pass over the concatenated batch (which also stages
            # the seeding payload); enc entries are views
            parts = [sequences[r][: self.mu] if trunc else sequences[r] for r in rids]
            offs = np.concatenate([[0], np.cumsum([len(p) for p in parts])])
            lens = np.diff(offs)
            groups = length_groups(lens)
            codes_cat, staged = self._encode("".join(parts).encode(), offs, groups)
            enc = [codes_cat[offs[i]: offs[i + 1]] for i in range(len(parts))]
        calls = [(len(g), bucket_of(int(lens[g].max()))) for g in groups]
        spans.count("align.reads", len(rids))
        spans.count("align.bases", sum(int(np.minimum(lens[g], L).sum())
                                       for g, (_, L) in zip(groups, calls)))
        # queue every bucket's seeding up front, then pull and extend bucket
        # by bucket
        with spans.span("align.dispatch", calls=calls):
            handles = self._seed_bucket_dispatch(codes_cat, offs, groups, staged)

        rows = {k: [] for k in (
            "qname qlen qstart qend rev tname tlen tstart tend nmatch blocklen mapq "
            "align_score s1 primary".split()
        )}
        cigs = []
        for group, out_dev in zip(groups, handles):
            with spans.span("align.pull"):
                seeds = self._pull_seeds(out_dev, len(group))
            self._extend_bucket(rids, enc, group, seeds, min_len, rows, cigs, all_records)

        def cat(f, dt):
            if not rows[f]:
                return (np.array([], dtype=object) if dt is object
                        else np.zeros(0, dt))
            return np.concatenate(rows[f]).astype(dt)

        return PafRecords(
            qname=cat("qname", object), qlen=cat("qlen", np.int64),
            qstart=cat("qstart", np.int64), qend=cat("qend", np.int64),
            rev=cat("rev", np.int8), tname=cat("tname", object),
            tlen=cat("tlen", np.int64), tstart=cat("tstart", np.int64),
            tend=cat("tend", np.int64), nmatch=cat("nmatch", np.int64),
            blocklen=cat("blocklen", np.int64), mapq=cat("mapq", np.int64),
            align_score=cat("align_score", np.int64), s1=cat("s1", np.int64),
            primary=cat("primary", np.int8), cigars=cigs,
        )

    def _candidate_plan(self, seeds: dict, mlen: np.ndarray, min_len: int):
        """Vectorised candidate selection + query windows + mapq for a whole
        bucket, all [n, NCAND] numpy.

        - candidate 0 qualifies if voted enough; later candidates qualify as
          split-read segments (disjoint query span — each its own primary) or
          as repeat alternatives at >= SECONDARY_RATIO of the best vote count
          (minimap2's pri_ratio analogue). Peel order is descending votes, so
          a candidate only competes with LOWER-indexed ones.
        - query windows: a lone candidate (or overlapping alternatives)
          extends the FULL read — seed spans undershoot the true alignment by
          hundreds of bases at ONT error rates. Only >=2 DISJOINT qualifying
          candidates partition the query, at the midpoints between adjacent
          seed spans (a full-read band cannot absorb a multi-kb soft clip).
        - mapq: uniqueness vs the best OTHER voted cluster over >=
          OVERLAP_FRAC of the same query span; split segments do not lower
          each other's mapq (minimap2's per-chain mapq).

        Returns dict of [n, NCAND] arrays: use, qs, qe, half, ts_pred, ws,
        we, mapq (mapq for ALL voted candidates, use/windows for selected).
        At most NCAND records per read: one per candidate.
        """
        k = self.index.k
        votes = seeds["votes"].astype(np.int64)        # [n, C]
        n, C = votes.shape
        span_lo = seeds["qmin"].astype(np.int64)
        span_hi = np.minimum(mlen[:, None], seeds["qmax"].astype(np.int64) + k)
        voted = votes >= self.min_votes
        # peel emits descending votes; a sentinel row after the first
        # below-threshold candidate never qualifies (matches the loop break)
        voted &= np.cumprod(voted, axis=1).astype(bool)

        # pairwise overlap fraction of seed spans [n, C, C]
        inter = (np.minimum(span_hi[:, :, None], span_hi[:, None, :])
                 - np.maximum(span_lo[:, :, None], span_lo[:, None, :]))
        shorter = np.maximum(
            1, np.minimum((span_hi - span_lo)[:, :, None],
                          (span_hi - span_lo)[:, None, :])
        )
        ovl = np.maximum(inter, 0) / shorter >= OVERLAP_FRAC  # [n, C, C]

        # qualification, in candidate order: c competes against SELECTED
        # lower candidates, so resolve the C columns sequentially
        use = np.zeros((n, C), bool)
        use[:, 0] = voted[:, 0]
        ratio_ok = votes >= SECONDARY_RATIO * votes[:, :1]
        for c in range(1, C):
            prev_ov = (ovl[:, c, :c] & use[:, :c]).any(axis=1)
            use[:, c] = voted[:, c] & (~prev_ov | ratio_ok[:, c])

        # query windows: midpoint cuts toward DISJOINT qualifying siblings
        ctr = span_lo + span_hi
        disj = use[:, :, None] & use[:, None, :] & ~ovl
        np.einsum("ncc->nc", disj)[:] = False  # no self-pairing
        left_sib = disj & (ctr[:, None, :] < ctr[:, :, None])   # sibling c2 left of c
        right_sib = disj & ~(ctr[:, None, :] < ctr[:, :, None])
        right_sib &= disj  # keep only real siblings
        # qs = max over left siblings of min(span_lo_c, (span_hi_2+span_lo_c)//2)
        cut_l = np.minimum(span_lo[:, :, None],
                           (span_hi[:, None, :] + span_lo[:, :, None]) // 2)
        qs = np.max(np.where(left_sib, cut_l, 0), axis=2)
        cut_r = np.maximum(span_hi[:, :, None],
                           (span_hi[:, :, None] + span_lo[:, None, :]) // 2)
        qe = np.min(np.where(right_sib, cut_r, mlen[:, None, None]), axis=2)
        slen = qe - qs
        # overhang eligibility counts the pre-slen-filter selection
        multi = use.sum(axis=1) > 1
        use = use & (slen >= 50)

        # band: observed indel drift + margin (+ window overhang past the
        # seeds for split segments, so a junction flank can soft-clip)
        overhang = np.where(
            multi[:, None] & ((qs > 0) | (qe < mlen[:, None])),
            np.maximum(np.maximum(span_lo - qs, qe - span_hi), 0), 0,
        )
        dspan = seeds["dspan"].astype(np.int64)
        half = np.clip(dspan // 2 + 48 + (slen * 0.005).astype(np.int64)
                       + overhang, 64, 1024).astype(np.int64)

        # diagonal -> predicted target start; clamp to the contig block
        strand = seeds["strand"].astype(np.int64)
        bkey = seeds["bkey"].astype(np.int64)
        ts_pred = np.where(strand == 0, bkey + qs, bkey - qe + k)
        cid = np.searchsorted(self._block_starts, np.maximum(ts_pred, 0),
                              side="right") - 1
        cid = np.clip(cid, 0, len(self.layout.names) - 1)
        ws = np.maximum(self._block_starts[cid], ts_pred - half - 16)
        we = np.minimum(self._block_ends[cid], ts_pred + slen + half + 16)
        use &= (we - ws) >= min_len

        # mapq for every voted candidate: best competing vote over the span
        comp = ovl & (votes > 0)[:, None, :]
        np.einsum("ncc->nc", comp)[:] = False
        second = np.max(np.where(comp, votes[:, None, :], 0), axis=2)
        uniq = 1.0 - np.minimum(1.0, second / np.maximum(1, votes))
        mapq = np.where(votes >= 2 * self.min_votes,
                        np.minimum(60, 60 * uniq), 30 * uniq).astype(np.int64)
        return dict(use=use, qs=qs, qe=qe, half=half, ts_pred=ts_pred,
                    ws=ws, we=we, mapq=mapq)

    def _extend_bucket(self, rids, enc, group, seeds, min_len, rows, cigs,
                       all_records: bool = False) -> None:
        """Banded-DP extension + record assembly for one bucket's seeds
        (host work, which runs while later buckets seed on the device):
        ``group`` the reads' indices, ``seeds`` field -> [len(group), NCAND]."""
        from ..utils import spans

        if len(group) == 0:
            return
        with spans.span("align.plan"):
            mlen = np.array([enc[g].shape[0] for g in group], np.int64)
            plan = self._candidate_plan(seeds, mlen, min_len)
        with spans.span("align.extend"):
            self._extend_planned(rids, enc, group, seeds, mlen, plan, min_len, rows, cigs,
                                 all_records)

    def _extend_planned(self, rids, enc, group, seeds, mlen, plan, min_len, rows, cigs,
                        all_records: bool) -> None:
        """The banded DP of a bucket's planned jobs and their records."""
        from ..utils import spans
        from . import native

        use = plan["use"] & (mlen >= 50)[:, None]
        job_r, job_c = np.nonzero(use)           # bucket-local (row, cand)
        if job_r.shape[0] == 0:
            return
        group_arr = np.asarray(group, np.int64)
        job_g = group_arr[job_r]                 # global read index
        job_qs = plan["qs"][job_r, job_c].astype(np.int64)
        job_qe = plan["qe"][job_r, job_c].astype(np.int64)
        job_strand = seeds["strand"][job_r, job_c].astype(np.int64)
        segs = []
        for g, qs_i, qe_i, st in zip(job_g, job_qs, job_qe, job_strand):
            seg = enc[g][qs_i:qe_i]
            if st:
                seg = _RC[np.minimum(seg, 4)][::-1]
            segs.append(seg)

        q_cat = np.concatenate(segs).astype(np.int8)
        slen_j = (job_qe - job_qs).astype(np.int64)
        q_off = np.concatenate([[0], np.cumsum(slen_j)]).astype(np.int64)
        win_s = plan["ws"][job_r, job_c].astype(np.int64)
        win_e = plan["we"][job_r, job_c].astype(np.int64)
        pad = np.maximum(plan["ts_pred"][job_r, job_c] - win_s, 0).astype(np.int32)
        half = plan["half"][job_r, job_c].astype(np.int32)
        spans.count("align.jobs", job_r.shape[0])
        spans.count("align.dp_cells", int((slen_j * (2 * half.astype(np.int64) + 1)).sum()))
        cost, tstart, tend, cigars = native.align_batch(
            q_cat, q_off, self.target, win_s, win_e, pad, half, self.threads
        )

        # ---- vectorised record assembly ----
        nj = job_r.shape[0]
        sizes = np.array([c.size for c in cigars], np.int64)
        coff = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        if coff[-1] == 0:
            # every CIGAR came back empty: no record survives (ok requires
            # sizes > 0), and the op lookups below would index an empty array
            return
        ok = (cost >= 0) & (sizes > 0)
        ok &= cost <= self.max_divergence * np.maximum(slen_j, 1)
        # strip leading/trailing insertion runs (query-only) into soft clips;
        # traceback merges runs, so each end has at most one I run
        cig_cat = np.concatenate(cigars)
        lens_all = (cig_cat >> 4).astype(np.int64)
        ops_all = (cig_cat & 0xF).astype(np.int64)
        first_i = np.minimum(coff[:-1], coff[-1] - 1)
        last_i = np.maximum(coff[1:] - 1, 0)
        head_ins = ok & (ops_all[first_i] == 1)
        s_al = np.where(head_ins, lens_all[first_i], 0)
        lo = coff[:-1] + head_ins
        tail_ins = ok & (coff[1:] - 1 >= lo) & (ops_all[last_i] == 1)
        e_clip = np.where(tail_ins, lens_all[last_i], 0)
        hi = coff[1:] - tail_ins
        ok &= hi > lo
        ts = tstart.astype(np.int64)
        te = tend.astype(np.int64)
        ok &= (te - ts) >= min_len
        cid = np.searchsorted(self._block_starts, ts, side="right") - 1
        cid_c = np.clip(cid, 0, len(self._block_ends) - 1)
        be = self._block_ends[cid_c]
        ok &= (cid >= 0) & (ts < be) & (te <= be)  # padding cross => bogus
        # per-job op-class sums over the stripped [lo, hi) cigar ranges
        pos = np.arange(coff[-1], dtype=np.int64)
        pos_job = np.repeat(np.arange(nj, dtype=np.int64), sizes)
        inrange = (pos >= lo[pos_job]) & (pos < hi[pos_job])
        key = pos_job * 3 + np.minimum(ops_all, 2)
        sums = np.bincount(
            key[inrange], weights=lens_all[inrange], minlength=nj * 3
        ).astype(np.int64).reshape(nj, 3)
        n_m, n_i, n_d = sums[:, 0], sums[:, 1], sums[:, 2]
        mism = cost.astype(np.int64) - (n_i + n_d + s_al + e_clip)
        nmatch = np.maximum(0, n_m - np.maximum(0, mism))
        # segment-local clips -> global read coordinates (rev segments were
        # RC'd, so their head clip sits at the segment's END)
        qstart = np.where(job_strand == 1, job_qs + e_clip, job_qs + s_al)
        qend = np.where(job_strand == 1, job_qe - s_al, job_qe - e_clip)
        mapq_j = plan["mapq"][job_r, job_c].astype(np.int64)
        s1_j = seeds["votes"][job_r, job_c].astype(np.int64)
        ascore = 2 * nmatch - cost.astype(np.int64)
        off_j = self._block_starts[cid_c]

        keep = np.flatnonzero(ok)
        if keep.shape[0] == 0:
            return
        # primary flags: best record by (mapq, AS) per read is primary;
        # further records are primary (split-read/supplementary) iff their
        # query span is disjoint from every primary so far, else secondary.
        # Single-record reads (the vast majority) short-circuit to primary.
        primary = np.ones(keep.shape[0], np.int8)
        kg = job_g[keep]
        counts = np.bincount(kg, minlength=int(job_g.max()) + 1)
        multi_reads = np.flatnonzero(counts > 1)
        for g in multi_reads:
            idx = np.flatnonzero(kg == g)       # positions within keep
            j = keep[idx]
            order = sorted(range(idx.shape[0]),
                           key=lambda i: (mapq_j[j[i]], ascore[j[i]]),
                           reverse=True)
            prim_spans: list[tuple[int, int]] = []
            for i in order:
                span = (int(qstart[j[i]]), int(qend[j[i]]))
                if not prim_spans or all(
                    _overlap_frac(span, s) < OVERLAP_FRAC for s in prim_spans
                ):
                    primary[idx[i]] = 1
                    prim_spans.append(span)
                else:
                    primary[idx[i]] = 0
        if not all_records:
            keep = keep[primary == 1]
            primary = primary[primary == 1]
        if keep.shape[0] == 0:
            return

        names_arr = np.asarray(self.layout.names, dtype=object)
        lengths_arr = np.asarray(self.layout.lengths, np.int64)
        rids_arr = np.asarray(rids, dtype=object)
        rows["qname"].append(rids_arr[job_g[keep]])
        rows["qlen"].append(mlen[job_r[keep]].astype(np.int64))
        rows["qstart"].append(qstart[keep])
        rows["qend"].append(qend[keep])
        rows["rev"].append(job_strand[keep].astype(np.int8))
        rows["tname"].append(names_arr[cid_c[keep]])
        rows["tlen"].append(lengths_arr[cid_c[keep]])
        rows["tstart"].append(ts[keep] - off_j[keep])
        rows["tend"].append(te[keep] - off_j[keep])
        rows["nmatch"].append(nmatch[keep])
        rows["blocklen"].append((n_m + n_i + n_d)[keep])
        rows["mapq"].append(mapq_j[keep])
        rows["align_score"].append(ascore[keep])
        rows["s1"].append(s1_j[keep])
        rows["primary"].append(primary)
        for j in keep:
            cigs.append(cig_cat[lo[j]:hi[j]])  # packed uint32 views


def _empty_records():
    from ..io.paf import PafRecords

    z = np.zeros(0, np.int64)
    return PafRecords(
        qname=np.array([], dtype=object), qlen=z, qstart=z, qend=z,
        rev=np.zeros(0, np.int8), tname=np.array([], dtype=object),
        tlen=z, tstart=z, tend=z, nmatch=z, blocklen=z, mapq=z,
        align_score=z, s1=z, primary=np.zeros(0, np.int8), cigars=[],
    )
