"""String-graph unitig assembly from classified dovetail overlaps.

Host-side replacement for the reference's external assembly tools — miniasm
(initial assembly, the reference's boss/aeons/sequences.py:566-593) and
gfatools paf2gfa -u (incremental unitig construction, :211-231 + Unitig/
CoverageMerger parsing :1160-1368). Instead of shelling out and re-parsing
GFA text, overlaps go straight from the LinkStore into a bidirected string
graph:

  1. ends graph: each sequence has an L and an R end; every dovetail record
     joins (q, qside) <-> (t, tside),
  2. transitive reduction: at an end with several edges, an edge to y is
     dropped when a larger overlap leads to x and x itself links to y
     (Myers-style, coordinate-free),
  3. unitig walk: paths across mutually unambiguous junctions merge into
     unitigs; sequences and per-base coverage concatenate with overlap cuts
     (the CoverageMerger semantics: each atom contributes its bases from its
     entry offset onward),
  4. terminal ends that still had edges (ambiguous junctions) are "capped" —
     they don't count as extendable contig ends for the strategy; cycles
     mark the unitig circular and non-acceptor.
"""
from __future__ import annotations

import hashlib
import logging

import numpy as np

from ..io.paf import revcomp
from ..utils import spans
from .ava import PoolIndex, find_overlaps, rows_to_records
from .pool import LinkStore, Sequence, SequencePool

logger = logging.getLogger("boss_tpu")


def _end_edges(links: dict) -> dict[tuple[str, str], list]:
    """(sid, side) -> [(other, other_side, rec, i, s1)] from the link store."""
    ends: dict[tuple[str, str], list] = {}
    seen = set()
    for a, targets in links.items():
        for b, entry in targets.items():
            rec, i, s1, qside, tside = entry
            key = (id(rec), i)
            if key in seen:
                continue
            seen.add(key)
            q, t = rec.qname[i], rec.tname[i]
            ends.setdefault((q, qside), []).append((t, tside, rec, i, s1))
            ends.setdefault((t, tside), []).append((q, qside, rec, i, s1))
    return ends


def _overlap_span_on(rec, i, sid) -> int:
    if rec.qname[i] == sid:
        return int(rec.qend[i] - rec.qstart[i])
    return int(rec.tend[i] - rec.tstart[i])


def transitive_reduction(ends: dict, links: dict) -> dict:
    """Drop transitive edges at multi-edge ends (largest overlap = nearest)."""
    reduced = {k: list(v) for k, v in ends.items()}
    for end, edges in reduced.items():
        if len(edges) < 2:
            continue
        sid = end[0]
        edges.sort(key=lambda e: -_overlap_span_on(e[2], e[3], sid))
        keep = []
        for e in edges:
            other = e[0]
            transitive = any(
                other in links.get(k[0], {}) for k in keep
            )
            if not transitive:
                keep.append(e)
        reduced[end] = keep
    return reduced


def _junction_skip(rec, i, a: str, a_orient: str, b_orient: str) -> int:
    """Bases to cut from the entering sequence b (overlap end on b's oriented
    axis + a's overhang beyond the aligned region at its exit end)."""
    if rec.qname[i] == a:
        ha = int(rec.qlen[i] - rec.qend[i]) if a_orient == "+" else int(rec.qstart[i])
        cut = int(rec.tend[i]) if b_orient == "+" else int(rec.tlen[i] - rec.tstart[i])
    else:
        ha = int(rec.tlen[i] - rec.tend[i]) if a_orient == "+" else int(rec.tstart[i])
        cut = int(rec.qend[i]) if b_orient == "+" else int(rec.qlen[i] - rec.qstart[i])
    return cut + ha


MIN_EXTENSION = 200  # junctions must extend the unitig by at least this


def _unambiguous(ends: dict, end: tuple[str, str], pool=None, walking_right=True):
    """Single mutual edge at `end`, with a geometry sanity check: the
    junction must actually extend the path (guards against containment-like
    records that approximate chain coordinates misclassify as dovetails)."""
    edges = ends.get(end, [])
    if len(edges) != 1:
        return None
    other, other_side, rec, i, s1 = edges[0]
    if len(ends.get((other, other_side), [])) != 1:
        return None
    if pool is not None:
        a, a_side = end
        a_orient = ("+" if a_side == "R" else "-") if walking_right else ("+" if a_side == "L" else "-")
        if walking_right:
            b_orient = "+" if other_side == "L" else "-"
            skip = _junction_skip(rec, i, a, a_orient, b_orient)
            ext_len = len(pool.sequences[other].seq) - skip
        else:
            # walking left: `other` precedes; the current head is the one cut
            b_orient = "+" if other_side == "R" else "-"
            head_orient = "+" if a_side == "L" else "-"
            skip = _junction_skip(rec, i, other, b_orient, head_orient)
            ext_len = len(pool.sequences[a].seq) - skip
        if ext_len < MIN_EXTENSION:
            return None
    return other, other_side, rec, i


def walk_unitigs(pool: SequencePool, store: LinkStore, min_seq_len: int = 3000):
    """Merge unambiguous paths into unitig Sequences.

    Returns (new_pool, used_sids): unitigs of >= 2 members and the member ids
    to remove. Singleton sequences stay untouched in the pool.
    """
    full_ends = _end_edges(store.links)
    ends = transitive_reduction(full_ends, store.links)
    visited: set[str] = set()
    new_pool = SequencePool(min_len=min_seq_len)
    used: set[str] = set()

    for sid in list(pool.sequences):
        if sid in visited or sid not in pool.sequences:
            continue
        if (sid, "L") not in ends and (sid, "R") not in ends:
            continue
        # extend left as far as possible, then walk right
        path = [(sid, "+")]
        seen_path = {sid}
        circular = False
        while True:
            head, orient = path[0]
            entry_end = (head, "L" if orient == "+" else "R")
            nxt = _unambiguous(ends, entry_end, pool, walking_right=False)
            if nxt is None:
                break
            other, other_side, rec, i = nxt
            if other in seen_path:
                circular = True
                break
            path.insert(0, (other, "+" if other_side == "R" else "-"))
            seen_path.add(other)
        while not circular:
            tail, orient = path[-1]
            exit_end = (tail, "R" if orient == "+" else "L")
            nxt = _unambiguous(ends, exit_end, pool, walking_right=True)
            if nxt is None:
                break
            other, other_side, rec, i = nxt
            if other in seen_path:
                circular = True
                break
            path.append((other, "+" if other_side == "L" else "-"))
            seen_path.add(other)
        visited |= seen_path
        if len(path) < 2:
            continue
        unitig = _merge_path(pool, ends, path, circular)
        if unitig is None:
            continue
        new_pool.sequences[unitig.header] = unitig
        used |= seen_path
    return new_pool, used


def _junction_record(ends, a, a_orient, b):
    exit_end = (a, "R" if a_orient == "+" else "L")
    for other, other_side, rec, i, _s1 in ends.get(exit_end, []):
        if other == b:
            return rec, i
    return None, None


def _merge_path(pool: SequencePool, ends, path, circular) -> Sequence | None:
    seq_parts = []
    cov_parts = []
    atoms = set()
    components = set()
    for idx, (sid, orient) in enumerate(path):
        seqo = pool.sequences.get(sid)
        if seqo is None:
            return None
        s = seqo.seq if orient == "+" else revcomp(seqo.seq)
        c = seqo.cov if orient == "+" else seqo.cov[::-1]
        if idx == 0:
            skip = 0
        else:
            a, a_orient = path[idx - 1]
            rec, i = _junction_record(ends, a, a_orient, sid)
            if rec is None:
                return None
            skip = min(_junction_skip(rec, i, a, a_orient, orient), len(s))
        seq_parts.append(s[skip:])
        cov_parts.append(c[skip:])
        atoms.add(sid)
        atoms |= seqo.atoms
        components.add(sid)
        components |= seqo.components
    seq = "".join(seq_parts)
    if not seq:
        return None
    cov = np.concatenate(cov_parts)
    # caps: terminal junctions that existed but were ambiguous
    first, first_orient = path[0]
    last, last_orient = path[-1]
    cap_l = bool(ends.get((first, "L" if first_orient == "+" else "R")))
    cap_r = bool(ends.get((last, "R" if last_orient == "+" else "L")))
    # content-derived id: reproducible across runs/resumes (a random id makes
    # dict ordering — and thus near-threshold strategy bits — RNG-dependent)
    uid = hashlib.sha1(seq.encode()).hexdigest()[:12]
    u = Sequence(f"utg_{uid}", seq, cov=cov, components=components,
                 atoms=atoms, cap_l=cap_l or circular, cap_r=cap_r or circular)
    if circular:
        u.acceptor = False
    return u


def initial_assembly(reads: dict[str, str], min_seq_len: int = 3000,
                     min_votes: int = 4, *, device) -> SequencePool:
    """miniasm-equivalent first assembly from a pile of raw reads: ava ->
    classify -> drop contained -> unitig walk. Only the unitigs survive, as
    with miniasm; leftover reads rejoin through later batches' overlaps."""
    pool = SequencePool(min_len=min_seq_len)
    pool.ingest(reads)
    if pool.is_empty():
        return SequencePool(min_len=min_seq_len)
    store = LinkStore(tetra=False)
    with spans.span("aeons.ava", stage="initial"):
        pidx = PoolIndex(pool.seqdict(), device=device)
        rec = rows_to_records(find_overlaps(pool.seqdict(), pidx, min_votes=min_votes,
                                            merge=True))
    containments, _ovl = store.load_records(rec, pool)
    contained = pool.increment(containments)
    store.remove_links(contained)
    pool.remove_sequences(contained)
    unitigs, used = walk_unitigs(pool, store, min_seq_len=min_seq_len)
    logger.info(
        f"initial assembly: {len(reads)} reads -> {len(unitigs.sequences)} unitigs"
    )
    return unitigs
