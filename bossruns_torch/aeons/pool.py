"""Persistent sequence pool + overlap bookkeeping for BOSS-AEONS.

Host-side mutable state of the reference-free mode, mirroring
the reference's boss/aeons/sequences.py (Sequence :261-406, SequencePool
:411-975, SequenceAVA link store :26-256):

  * Sequence: raw bases + float per-base coverage + temperature + end caps
  * SequencePool: ingest/remove/trim; containment coverage propagation as a
    topologically ordered DAG sweep with edge-multiplicity division
    (sequences.py:689-825); temperature decay freezing short inactive reads
  * LinkStore: classified overlap records (links for unitig construction,
    containments for coverage, class-6 trim candidates), tetramer
    intra-species veto, non-acceptor (circular contig) demotion of overlaps
    to containments (sequences.py:84-97)
"""
from __future__ import annotations

import logging
from collections import Counter

import numpy as np

from ..io.paf import PafRecords
from . import kmer
from .classify import (Classified, classify, containment_coords_role,
                       find_trim_coords, multiline_containments)

logger = logging.getLogger("boss_tpu")


class Sequence:
    __slots__ = (
        "header", "seq", "cov", "atoms", "components", "temperature",
        "cap_l", "cap_r", "acceptor", "_tetra",
    )

    def __init__(self, header, seq, cov=None, components=None, atoms=None,
                 cap_l=False, cap_r=False):
        self.header = header
        self.seq = seq
        self.cov = np.ones(len(seq), np.float32) if cov is None else cov.astype(np.float32)
        self.atoms = set(atoms) if atoms else set()
        self.components = set(components) if components else set()
        self.temperature = 30
        self.cap_l = cap_l
        self.cap_r = cap_r
        self.acceptor = True
        self._tetra = None

    @property
    def tetra_freqs(self):
        if self._tetra is None:
            self._tetra = kmer.tetramer_freqs(self.seq)
        return self._tetra

    def is_hot(self) -> bool:
        return self.temperature > 0


class SequencePool:
    def __init__(self, sequences: dict | None = None, min_len: int = 3000, name: str = "pool"):
        self.min_len = min_len
        self.name = name
        self.sequences: dict[str, Sequence] = {}
        if sequences:
            self.ingest(sequences)

    # ------------------------------------------------------------ basics ----

    def headers(self) -> set[str]:
        return set(self.sequences)

    def seqdict(self) -> dict[str, str]:
        return {h: s.seq for h, s in self.sequences.items()}

    def total_bases(self) -> int:
        return sum(len(s.seq) for s in self.sequences.values())

    def is_empty(self) -> bool:
        return not self.sequences

    def ingest(self, seqs) -> int:
        """Add raw strings, Sequence objects or another pool; returns #added."""
        if isinstance(seqs, SequencePool):
            items = seqs.sequences.items()
        else:
            items = seqs.items()
        added = 0
        for rid, s in items:
            if isinstance(s, str):
                if len(s) > self.min_len:
                    self.sequences[rid] = Sequence(rid, s)
                    added += 1
            else:
                if len(s.seq) > self.min_len:
                    self.sequences[rid] = s
                    added += 1
        return added

    def remove_sequences(self, sids: set[str]) -> None:
        for sid in sids:
            self.sequences.pop(sid, None)

    def declare_contigs(self, min_contig_len: int) -> "SequencePool":
        contigs = {h: s for h, s in self.sequences.items() if len(s.seq) > min_contig_len}
        pool = SequencePool(min_len=self.min_len)
        pool.sequences = contigs
        return pool

    def has_min_one_contig(self, min_contig_len: int) -> bool:
        return any(len(s.seq) > min_contig_len for s in self.sequences.values())

    def is_intra(self, a: str, b: str) -> bool:
        return kmer.is_intra(self.sequences[a].tetra_freqs, self.sequences[b].tetra_freqs)

    # ------------------------------------------------------- temperature ----

    def reset_temperature(self, sids: set[str], t: int = 50) -> None:
        for s in sids:
            if s in self.sequences:
                self.sequences[s].temperature = t

    def decrease_temperature(self, lim: int) -> set[str]:
        """Cool all short sequences; return the frozen ones
        (sequences.py:844-859)."""
        frozen = set()
        for h, s in self.sequences.items():
            if len(s.seq) < lim:
                s.temperature -= 1
                if not s.is_hot():
                    frozen.add(h)
        return frozen

    # --------------------------------------------------------- trimming -----

    def trim_sequences(self, trim_dict: dict[str, tuple[int, int | None, str]]) -> dict[str, str]:
        """Cut the marked overhangs; trimmed copies get a '%' suffix
        (sequences.py:641-686). Returns dict of sequences to re-overlap."""
        out = {}
        for sid, (start, stop, other) in trim_dict.items():
            src = self.sequences.get(sid)
            if src is None:
                continue
            nsid = sid + "%"
            mask = np.ones(len(src.seq), bool)
            mask[start:stop] = False
            seq = np.frombuffer(src.seq.encode(), np.uint8)[mask].tobytes().decode()
            seqo = Sequence(nsid, seq, cov=src.cov[mask].copy(),
                            components=src.components, atoms=src.atoms)
            if len(seq) > self.min_len:
                self.sequences[nsid] = seqo
                out[nsid] = seq
            if other in self.sequences:
                out[other] = self.sequences[other].seq
        return out

    # ----------------------------------------------- containment sweeps -----

    def increment(self, containments: dict[tuple[str, str], tuple]) -> set[str]:
        """Propagate contained reads' coverage onto containers in topological
        order, dividing by edge multiplicity (sequences.py:689-825).

        containments: {(source, target): (rec, i, query_contained)}
        Returns the contained sequence ids (to remove from the pool).
        """
        edges = set(containments.keys())
        if not edges:
            return set()
        previous = None
        while edges:
            if previous is None:
                sources, targets = zip(*edges)
                next_sources = set(sources) - set(targets)
            else:
                next_sources = {t for (_s, t) in previous}
            next_edges = {(s, t) for (s, t) in edges if s in next_sources}
            if not next_edges:
                break
            edges -= next_edges
            multiplicity = Counter(s for s, _t in next_edges)
            for (s, t) in next_edges:
                rec, i, q_cont = containments[(s, t)]
                self._effect_increment(s, t, rec, i, q_cont, multiplicity[s])
            if previous is not None and len(next_edges) == len(previous):
                break  # circular containment guard
            previous = next_edges
        return {s for (s, _t) in containments}

    def _effect_increment(self, source, target, rec: PafRecords, i: int,
                          query_contained: bool, multiplicity: float) -> None:
        if source not in self.sequences or target not in self.sequences:
            return
        ostart, oend, olen, cstart, cend, clen = containment_coords_role(rec, i, query_contained)
        cov = self.sequences[source].cov[cstart:cend].copy()
        if clen > olen:
            cov = cov[:olen]
        elif clen < olen:
            cov = np.pad(cov, (0, olen - clen), mode="edge")
        if rec.rev[i]:
            cov = cov[::-1]
        cov /= multiplicity
        tgt = self.sequences[target]
        tgt.cov[ostart:oend] += cov
        np.minimum(tgt.cov, 100.0, out=tgt.cov)  # cap (sequences.py:746)
        if "*" not in source:
            tgt.atoms.add(source)


class LinkStore:
    """Classified overlap bookkeeping (SequenceAVA semantics)."""

    def __init__(self, min_map_len: int = 2000, min_s1: int = 200,
                 min_seq_len: int = 2500, tetra: bool = True):
        self.filters = dict(min_map_len=min_map_len, min_s1=min_s1, min_seq_len=min_seq_len)
        self.tetra = tetra
        # links[a][b] = (rec, i, s1)
        self.links: dict[str, dict[str, tuple]] = {}
        self.overlaps: dict[tuple[str, str], tuple] = {}
        self.trims: list[tuple] = []

    def load_records(self, rec: PafRecords, pool: SequencePool):
        """Classify records; collect containments/links/trims.

        Returns (containments {(contained, container): (rec,i,q_cont)},
        overlapper ids set).
        """
        self.trims = []
        self.overlaps = {}
        cls: Classified = classify(rec, **self.filters)
        containments: dict[tuple[str, str], tuple] = {}
        overlappers: set[str] = set()
        n_inter = 0
        for i in np.argsort(-rec.s1, kind="stable"):
            i = int(i)
            c = int(cls.c[i])
            if c == 0 or c == 1:
                continue
            q, t = rec.qname[i], rec.tname[i]
            if q not in pool.sequences or t not in pool.sequences:
                continue
            if c in (4, 5):
                if self.tetra and not pool.is_intra(q, t):
                    n_inter += 1
                    continue
                # overlaps onto non-acceptors (circular contigs) become
                # containments of the other sequence (sequences.py:90-97)
                if not pool.sequences[t].acceptor:
                    c = 2
                elif not pool.sequences[q].acceptor:
                    c = 3
            if c == 2:
                key = (q, t)
                if key not in containments:  # s1-descending order: keep best
                    containments[key] = (rec, i, True)
            elif c == 3:
                key = (t, q)
                if key not in containments:
                    containments[key] = (rec, i, False)
            elif c in (4, 5):
                self.overlaps[(q, t)] = (rec, i)
                prev = self.links.get(q, {}).get(t)
                if prev is not None and prev[2] >= rec.s1[i]:
                    continue
                entry = (rec, i, int(rec.s1[i]), str(cls.qside[i]), str(cls.tside[i]))
                self.links.setdefault(q, {})[t] = entry
                self.links.setdefault(t, {})[q] = entry
                overlappers.add(q)
                overlappers.add(t)
            elif c == 6:
                self.trims.append((rec, i, bool(cls.qprox[i])))
        if n_inter:
            logger.info(f"vetoed {n_inter} inter-species overlaps")
        # containments fragmented across several internal-match records by
        # indel drift (sequences.py:1373-1515): recover them from occupancy
        merged, roles = multiline_containments(rec, cls)
        for row, q_cont in roles:
            q, t = merged.qname[row], merged.tname[row]
            if q not in pool.sequences or t not in pool.sequences:
                continue
            key = (q, t) if q_cont else (t, q)
            if key not in containments:
                containments[key] = (merged, row, q_cont)
        if roles:
            logger.info(f"multiline containments: {len(roles)}")
        return containments, overlappers

    def remove_links(self, sids: set[str]) -> None:
        for sid in sids:
            targets = self.links.pop(sid, {})
            for t in targets:
                self.links.get(t, {}).pop(sid, None)

    def to_be_trimmed(self) -> dict[str, tuple[int, int | None, str]]:
        out = {}
        for rec, i, qprox in self.trims:
            sid, start, stop, other = find_trim_coords(rec, i, qprox)
            if sid == "0":
                continue
            out[sid] = (start, stop, other)
        return out

    def trim_success(self, trim_dict) -> set[str]:
        """Which trims produced overlaps -> remove originals; failed trims ->
        remove the trimmed copies (sequences.py:160-188)."""
        trim = set(trim_dict)
        if not trim:
            return set()
        ovl = set()
        for (q, t) in self.overlaps:
            ovl.add(q)
            ovl.add(t)
        trimmed = {f"{t}%" for t in trim}
        success_marked = trimmed & ovl
        unsuccess = trimmed - success_marked
        success = {s[:-1] for s in success_marked}
        return success | unsuccess
