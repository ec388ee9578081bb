"""The port's aligner as the live readfish mapper plugin.

The port of ``bossruns_tpu.live.mapper``: ``TorchMapperPlugin`` is the
decision plane's aligner, in place of readfish's mappy Aligner plugin.
``bossruns_tpu.live.readfish_boss.Analysis`` takes any mapper object
(``mapper=``), so the readfish side needs no code of its own.

It implements the protocol ``Analysis`` consumes: ``map_reads(calls)``
yielding the results with ``alignment_data`` attached, ``initialised``,
``load_index(fasta)`` and ``describe(regions, barcodes)``. The alignment
objects carry mappy-compatible fields (.ctg, .r_st, .r_en, .strand as 1/-1,
.q_st, .q_en, .mapq), so ``make_decision`` aggregates them into
single_on/.../multi_off exactly like the reference's mappy path. Secondary
alignments are kept (``all_records=True``): mappy reports them too, and
they make the multi_* decisions reachable on repeat reads.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path

from ..device import as_device, require_cuda

logger = logging.getLogger("boss_torch")

__all__ = ["LIVE_MIN_LEN", "Alignment", "AlignmentData", "TorchMapperPlugin"]

#: live chunks are ~400 bases; accept any alignment spanning at least this
#: much target (mappy reports short hits too — the decision plane should
#: see them, unlike the update plane's mu/2 floor)
LIVE_MIN_LEN = 50


@dataclass
class Alignment:
    """mappy.Alignment-compatible view of one record."""

    ctg: str
    r_st: int
    r_en: int
    strand: int  # readfish/mappy convention: 1 fwd, -1 rev
    q_st: int
    q_en: int
    mapq: int
    is_primary: bool


class AlignmentData:
    """Container with an .alignments attribute (readfish Result shape)."""

    def __init__(self, alignments: list[Alignment]):
        self.alignments = alignments

    def __iter__(self):
        return iter(self.alignments)

    def __len__(self):
        return len(self.alignments)

    def __bool__(self):
        return bool(self.alignments)


class TorchMapperPlugin:
    """readfish Aligner plugin backed by the port's aligner.

    device: where a built aligner seeds; the CUDA card when not given
    (``device.require_cuda``, which raises without one). Ignored when an
    ``aligner`` is passed in.
    """

    def __init__(self, fasta: str | Path | None = None, aligner=None, device=None,
                 min_len: int = LIVE_MIN_LEN, min_contig_len: int = 500):
        self.min_len = min_len
        self.min_contig_len = min_contig_len
        self.aligner = aligner
        self.device = device
        self._fasta = str(fasta) if fasta else None
        if self.aligner is None and self._fasta:
            self.load_index(self._fasta)

    @property
    def initialised(self) -> bool:
        return self.aligner is not None

    def load_index(self, fasta: str) -> None:
        """(Re)build the index from a fasta: the first call initialises,
        later calls swap contigs. The readfish side's dummy init index (one
        25-base contig) gives an aligner with an empty minimizer index:
        every read maps to nothing -> no_map -> proceed."""
        from ..aligner import make_aligner
        from ..models.layout import build_layout
        from ..models.runs_sim import load_reference_contigs

        contigs = load_reference_contigs(fasta)
        min_len = self.min_contig_len
        if not any(len(s) >= min_len for s in contigs.values()):
            min_len = 1  # dummy/bootstrap index: keep the tiny contig
        layout = build_layout(contigs, min_len=min_len)
        if self.aligner is None:
            dev = as_device(self.device) if self.device is not None else require_cuda()
            self.aligner = make_aligner(layout, device=dev, source=fasta)
        else:
            self.aligner.load_index(fasta)
        self._fasta = fasta

    def describe(self, regions=None, barcodes=None) -> str:
        """Startup description logged by the hot loop."""
        if not self.initialised:
            return "TorchMapperPlugin: index not initialised"
        lay = self.aligner.layout
        n_regions = len(regions) if regions is not None else 0
        return (
            f"TorchMapperPlugin: {len(lay.names)} contigs, "
            f"{int(lay.lengths.sum())} bases indexed "
            f"(k={self.aligner.index.k}, w={self.aligner.index.w}); "
            f"serving {n_regions} regions"
        )

    def disconnect(self) -> None:
        return None

    def map_reads(self, calls):
        """Align one basecalled chunk batch and attach alignments.

        calls: iterable of result-likes with .read_id and .seq. Yields the
        same objects with .alignment_data set. The whole batch is one
        map_sequences call: one seeding launch per length bucket and one
        native DP sweep.
        """
        batch = list(calls)
        seqs = {}
        for i, res in enumerate(batch):
            # key by slot: live read_ids could collide across re-basecalls
            if getattr(res, "seq", ""):
                seqs[str(i)] = res.seq
        recs = (
            self.aligner.map_sequences(seqs, min_len=self.min_len, all_records=True)
            if seqs else None
        )
        by_slot: dict[int, list[Alignment]] = {}
        if recs is not None:
            for r in range(len(recs)):
                slot = int(recs.qname[r])
                by_slot.setdefault(slot, []).append(Alignment(
                    ctg=str(recs.tname[r]),
                    r_st=int(recs.tstart[r]),
                    r_en=int(recs.tend[r]),
                    strand=-1 if recs.rev[r] else 1,
                    q_st=int(recs.qstart[r]),
                    q_en=int(recs.qend[r]),
                    mapq=int(recs.mapq[r]),
                    is_primary=bool(recs.primary[r]),
                ))
        for i, res in enumerate(batch):
            res.alignment_data = AlignmentData(by_slot.get(i, []))
            yield res
