"""Fastq/fasta parsing and batch ingestion (host data plane).

Replaces the reference's mappy.fastx_read-based batch reader
(the reference's boss/batch.py:13-119): pure-Python/NumPy parsing with the
same channel-filter semantics (``ch=<n>`` in the header comment) and barcode
extraction (``barcode=(unclassified|barcodeNN)``, sampler.py:206-221).
"""
from __future__ import annotations

import gzip
import logging
import re
from dataclasses import dataclass, field
from pathlib import Path


logger = logging.getLogger("boss_tpu")

_CH_RE = re.compile(r"\sch=([0-9]+)")
_BC_RE = re.compile(r"barcode=(unclassified|barcode([0-9]+))")
UNCLASSIFIED_BARCODE = 99  # sampler.py:219


def _open(path: str | Path):
    p = str(path)
    return gzip.open(p, "rt") if p.endswith((".gz", ".gzip")) else open(p, "rt")


def read_fastx(path: str | Path):
    """Yield (name, comment, seq, qual) from fastq/fasta, plain or gzipped.

    qual is '' for fasta records.
    """
    with _open(path) as fh:
        first = fh.read(1)
        if not first:
            return
        if first == ">":
            name_line = fh.readline().rstrip("\n")
            parts = name_line.split(None, 1)
            name, comment = parts[0], parts[1] if len(parts) > 1 else ""
            chunks: list[str] = []
            for line in fh:
                line = line.rstrip("\n")
                if line.startswith(">"):
                    yield name, comment, "".join(chunks), ""
                    parts = line[1:].split(None, 1)
                    name, comment = parts[0], parts[1] if len(parts) > 1 else ""
                    chunks = []
                else:
                    chunks.append(line)
            yield name, comment, "".join(chunks), ""
        elif first == "@":
            header = first + fh.readline()
            while header.strip():
                parts = header.rstrip("\n")[1:].split(None, 1)
                name, comment = parts[0], parts[1] if len(parts) > 1 else ""
                seq = fh.readline().rstrip("\n")
                fh.readline()
                qual = fh.readline().rstrip("\n")
                yield name, comment, seq, qual
                header = fh.readline()
        else:
            raise ValueError(f"{path}: not fasta/fastq")


def parse_channel(comment: str) -> int | None:
    m = _CH_RE.search(" " + comment)
    return int(m.group(1)) if m else None


def parse_barcode(header: str) -> int:
    """Barcode number from a header, 0 if absent, 99 if unclassified."""
    m = _BC_RE.search(header)
    if m is None:
        return 0
    if m.group(1) == "unclassified":
        return UNCLASSIFIED_BARCODE
    return int(m.group(2))


@dataclass
class FastqBatch:
    """One batch of reads, optionally filtered to a set of flowcell channels.

    Mirrors boss/batch.py:13-119 (channel regex filter included).
    """

    fq_files: list[str]
    channels: set[int] | None = None
    read_sequences: dict[str, str] = field(default_factory=dict)
    read_qualities: dict[str, str] = field(default_factory=dict)
    read_barcodes: dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        for fq in self.fq_files:
            for name, comment, seq, qual in read_fastx(fq):
                if self.channels:
                    ch = parse_channel(comment)
                    if ch is None:
                        logger.info("ch= not found in fastq header")
                        continue
                    if ch not in self.channels:
                        continue
                name = str(name)
                self.read_sequences[name] = seq
                self.read_qualities[name] = qual
                self.read_barcodes[name] = parse_barcode(f"{name} {comment}")
        logger.info(f"total new reads: {len(self.read_sequences)}")

    @property
    def read_ids(self) -> set:
        return set(self.read_sequences)

    @property
    def read_lengths(self) -> dict[str, int]:
        return {r: len(s) for r, s in self.read_sequences.items()}

    @property
    def total_bases(self) -> int:
        return sum(len(s) for s in self.read_sequences.values())


def write_fasta(path: str | Path, seqs: dict[str, str], mode: str = "w") -> None:
    with open(path, mode) as fh:
        for name, seq in seqs.items():
            fh.write(f">{name}\n{seq}\n")
