"""FASTA/FASTQ readers and writers (plain or gzip), no external deps.

Replaces the reference's BioPython SeqIO usage (advntr_commands.py:194,
vntr_finder.py:943) and the samtools bam2fq|sed unmapped-FASTA pipeline
(sam_utils.py:8-23)."""

from __future__ import annotations

import gzip
import os
from typing import Iterator


def _open(path: str, mode: str = "rt"):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_fasta(path: str) -> Iterator[tuple[str, str]]:
    """Yield (name, sequence) for each FASTA record."""
    name = None
    chunks: list[str] = []
    with _open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            yield name, "".join(chunks)


def read_fastq(path: str) -> Iterator[tuple[str, str, str]]:
    """Yield (name, sequence, quality) for each FASTQ record."""
    with _open(path) as fh:
        while True:
            header = fh.readline()
            if not header:
                break
            seq = fh.readline().rstrip("\n")
            fh.readline()  # '+'
            qual = fh.readline().rstrip("\n")
            yield header.rstrip("\n")[1:].split()[0], seq, qual


def write_fasta(path: str, records) -> None:
    with _open(path, "wt") as fh:
        for name, seq in records:
            fh.write(f">{name}\n{seq}\n")


def load_chromosome(path: str, chromosome: str) -> str:
    """Load one chromosome's sequence from a (multi-)FASTA reference."""
    for name, seq in read_fasta(path):
        if name == chromosome:
            return seq
    return ""


def guess_format(path: str) -> str:
    base = path[:-3] if path.endswith(".gz") else path
    ext = os.path.splitext(base)[1].lower()
    if ext in (".fq", ".fastq"):
        return "fastq"
    return "fasta"


def read_any(path: str) -> Iterator[tuple[str, str]]:
    """Yield (name, sequence) from FASTA or FASTQ."""
    if guess_format(path) == "fastq":
        for name, seq, _ in read_fastq(path):
            yield name, seq
    else:
        yield from read_fasta(path)
