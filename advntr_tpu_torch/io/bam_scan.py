"""Bulk scan of a BAM's unmapped records, for recruitment.

``BamReader.fetch_unmapped`` parses every record whole: its CIGAR, each
base in a Python loop, the qualities.  Recruitment needs only the name and
the bases of the records with flag bit 4 set, and the k-mer filter takes
bases as int8 codes.  This scanner inflates the BGZF stream a few MB at a
time (the blocks of a chunk in parallel threads, the next chunk's while
the caller works on this one), and walks each chunk's records by their
``block_size`` fields in a small C loop (``csrc/bam_scan.cc``) that reads
every record's flag first and copies out, of the unmapped records alone,
the name and the packed 4-bit bases (``PackedReads``).  The CIGAR and the
qualities are never decoded.  A batch's bases become the filter's padded
(B, L) codes in one table lookup (``PackedReads.codes``), and a read's
strings are made only where the filter keeps it.

The set of records is ``fetch_unmapped``'s: every record of the file with
bit 4 set, in file order, unmapped reads placed among the aligned ones
included.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from advntr_tpu_torch import dna, native_bridge
from advntr_tpu_torch.utils.profiler import count

_SEQ_CODES = "=ACMGRSVTWYHKDBN"
# a packed byte's two bases, high nibble first: as the filter's codes
# (A, C, G, T -> 0-3, the other twelve letters -> 4, as dna.encode maps
# them; both of a byte's codes read as one uint16) and as the BAM's letters
_NIBBLES = np.stack([np.arange(256) >> 4, np.arange(256) & 15], axis=1)
_PAIR_CODES16 = dna.encode(_SEQ_CODES)[_NIBBLES].view(np.uint16)[:, 0]
_PAIR_LETTERS = np.frombuffer(_SEQ_CODES.encode(), dtype=np.uint8)[_NIBBLES]

# inflated bytes walked at a time; a record that spans two chunks is
# carried into the next
CHUNK_BYTES = 4 << 20
# threads inflating a chunk's blocks (zlib releases the interpreter lock)
INFLATE_THREADS = 4
# compressed bytes read at a time (a BGZF block is at most 64 KiB)
_READ_BYTES = 1 << 20
_MAX_BLOCK = 1 << 16
# bytes of a record's block_size and fixed fields
_RECORD_MIN = 36


class PackedReads:
    """Unmapped records in file order: their names and packed bases as flat
    uint8 arrays with row offsets, and their lengths in bases."""

    __slots__ = ("names", "name_off", "packed", "seq_off", "lengths")

    def __init__(self, names, name_off, packed, seq_off, lengths):
        self.names, self.name_off = names, name_off
        self.packed, self.seq_off = packed, seq_off
        self.lengths = lengths

    def __len__(self) -> int:
        return len(self.lengths)

    def name(self, i: int) -> str:
        return self.names[self.name_off[i]:self.name_off[i + 1]] \
            .tobytes().decode()

    def seq(self, i: int) -> str:
        """Row ``i``'s bases, letter for letter as ``BamReader`` reads them."""
        pairs = _PAIR_LETTERS[self.packed[self.seq_off[i]:
                                          self.seq_off[i + 1]]]
        return pairs.reshape(-1)[:self.lengths[i]].tobytes().decode("ascii")

    def take(self, a: int, b: int) -> "PackedReads":
        """Rows ``a`` to ``b`` (views of this batch's arrays)."""
        b = min(b, len(self))
        no, so = self.name_off, self.seq_off
        return PackedReads(self.names[no[a]:no[b]], no[a:b + 1] - no[a],
                           self.packed[so[a]:so[b]], so[a:b + 1] - so[a],
                           self.lengths[a:b])

    @staticmethod
    def concat(parts: list) -> "PackedReads":
        if len(parts) == 1:
            return parts[0]

        def offsets(arrays):
            shift = np.cumsum([0] + [a[-1] for a in arrays[:-1]])
            return np.concatenate([arrays[0][:1]] + [
                a[1:] + s for a, s in zip(arrays, shift)])
        return PackedReads(
            np.concatenate([p.names for p in parts]),
            offsets([p.name_off for p in parts]),
            np.concatenate([p.packed for p in parts]),
            offsets([p.seq_off for p in parts]),
            np.concatenate([p.lengths for p in parts]))

    def codes(self, multiple: int = 128) -> tuple[np.ndarray, np.ndarray]:
        """The filter's upload: the int8 codes in a (B, L) batch, each row
        zero past its length, L rounded up to ``multiple``, B padded to a
        power of two with rows of 4 (length 0); and the int32 lengths."""
        n = len(self)
        max_len = int(self.lengths.max())
        width = -(-max_len // multiple) * multiple
        b_pad = 1 << (n - 1).bit_length()
        batch = np.zeros((b_pad, width), dtype=np.int8)
        batch[n:] = 4
        lengths = np.zeros(b_pad, dtype=np.int32)
        lengths[:n] = self.lengths
        nbytes = (max_len + 1) // 2
        if nbytes == 0:
            return batch, lengths
        if len(self.packed) == n * nbytes:
            grid = self.packed.reshape(n, nbytes)
        else:
            # each row's bytes and those after it, to the widest row's
            # count; the bases past a row's length are zeroed below
            grid = self.packed[np.minimum(
                self.seq_off[:-1, None] + np.arange(nbytes),
                len(self.packed) - 1)]
        rows = _PAIR_CODES16[grid].view(np.int8)
        short = np.flatnonzero(self.lengths < 2 * nbytes)
        if len(short):
            rows[short] = np.where(
                np.arange(2 * nbytes) < self.lengths[short, None],
                rows[short], 0)
        batch[:n, :2 * nbytes] = rows[:, :width]
        return batch, lengths


def _blocks(fh):
    """(compressed data, inflated size) of each BGZF block from the file's
    position on; stops where less than a block header is left, as
    ``BgzfReader`` does."""
    buf, pos = b"", 0
    while True:
        if len(buf) - pos < _MAX_BLOCK:
            buf = buf[pos:] + fh.read(_READ_BYTES)
            pos = 0
        if len(buf) - pos < 12:
            return
        if buf[pos] != 0x1F or buf[pos + 1] != 0x8B:
            raise ValueError("not a BGZF/gzip stream")
        xlen = struct.unpack_from("<H", buf, pos + 10)[0]
        bsize, i = None, pos + 12
        while i + 4 <= pos + 12 + xlen:
            slen = struct.unpack_from("<H", buf, i + 2)[0]
            if buf[i] == 66 and buf[i + 1] == 67 and slen == 2:
                bsize = struct.unpack_from("<H", buf, i + 4)[0] + 1
            i += 4 + slen
        if bsize is None:
            raise ValueError("missing BGZF BC extra field")
        end = pos + bsize
        if end > len(buf):
            raise ValueError("truncated BGZF block")
        yield (memoryview(buf)[pos + 12 + xlen:end - 8],
               struct.unpack_from("<I", buf, end - 4)[0])
        pos = end


def _inflate(cdata) -> bytes:
    return zlib.decompress(cdata, wbits=-15)


def _inflated(path: str, voffset: int, chunk_bytes: int):
    """The BGZF stream of ``path`` from virtual offset ``voffset`` on, in
    chunks of about ``chunk_bytes`` inflated bytes: each chunk's blocks
    inflate in threads, and the next chunk's while this one is used."""
    skip = voffset & 0xFFFF

    def joined(futures) -> bytes:
        nonlocal skip
        out = b"".join(f.result() for f in futures)
        if skip:
            out, skip = out[skip:], 0
        return out

    with open(path, "rb") as fh, \
            ThreadPoolExecutor(INFLATE_THREADS) as pool:
        fh.seek(voffset >> 16)
        group, size, ahead = [], 0, []
        for cdata, isize in _blocks(fh):
            group.append(pool.submit(_inflate, cdata))
            size += isize
            if size >= chunk_bytes:
                if ahead:
                    yield joined(ahead)
                ahead, group, size = group, [], 0
        for futures in (ahead, group):
            if futures:
                yield joined(futures)


def _unmapped_of_chunk(lib, data: bytes):
    """Walk the whole records at the head of ``data``: (the unmapped ones
    as ``PackedReads`` or None, records walked, bytes consumed)."""
    n = len(data)
    cap = n // _RECORD_MIN + 1
    names = np.empty(n, dtype=np.uint8)
    packed = np.empty(n, dtype=np.uint8)
    name_off = np.empty(cap + 1, dtype=np.int64)
    seq_off = np.empty(cap + 1, dtype=np.int64)
    lengths = np.empty(cap, dtype=np.int32)
    out = np.zeros(3, dtype=np.int64)
    if lib.bam_scan_chunk(data, n, names, name_off, packed, seq_off, lengths,
                          out):
        raise ValueError("malformed BAM record (a block_size under 32, or "
                         "fields past its end)")
    walked, rows, used = (int(v) for v in out)
    if not rows:
        return None, walked, used
    return PackedReads(names[:name_off[rows]].copy(),
                       name_off[:rows + 1].copy(),
                       packed[:seq_off[rows]].copy(),
                       seq_off[:rows + 1].copy(),
                       lengths[:rows].copy()), walked, used


def scan_unmapped(bam, batch_size: int = 1024,
                  chunk_bytes: int = CHUNK_BYTES):
    """Yield a ``BamReader``'s unmapped records in file order, as
    ``PackedReads`` batches of ``batch_size`` (the last may be shorter).
    Counts ``recruit.scan_records`` (records walked) and
    ``recruit.scan_unmapped`` (records kept) a chunk at a time.  Raises
    where the native walk cannot be built (``native_bridge``)."""
    lib = native_bridge.load_bam_scan()
    carry = b""
    pending, n_pending = [], 0
    for piece in _inflated(bam.path, bam._data_voffset, chunk_bytes):
        data = carry + piece if carry else piece
        reads, walked, used = _unmapped_of_chunk(lib, data)
        carry = data[used:]
        if walked:
            count("recruit.scan_records", walked)
        if reads is not None:
            count("recruit.scan_unmapped", len(reads))
            pending.append(reads)
            n_pending += len(reads)
        if n_pending >= batch_size:
            joined = PackedReads.concat(pending)
            full = n_pending - n_pending % batch_size
            for s in range(0, full, batch_size):
                yield joined.take(s, s + batch_size)
            pending = [joined.take(full, n_pending)] if full < n_pending \
                else []
            n_pending -= full
    if len(carry) >= 4:
        raise ValueError(f"{bam.path}: truncated BAM record at its end")
    if n_pending:
        yield PackedReads.concat(pending)
