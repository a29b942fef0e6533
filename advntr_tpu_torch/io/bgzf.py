"""BGZF (blocked gzip) reader/writer with virtual offsets.

BAM files are BGZF streams: a series of gzip members, each <= 64KiB of
uncompressed payload, with the compressed block size recorded in a 'BC'
gzip extra field.  Virtual file offsets pack (compressed block start << 16 |
offset within uncompressed block), which is what BAI indexes address.

Replaces the reference's dependence on pysam/samtools for (de)compression
(sam_utils.py:18-21).
"""

from __future__ import annotations

import struct
import zlib

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_HEADER = struct.Struct("<4BI2BH")


class BgzfReader:
    def __init__(self, path: str):
        self._fh = open(path, "rb")
        self._block_start = 0   # compressed offset of current block
        self._buffer = b""
        self._within = 0
        self._load_block(0)

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _load_block(self, compressed_offset: int | None = None) -> bool:
        if compressed_offset is not None:
            self._fh.seek(compressed_offset)
        self._block_start = self._fh.tell()
        header = self._fh.read(12)
        if len(header) < 12:
            self._buffer = b""
            self._within = 0
            return False
        magic1, magic2, _, flg, _, _, _, xlen = _HEADER.unpack(header)
        if magic1 != 0x1F or magic2 != 0x8B:
            raise ValueError("not a BGZF/gzip stream")
        extra = self._fh.read(xlen)
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], \
                struct.unpack_from("<H", extra, i + 2)[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack_from("<H", extra, i + 4)[0] + 1
            i += 4 + slen
        if bsize is None:
            raise ValueError("missing BGZF BC extra field")
        cdata = self._fh.read(bsize - xlen - 20)
        self._fh.read(8)  # CRC32 + ISIZE
        self._buffer = zlib.decompress(cdata, wbits=-15)
        self._within = 0
        return True

    # ---- sequential reading ----

    def read(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            avail = len(self._buffer) - self._within
            if avail == 0:
                if not self._load_block():
                    break
                if not self._buffer:  # EOF block
                    if not self._load_block():
                        break
                continue
            take = min(n, avail)
            out += self._buffer[self._within:self._within + take]
            self._within += take
            n -= take
        return bytes(out)

    # ---- virtual offsets ----

    def tell_virtual(self) -> int:
        if self._within == len(self._buffer):
            # canonical form: start of next block
            return self._fh.tell() << 16
        return (self._block_start << 16) | self._within

    def seek_virtual(self, voffset: int) -> None:
        coffset, within = voffset >> 16, voffset & 0xFFFF
        self._load_block(coffset)
        self._within = within


class BgzfWriter:
    def __init__(self, path: str, level: int = 6):
        self._fh = open(path, "wb")
        self._level = level
        self._buffer = bytearray()

    def write(self, data: bytes) -> None:
        self._buffer += data
        while len(self._buffer) >= 65280:
            self._flush_block(self._buffer[:65280])
            del self._buffer[:65280]

    def _flush_block(self, payload: bytes) -> None:
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(payload) + co.flush()
        bsize = len(cdata) + 25 + 1
        header = struct.pack("<4BI2BH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6)
        extra = struct.pack("<2BH H", 66, 67, 2, bsize - 1)
        footer = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                             len(payload))
        self._fh.write(header + extra + cdata + footer)

    def tell_virtual(self) -> int:
        return (self._fh.tell() << 16) | len(self._buffer)

    def close(self) -> None:
        if self._buffer:
            self._flush_block(bytes(self._buffer))
            self._buffer.clear()
        self._fh.write(BGZF_EOF)
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
