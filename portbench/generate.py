"""The one input generator: a panel of loci from a configuration, a sample
of reads from a traffic mix and a seed, and the files a user hands to
``genotype`` (the model database, a coordinate-sorted BAM with its index,
or a FASTA of long reads).

Rewritten from the loci and read generators the repository already had
(``benchmarks/panel_bench.make_panel``/``build_inputs``,
``advntr_tpu_torch.synthetic.write_pacbio_panel`` and the simulators of
``advntr_tpu_torch.engine.simulate``), in NumPy, and frozen here: later
changes to the program do not change the inputs.  A panel depends only on
its configuration (it stands for a published database); a sample depends
on the traffic mix and the seed.
"""

from __future__ import annotations

import dataclasses
import os
import sqlite3
import struct
import zlib

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _COMP[_a] = _b


@dataclasses.dataclass
class Locus:
    vid: int
    pattern: str
    ref_copies: int
    left: str                 # the database's left flank
    right: str                # the database's right flank
    start: int                # reference position of the tract
    allele_range: tuple       # (lo, hi) copies a sample may carry
    alleles: tuple | None = None   # fixed alleles, where the panel sets them
    context_left: str = ""    # genome beyond the flanks (long reads only)
    context_right: str = ""


def _rng(*key) -> np.random.Generator:
    """A generator from whole numbers of any size (seeds past 32 bits)."""
    return np.random.default_rng([int(k) % (1 << 64) for k in key])


def _seq(rng: np.random.Generator, n: int) -> str:
    return BASES[rng.integers(0, 4, n)].tobytes().decode()


def make_panel(config: dict) -> list[Locus]:
    """The configuration's loci, from its own fixed seed."""
    p = config["panel"]
    rng = _rng(p["seed"])
    loci = []
    for i in range(p["loci"]):
        long_tract = bool(p.get("long_every")) and \
            i % p["long_every"] == p.get("long_offset", 0)
        if long_tract:
            plen = int(rng.choice(p["long_motif_lengths"]))
            lo_bp, hi_bp = p["long_tract_bp"]
            ref_copies = max(3, int(rng.integers(lo_bp, hi_bp + 1)) // plen)
            lo, hi = ref_copies - 3, ref_copies + 3
        else:
            plen = int(rng.choice(p["motif_lengths"]))
            hi = max(p["min_copies"], min(p.get("max_copies", 1 << 30),
                                          p["max_tract_bp"] // plen))
            lo = p["min_copies"]
            ref_copies = int(rng.integers(lo, hi + 1))
        pattern = _seq(rng, plen)
        left = _seq(rng, p["flank"])
        right = _seq(rng, p["flank"])
        alleles = None
        if p.get("fixed_alleles"):
            alleles = tuple(sorted(int(x) for x in rng.integers(lo, hi + 1, 2)))
        ctx = p.get("context_bp", 0)
        loci.append(Locus(
            vid=p["id_base"] + i, pattern=pattern, ref_copies=ref_copies,
            left=left, right=right, start=10_000 * (i + 1) * p.get(
                "spacing", 1), allele_range=(lo, hi), alleles=alleles,
            context_left=_seq(rng, ctx) if ctx else "",
            context_right=_seq(rng, ctx) if ctx else ""))
    return loci


def write_db(path: str, loci: list[Locus], chromosome: str = "chr1") -> None:
    """adVNTR's model database (table ``vntrs``, segments comma-joined)."""
    if os.path.exists(path):
        os.remove(path)
    db = sqlite3.connect(path)
    db.execute(
        "CREATE TABLE vntrs(id INTEGER PRIMARY KEY, nonoverlapping TEXT, "
        "chromosome TEXT, ref_start INTEGER, gene_name TEXT, annotation TEXT,"
        " pattern TEXT, left_flanking TEXT, right_flanking TEXT, repeats "
        "TEXT, scaled_score REAL default 0)")
    db.executemany(
        "INSERT INTO vntrs VALUES(?,?,?,?,?,?,?,?,?,?,?)",
        [(lc.vid, "True", chromosome, lc.start, "None", "None", lc.pattern,
          lc.left, lc.right, ",".join([lc.pattern] * lc.ref_copies), 0)
         for lc in loci])
    db.commit()
    db.close()


def _codes(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), dtype=np.uint8)


def revcomp(seq: str) -> str:
    return _COMP[_codes(seq)[::-1]].tobytes().decode()


def _substitute(rng, arr: np.ndarray, rate: float) -> np.ndarray:
    """Each base replaced, at ``rate``, by a uniformly drawn base (which may
    be the same one, as the original simulator did)."""
    hit = rng.random(arr.shape) < rate
    out = arr.copy()
    out[hit] = BASES[rng.integers(0, 4, int(hit.sum()))]
    return out


def _indel_errors(rng, arr: np.ndarray, sub: float, ins: float,
                  dele: float) -> np.ndarray:
    """Long-read noise: per base a deletion, an insertion after it, or a
    substitution, with the given rates."""
    r = rng.random(arr.size)
    is_del = r < dele
    is_ins = (r >= dele) & (r < dele + ins)
    is_sub = (r >= dele + ins) & (r < dele + ins + sub)
    base = arr.copy()
    base[is_sub] = BASES[rng.integers(0, 4, int(is_sub.sum()))]
    extra = BASES[rng.integers(0, 4, arr.size)]
    reps = np.where(is_del, 0, np.where(is_ins, 2, 1))
    out = np.empty(int(reps.sum()), dtype=np.uint8)
    pos = np.cumsum(reps) - reps          # first output slot of each base
    keep = reps > 0
    out[pos[keep]] = base[keep]
    out[pos[is_ins] + 1] = extra[is_ins]
    return out


def _background(rng, n: int, length: int, gc: float) -> list:
    """``n`` reads of ``length`` bases from nowhere in the panel: each base
    drawn with the genome's GC share, in blocks so that memory stays
    small."""
    half = (1.0 - gc) / 2.0
    cum = np.cumsum([half, gc / 2.0, gc / 2.0])
    out = []
    for b0 in range(0, n, 50_000):
        m = min(50_000, n - b0)
        codes = BASES[np.searchsorted(cum, rng.random((m, length)))]
        out += [(f"bg{b0 + k}", codes[k].tobytes().decode())
                for k in range(m)]
    return out


def background_count(traffic: dict, scale: float) -> int:
    """Unmapped reads from elsewhere in a whole genome that a sample's BAM
    holds: the genome's reads at the coverage, times the unmapped share,
    scaled as the panel is."""
    t, bg = traffic["reads"], traffic.get("background")
    if not bg:
        return 0
    return int(round(bg["genome_bp"] * t["coverage"] / t["read_length"] *
                     bg["unmapped_share"] * scale))


def make_sample(loci: list[Locus], traffic: dict, seed: int, sample: int,
                scale: float = 0.0) -> tuple[list, dict, dict]:
    """One sample's reads [(name, sequence)], shuffled, its true alleles
    {vid: (a, b)}, and where its mapped reads align {name: 0-based
    reference start}.  Short reads are drawn inside each haplotype,
    forward strand, with substitutions; a read maps, at the position its
    longer flank anchors, where that flank holds ``map_anchor_bp`` bases,
    and is unmapped otherwise; the traffic's ``background`` adds unmapped
    reads from elsewhere in the genome, ``scale`` times a whole genome's.
    Long reads are drawn anywhere over the haplotype and its genome
    context, with indels, in either orientation, and none is mapped."""
    t = traffic["reads"]
    rng = _rng(seed, sample, 0x5EED)
    reads, truth, placed = [], {}, {}
    L = t["read_length"]
    anchor = t.get("map_anchor_bp")
    for lc in loci:
        if lc.alleles is not None:
            alleles = lc.alleles
        else:
            lo, hi = lc.allele_range
            alleles = tuple(sorted(int(x) for x in rng.integers(lo, hi + 1, 2)))
        truth[lc.vid] = alleles
        m, F = len(lc.pattern), len(lc.left)
        for h, copies in enumerate(alleles):
            hap = _codes(lc.context_left + lc.left + lc.pattern * copies +
                         lc.right + lc.context_right)
            if t["kind"] == "short":
                n = int(len(hap) * t["coverage"] / 2 / L)
                starts = rng.integers(0, len(hap) - L + 1, n)
                win = hap[starts[:, None] + np.arange(L)[None, :]]
                win = _substitute(rng, win, t["substitution"])
                for k in range(n):
                    name = f"L{lc.vid}_h{h}_{k}"
                    reads.append((name, win[k].tobytes().decode()))
                    if anchor is None:
                        continue
                    s = int(starts[k])
                    left_bp = F - s
                    right_bp = s + L - (F + copies * m)
                    if left_bp >= anchor and left_bp >= right_bp:
                        placed[name] = lc.start - F + s
                    elif right_bp >= anchor:
                        placed[name] = lc.start + (lc.ref_copies - copies) \
                            * m - F + s
            else:
                span = max(len(hap), L)
                n = max(1, int(round(span * t["coverage"] / 2 / L)))
                starts = rng.integers(-(L - 1), len(hap), n)
                flips = rng.random(n) < t.get("reverse_share", 0.5)
                for k in range(n):
                    s = int(starts[k])
                    win = hap[max(0, s):s + L]
                    seq = _indel_errors(rng, win, t["substitution"],
                                        t["insertion"], t["deletion"])
                    if seq.size < 30:
                        continue
                    text = seq.tobytes().decode()
                    if flips[k]:
                        text = revcomp(text)
                    reads.append((f"L{lc.vid}_h{h}_lr{k}", text))
    n_bg = background_count(traffic, scale)
    if n_bg:
        reads += _background(rng, n_bg, L,
                             traffic["background"]["gc_share"])
    order = rng.permutation(len(reads))
    return [reads[i] for i in order], truth, placed


# ---- BAM (BGZF) with its index, FASTA ------------------------------------

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
_BAM_CODE = np.zeros(256, dtype=np.uint8)
for _i, _c in enumerate(b"=ACMGRSVTWYHKDBN"):
    _BAM_CODE[_c] = _i


def _bgzf_blocks(payload: bytes, level: int = 6):
    for s in range(0, len(payload), 65280):
        chunk = payload[s:s + 65280]
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        cdata = co.compress(chunk) + co.flush()
        yield (struct.pack("<4BI2BH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6) +
               struct.pack("<2BHH", 66, 67, 2, len(cdata) + 25) + cdata +
               struct.pack("<II", zlib.crc32(chunk) & 0xFFFFFFFF, len(chunk)))


def _reg2bin(beg: int, end: int) -> int:
    """The BAM specification's bin of [beg, end)."""
    end -= 1
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return base + (beg >> shift)
    return 0


def write_bam(path: str, reads: list, placed: dict,
              chromosome: str = "chr1", length: int = 249_250_621,
              mapq: int = 60) -> None:
    """A coordinate-sorted BAM and its BAI index: the reads in ``placed``
    aligned forward at their positions (one match operation over the
    read, mapping quality ``mapq``), then the others unmapped (flag 4);
    base quality 38 throughout."""
    name = chromosome.encode() + b"\x00"
    out = bytearray(b"BAM\x01" + struct.pack("<i", 0) + struct.pack("<i", 1)
                    + struct.pack("<i", len(name)) + name
                    + struct.pack("<i", length))
    order = sorted((placed[n], i) for i, (n, _) in enumerate(reads)
                   if n in placed)
    order = [i for _, i in order] + [i for i, (n, _) in enumerate(reads)
                                     if n not in placed]
    # every read's bases packed two to a byte, in one pass: a read of odd
    # length takes a pad base
    seqs = [reads[i][1] for i in order]
    joined = b"".join(s.encode() + (b"=" if len(s) % 2 else b"")
                      for s in seqs)
    codes = _BAM_CODE[np.frombuffer(joined, dtype=np.uint8)]
    packed = (codes[0::2] << 4 | codes[1::2]).astype(np.uint8).tobytes()
    ends = np.cumsum([(len(s) + 1) // 2 for s in seqs]).tolist()
    quals: dict = {}
    pieces = [bytes(out)]
    u = len(out)
    mapped_spans = []       # (beg, end, uncompressed start, end)
    fixed = struct.Struct("<iiiBBHHHiiii")
    p0 = 0
    for i, seq, p1 in zip(order, seqs, ends):
        qn = reads[i][0].encode() + b"\x00"
        n = len(seq)
        pos = placed.get(reads[i][0])
        if pos is None:
            size = 32 + len(qn) + (p1 - p0) + n
            head = fixed.pack(size, -1, -1, len(qn), 0, 4680, 0, 4, n, -1,
                              -1, 0) + qn
        else:
            size = 36 + len(qn) + (p1 - p0) + n
            head = fixed.pack(size, 0, pos, len(qn), mapq,
                              _reg2bin(pos, pos + n), 1, 0, n, -1, -1,
                              0) + qn + struct.pack("<I", n << 4)
            mapped_spans.append((pos, pos + n, u, u + 4 + size))
        qual = quals.get(n)
        if qual is None:
            qual = quals[n] = bytes([38]) * n
        pieces += (head, packed[p0:p1], qual)
        u += 4 + size
        p0 = p1
    out = b"".join(pieces)
    blocks = list(_bgzf_blocks(out, level=1))
    starts = np.cumsum([0] + [len(b) for b in blocks])

    def voff(u: int) -> int:
        k, within = divmod(u, 65280)
        return int(starts[k]) << 16 | within

    with open(path, "wb") as fh:
        for block in blocks:
            fh.write(block)
        fh.write(_BGZF_EOF)
    bins: dict = {}
    linear: list = []
    for beg, end, u0, u1 in mapped_spans:
        v0, v1 = voff(u0), voff(u1)
        chunks = bins.setdefault(_reg2bin(beg, end), [])
        if chunks and chunks[-1][1] == v0:
            chunks[-1][1] = v1
        else:
            chunks.append([v0, v1])
        for w in range(beg >> 14, ((end - 1) >> 14) + 1):
            while len(linear) <= w:
                linear.append(None)
            if linear[w] is None:
                linear[w] = v0
    prev = 0
    for w, v in enumerate(linear):      # an empty window takes the last
        linear[w] = prev = prev if v is None else v
    idx = bytearray(b"BAI\x01" + struct.pack("<ii", 1, len(bins)))
    for b, chunks in sorted(bins.items()):
        idx += struct.pack("<Ii", b, len(chunks))
        for v0, v1 in chunks:
            idx += struct.pack("<QQ", v0, v1)
    idx += struct.pack("<i", len(linear)) + struct.pack(
        f"<{len(linear)}Q", *linear)
    idx += struct.pack("<Q", len(reads) - len(mapped_spans))
    with open(path + ".bai", "wb") as fh:
        fh.write(bytes(idx))


def write_fasta(path: str, reads: list) -> None:
    with open(path, "w") as fh:
        for name, seq in reads:
            fh.write(f">{name}\n{seq}\n")
