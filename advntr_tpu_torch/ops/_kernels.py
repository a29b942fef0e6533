"""Build, load and launch the hand-written CUDA kernels.

Each ``csrc/*.cu`` is compiled with nvcc for sm_90a into a shared library
of its own with a plain C interface, at first use, into
``advntr_tpu_torch/build/``; the compilers run side by side.  A file name
carries a hash of its source and flags, so an edited source is rebuilt.
The libraries are loaded with ctypes; every pointer and the stream are
passed as ``c_void_p``.  Each C entry point returns ``cudaGetLastError()``
after its launch, and a non-zero code raises here: a launch refused for
its thread count or shared memory never runs, and a later synchronize
would not report it.

Both Viterbi kernels take a group of G same-shape loci in one launch
(``ops/struct_model.py::StructModelStack``); one locus is G = 1.  Both
also run on a range of columns with an entry and an exit state
(``forward_segment``, ``backward_segment``): what the checkpointed
traceback is made of.  B1 has two entries in one source: one CTA a read
with one thread per match position for models of up to ``MAX_THREADS``
positions, and a wide entry that spreads a read over a thread block
cluster, each CTA a slice of the positions with its state in its own
shared memory (``wide_layout``); ``forward`` chooses by the model's shape
(``takes_wide_entry``).

The kernels' attribute calls (``cudaFuncSetAttribute``) and launches act
on the process's current CUDA device, so each wrapper makes its tensors'
device current for the call (``torch.cuda.device``); tensors on two
devices in one call raise ValueError.

``LAUNCHES`` counts the launches of each kernel, so a run can show that it
went through the kernels.  ``BUILD_LOG`` holds what ``ptxas -v`` said of
each kernel (registers, shared memory, spills) when this process built.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from advntr_tpu_torch.ops.struct_model import (
    LN05, MBIT16, MBIT32, origin_params)

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
SOURCES = ("viterbi_forward.cu", "viterbi_backward.cu", "local_align.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# B1's first entry runs one thread per match position, a lane of its warp 0
# takes up to 4 units and its threads hold 10 rounds of weights; a model
# past any of these takes the wide entry
MAX_THREADS = 1024
MAX_UNITS = 128
MAX_ROUNDS = 10
# the wide entry: at most 16 CTAs a cluster (past 8 the card's
# non-portable sizes), one or two positions a thread, the 227 KB of shared
# memory a CTA can have
WIDE_MAX_CLUSTER = 16
WIDE_MAX_PPT = 2
WIDE_MAX_ROUNDS = 15
# the first rounds of the delete chain run on a halo of the 2^9 - 1
# positions left of each slice, with block barriers only
HALO_ROUNDS = 9
SMEM_MAX = 232448
MAX_STRUCT = 12288          # B2 stages state tables of up to 2P + nb entries
MAX_PROBE = 128             # local_align holds the probe four to a lane
MAX_PASSES = 8              # (probe, read batch) pairs a local_align launch
ALIGN_WARPS_PER_SM = 16     # local_align splits reads into chunks for these

LAUNCHES = {"forward": 0, "forward_wide": 0, "backward": 0,
            "local_align": 0}
BUILD_SECONDS: float | None = None
BUILD_LOG = ""
_libs = None

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def library_path(source: str) -> Path:
    digest = hashlib.sha256((CSRC / source).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}_{digest.hexdigest()[:16]}.so"


def compile_sources(jobs) -> str:
    """Run one nvcc per (source path, output path) job, all at once;
    returns the compilers' diagnostics (``ptxas -v``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src, out in jobs:
        tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log = []
    for cmd, tmp, out, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed (%d):\n%s\n%s" % (
                proc.returncode, " ".join(cmd), err[-4000:]))
        os.replace(tmp, out)
        log.append(err)
    return "".join(log)


def build() -> dict:
    """Compile (where a hashed library is missing) and load the kernels:
    {source name: CDLL}."""
    global _libs, BUILD_SECONDS, BUILD_LOG
    if _libs is not None:
        return _libs
    t0 = time.perf_counter()
    paths = {name: library_path(name) for name in SOURCES}
    missing = [(CSRC / name, out)
               for name, out in paths.items() if not out.exists()]
    if missing:
        BUILD_LOG = compile_sources(missing)
    libs = {name: ctypes.CDLL(str(out)) for name, out in paths.items()}
    fwd = libs["viterbi_forward.cu"]
    fwd.advntr_viterbi_forward.argtypes = ([_VP] * 22 + [_I] * 17
                                           + [_VP, _F, _VP])
    fwd.advntr_viterbi_forward.restype = _I
    fwd.advntr_forward_wide_max_clusters.argtypes = [_I] * 7 + [_VP]
    fwd.advntr_forward_wide_max_clusters.restype = _I
    fwd.advntr_error_string.argtypes = [_I]
    fwd.advntr_error_string.restype = ctypes.c_char_p
    fn = libs["viterbi_backward.cu"].advntr_viterbi_backward
    fn.argtypes = [_VP] * 10 + [_I] * 10 + [_VP]
    fn.restype = _I
    fn = libs["local_align.cu"].advntr_local_align
    fn.argtypes = [_VP] * 8 + [_I] * 7 + [_VP]
    fn.restype = _I
    BUILD_SECONDS = time.perf_counter() - t0
    _libs = libs
    return libs


def _check(code: int, what: str) -> None:
    if code != 0:
        text = build()["viterbi_forward.cu"].advntr_error_string(code)
        raise RuntimeError("%s launch failed: CUDA error %d (%s)" % (
            what, code, text.decode()))


def _ptr(x: torch.Tensor) -> int:
    return x.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _one_device(*tensors) -> torch.device:
    """The one device of a call's tensors (None entries skipped)."""
    devices = {t.device for t in tensors if t is not None}
    _require(len(devices) == 1,
             f"the kernel's tensors are on {len(devices)} devices: "
             f"{sorted(map(str, devices))}")
    return devices.pop()


def _check_stack(s, device) -> None:
    """The kernels read the model tables by raw pointer: they must be
    contiguous, on the inputs' device, with the shapes the stack states."""
    G, P, nb, C = s.G, s.P, s.nb, s.C
    tables = (s.pos, s.blk, s.eM, s.eI, s.eI0, s.Wd, s.Wu, s.blk_idx,
              s.exp_base, s.unit_last, s.region, s.unit, s.suffix_last,
              s.r_unit)
    _require(all(t.device == device and t.is_contiguous()
                 and t.shape[0] == G for t in tables),
             "model tables must be contiguous (G, ...) tensors on the "
             "inputs' device")
    _require(s.pos.shape[2] == P and s.blk.shape[2] == nb
             and s.Wd.shape[2] == P and s.Wu.shape[2] == C
             and s.region.shape[1] == 2 * P + nb,
             "model tables disagree with (P, nb, C)")


def takes_wide_entry(s) -> bool:
    """Whether a model's shape is past B1's first entry."""
    return (s.P > MAX_THREADS or s.C > MAX_UNITS
            or s.Wd.shape[1] > MAX_ROUNDS)


@dataclasses.dataclass(frozen=True)
class WideLayout:
    """How B1's wide entry spreads a read: a cluster of ``cluster`` CTAs of
    ``threads`` threads, each CTA a slice of ``slice`` = ``ppt`` x
    ``threads`` consecutive positions (the last one may hold fewer), with
    ``smem`` bytes of shared memory and ``unit_words`` 64-bit words of
    device memory for the per-unit and per-block arrays (0: they are in
    shared memory)."""
    cluster: int
    threads: int
    slice: int
    ppt: int
    smem: int
    unit_words: int = 0


def wide_rounds(P: int, n_rounds_p: int) -> int:
    """Delete-chain rounds that run: those with 2^r < P."""
    return sum(1 for r in range(n_rounds_p) if (1 << r) < P)


def wide_layout(P: int, nb: int, C: int, n_rounds_p: int, n_rounds_c: int,
                cluster: int | None = None,
                ppt: int | None = None) -> WideLayout:
    """The wide entry's layout for a (P, nb, C) model: the fewest CTAs
    whose slices of at most ``MAX_THREADS`` positions cover P, rounded up
    to a warp, up to ``WIDE_MAX_CLUSTER``; past that, more than one
    position a thread.  ``cluster`` and ``ppt`` ask for a cluster size and
    positions a thread instead (the layout may come out with fewer CTAs
    where slices round up to a warp).  The shared bytes are the kernel's
    carve (csrc/viterbi_forward.cu::wide_smem_bytes, which the launch
    checks): 72 bytes a position of the slice, 16 a unit, and 24 more a
    unit once the unit chain's buffers outgrow the rounds' (C past about
    2/3 of the slice and halo); up to ``MAX_UNITS`` units the unit tables
    are staged too.  Where that passes ``SMEM_MAX`` (past 16 x 1,024
    positions with motifs under about 7.5 bp), the per-unit and per-block
    arrays move to device memory (``unit_words`` a CTA, as
    csrc/viterbi_forward.cu::wide_unit_words counts them) and the shared
    bytes no longer depend on C: every model of up to 32,768 positions
    fits.  Raises ValueError for a shape the entry does not take."""
    _require(P >= 1 and C >= 1 and C + 2 <= nb,
             f"B1's wide entry takes P >= 1, C >= 1 and C + 2 <= nb; got "
             f"P={P}, C={C}, nb={nb}")
    n = cluster or min(-(-P // MAX_THREADS), WIDE_MAX_CLUSTER)
    _require(1 <= n <= WIDE_MAX_CLUSTER,
             f"a cluster holds 1 to {WIDE_MAX_CLUSTER} CTAs; got {n}")
    per = -(-P // n)
    ppt = ppt or -(-per // MAX_THREADS)
    threads = 32 * -(-per // (32 * ppt))
    width = threads * ppt
    n = -(-P // width)
    rounds = wide_rounds(P, n_rounds_p)
    extra = max(rounds - MAX_ROUNDS, 0)
    halo_rounds = min(rounds, HALO_ROUNDS)
    halo = (1 << halo_rounds) - 1
    staged = (1 + n_rounds_c) * C + 7 * nb if C <= MAX_UNITS else 0
    fixed = 8 * (7 * width + 2) + 4 * (extra * width
                                       + (halo_rounds + 4) * halo
                                       + 3 * 32 + 2 * WIDE_MAX_CLUSTER)
    rounds_buf = 8 * 2 * (halo + width)
    smem = (fixed + max(rounds_buf, 8 * (3 * C + 1))
            + 4 * (3 * nb + C + staged))
    unit_words = 0
    if smem > SMEM_MAX:
        smem = fixed + rounds_buf
        unit_words = 3 * C + 1 + (3 * nb + 1) // 2
    _require(1 <= ppt <= WIDE_MAX_PPT and threads <= MAX_THREADS
             and rounds <= WIDE_MAX_ROUNDS and smem <= SMEM_MAX,
             f"B1's wide entry takes up to {WIDE_MAX_PPT} positions a "
             f"thread in {WIDE_MAX_CLUSTER} CTAs of up to {MAX_THREADS} "
             f"threads, {WIDE_MAX_ROUNDS} rounds and {SMEM_MAX} bytes of "
             f"shared memory a CTA; P={P}, C={C}, nb={nb} need {ppt} a "
             f"thread in CTAs of {threads}, {rounds} rounds and {smem} bytes")
    return WideLayout(n, threads, width, ppt, smem, unit_words)


def wide_max_clusters(lay: WideLayout, C: int, origin32: bool) -> int:
    """How many clusters of the layout ``lay`` (a model of C units) the
    card holds at once, as cudaOccupancyMaxActiveClusters reckons it."""
    out = ctypes.c_int(0)
    code = build()["viterbi_forward.cu"].advntr_forward_wide_max_clusters(
        C, int(origin32), lay.cluster, lay.slice, lay.threads, lay.smem,
        int(lay.unit_words > 0), ctypes.byref(out))
    _check(code, "cudaOccupancyMaxActiveClusters on viterbi_forward_wide")
    return out.value


def state_widths(s) -> tuple[int, int]:
    """Widths of a forward state's float and integer parts."""
    return 3 * s.P + 2 * s.nb, s.P + s.nb


def _launch_forward(s, seqs, lengths, origin32, state, t0, planes,
                    keep_state, wide):
    """One launch of B1 over the columns t0 .. t0 + L - 1."""
    P, nb, C = s.P, s.nb, s.C
    if wide is None:
        wide = takes_wide_entry(s)
    _require(wide or not takes_wide_entry(s),
             f"B1's first entry takes P <= {MAX_THREADS}, C <= {MAX_UNITS} "
             f"and {MAX_ROUNDS} rounds; got P={P}, C={C}, "
             f"{s.Wd.shape[1]} rounds")
    _require(C >= 1 and C + 2 <= nb and (wide or 32 <= P and nb <= P),
             f"B1 takes C >= 1, C + 2 <= nb and, in its first entry, "
             f"32 <= P and nb <= P; got P={P}, C={C}, nb={nb}")
    lay = WideLayout(0, 0, 0, 0, 0)
    if wide:
        lay = wide_layout(P, nb, C, s.Wd.shape[1], s.Wu.shape[1])
    _require(seqs.dim() == 3 and seqs.shape[0] == s.G,
             f"seqs must be (G={s.G}, B, L); got {tuple(seqs.shape)}")
    G, B, L = seqs.shape
    dev = _one_device(seqs, lengths, *(state or ()))
    _require(lengths.shape == (G, B) and lengths.device == dev,
             "lengths must be (G, B) on the device of seqs")
    _check_stack(s, dev)
    wf, wi = state_widths(s)
    if state is not None:
        _require(state[0].shape == (G, B, wf) and state[1].shape == (G, B, wi)
                 and state[0].dtype == torch.float32
                 and state[1].dtype == torch.int32
                 and state[0].device == state[1].device == dev
                 and state[0].is_contiguous() and state[1].is_contiguous(),
                 f"the entry state must be contiguous float32 (G, B, {wf}) "
                 f"and int32 (G, B, {wi}) on the device of seqs")
    lib = build()["viterbi_forward.cu"]
    odt, mbit = origin_params(P, nb, origin32)
    seqs8 = seqs.to(torch.int8).contiguous()
    lengths32 = lengths.to(torch.int32).contiguous()
    oMI = oXH = None
    if planes:
        oMI = torch.empty(G, L, B, 2 * P, dtype=odt, device=dev)
        oXH = torch.empty(G, L, B, 2 * nb, dtype=odt, device=dev)
    best = torch.empty(G, B, dtype=torch.float32, device=dev)
    bstate = torch.empty(G, B, dtype=torch.int32, device=dev)
    exit_ = None
    if keep_state:
        exit_ = (torch.empty(G, B, wf, dtype=torch.float32, device=dev),
                 torch.empty(G, B, wi, dtype=torch.int32, device=dev))
    if B == 0 or L == 0:
        _require(not keep_state, "an empty batch has no state to keep")
        return best, bstate, oMI, oXH, exit_
    # the per-unit arrays of a (locus, read, CTA), where shared memory
    # does not hold them: written before they are read, so not cleared
    units = None
    if lay.unit_words:
        units = torch.empty(G * B * lay.cluster * lay.unit_words,
                            dtype=torch.int64, device=dev)
    opt = lambda x: None if x is None else _ptr(x)
    with torch.cuda.device(dev):
        code = lib.advntr_viterbi_forward(
            _ptr(seqs8), _ptr(lengths32), _ptr(s.pos), _ptr(s.blk),
            _ptr(s.eM), _ptr(s.eI), _ptr(s.eI0), _ptr(s.Wd), _ptr(s.Wu),
            _ptr(s.blk_idx), _ptr(s.exp_base), _ptr(s.unit_last),
            _ptr(s.suffix_last), _ptr(s.r_unit), opt(oMI), opt(oXH),
            _ptr(best), _ptr(bstate),
            opt(state and state[0]), opt(state and state[1]),
            opt(exit_ and exit_[0]), opt(exit_ and exit_[1]),
            G, B, L, P, nb, C, s.Wd.shape[1], s.Wu.shape[1],
            int(odt == torch.int32), mbit, int(t0), int(planes), int(wide),
            lay.cluster, lay.slice, lay.threads, lay.smem, opt(units), LN05,
            _stream(dev))
    _check(code, "viterbi_forward")
    LAUNCHES["forward_wide" if wide else "forward"] += 1
    return best, bstate, oMI, oXH, exit_


def forward(s, seqs, lengths, origin32: bool = False, wide=None):
    """Launch B1 (csrc/viterbi_forward.cu) once for the G loci of the
    stack ``s`` over whole reads: seqs (G, B, L), lengths (G, B), CUDA
    tensors.  ``wide`` forces an entry (None: by the model's shape; the
    wide entry's layout is ``wide_layout``'s).  Returns best (G, B),
    bstate (G, B), oMI (G, L, B, 2P), oXH (G, L, B, 2nb)."""
    return _launch_forward(s, seqs, lengths, origin32, None, 0, True, False,
                           wide)[:4]


def forward_segment(s, seqs, lengths, origin32: bool = False, state=None,
                    t0: int = 0, planes: bool = True, wide=None):
    """Launch B1 once over the columns t0 .. t0 + L - 1 that seqs
    (G, B, L) holds, from ``state`` (None before column 0).  Returns best,
    bstate, oMI, oXH (both None unless ``planes``) and the state after the
    last column."""
    return _launch_forward(s, seqs, lengths, origin32, state, t0, planes,
                           True, wide)


def _launch_backward(s, lengths, bstate, oMI, oXH, return_path, t0, entry,
                     keep_state):
    """One launch of B2 on planes that hold the columns t0 .. t0 + L - 1."""
    _require(oMI.dim() == 4 and oXH.dim() == 4,
             "origin planes must be (G, L, B, width)")
    G, L, B, P2 = oMI.shape
    dev = _one_device(oMI, oXH, lengths, bstate, entry)
    _require(G == s.G and P2 == 2 * s.P
             and oXH.shape == (G, L, B, 2 * s.nb),
             f"origin planes {tuple(oMI.shape)}, {tuple(oXH.shape)} do not "
             f"fit {s.G} models with P={s.P}, nb={s.nb}")
    _require(oMI.dtype == oXH.dtype
             and oMI.dtype in (torch.int16, torch.int32),
             "origin planes must both be int16 or both int32")
    _require(lengths.shape == (G, B) and bstate.shape == (G, B)
             and oXH.device == lengths.device == bstate.device == dev,
             "lengths and bstate must be (G, B) on the planes' device")
    _require(entry is None
             or (entry.shape == (G, B) and entry.device == dev),
             "the entry state must be (G, B) on the planes' device")
    _check_stack(s, dev)
    lib = build()["viterbi_backward.cu"]
    origin32 = oMI.dtype == torch.int32
    mbit = MBIT32 if origin32 else MBIT16
    lengths32 = lengths.to(torch.int32).contiguous()
    bstate32 = bstate.to(torch.int32).contiguous()
    entry32 = None if entry is None else entry.to(torch.int32).contiguous()
    oMI, oXH = oMI.contiguous(), oXH.contiguous()
    path = None
    if return_path:
        path = torch.empty(G, B, L, dtype=torch.int32, device=dev)
    stats = torch.empty(G, B, 16, dtype=torch.int32, device=dev)
    exit_ = None
    if keep_state:
        exit_ = torch.empty(G, B, dtype=torch.int32, device=dev)
    if B == 0:
        return path, stats, exit_
    opt = lambda x: None if x is None else _ptr(x)
    with torch.cuda.device(dev):
        code = lib.advntr_viterbi_backward(
            _ptr(lengths32), _ptr(bstate32), _ptr(oMI), _ptr(oXH),
            _ptr(s.region), _ptr(s.unit), opt(path), _ptr(stats),
            opt(entry32), opt(exit_), G, B, L, s.P, s.nb, s.region.shape[1],
            int(origin32), mbit, int(return_path), int(t0), _stream(dev))
    _check(code, "viterbi_backward")
    LAUNCHES["backward"] += 1
    return path, stats, exit_


def backward(s, lengths, bstate, oMI, oXH, return_path: bool = True):
    """Launch B2 (csrc/viterbi_backward.cu) once for the G loci of the
    stack ``s`` on whole reads' planes (G, L, B, ...).  Returns path
    (G, B, L) int32, or None (nothing allocated, nothing written) unless
    ``return_path``, and stats (G, B, 16) int32.  Models of more than
    ``MAX_STRUCT`` states read their state tables from device memory."""
    return _launch_backward(s, lengths, bstate, oMI, oXH, return_path, 0,
                            None, False)[:2]


def backward_segment(s, lengths, bstate, oMI, oXH, t0: int, entry):
    """Launch B2 once on planes (G, L, B, ...) that hold the columns
    t0 .. t0 + L - 1, from ``entry`` (G, B), the state each read stands
    in at the range's last column.  Returns these columns' path (G, B, L)
    and the state (G, B) above column t0."""
    path, _, exit_ = _launch_backward(s, lengths, bstate, oMI, oXH, True, t0,
                                      entry, True)
    return path, exit_


def align_chunks(passes: int, B: int, L: int, m: int, sms: int) -> int:
    """How many chunks ``local_align_passes`` splits each read into, on a
    card of ``sms`` SMs: enough warps for ``ALIGN_WARPS_PER_SM`` on each,
    but no chunk shorter than the 2m rows it computes before its own
    (csrc/local_align.cu says why those make it exact)."""
    want = -(-ALIGN_WARPS_PER_SM * sms // (passes * B))
    return max(1, min(want, L // (2 * m)))


def local_align_passes(reads, lengths, probes, probe_lengths, read_sets):
    """Launch the batched local alignment (csrc/local_align.cu) once for Q
    passes: reads (R, B, L) int8, lengths (B,) and probes (Q, stride) int8
    on one CUDA device; pass i aligns the first ``probe_lengths[i]`` bases
    of ``probes[i]`` against ``reads[read_sets[i]]`` (both are Q host
    ints).  Returns (score (Q, B), end (Q, B)) int32."""
    _require(reads.dim() == 3 and reads.dtype == torch.int8,
             f"reads must be (R, B, L) int8; got {tuple(reads.shape)} "
             f"{reads.dtype}")
    R, B, L = reads.shape
    dev = _one_device(reads, lengths, probes)
    Q = len(probe_lengths)
    _require(lengths.shape == (B,) and lengths.device == dev
             and probes.dim() == 2 and probes.shape[0] == Q
             and probes.device == dev and probes.dtype == torch.int8
             and len(read_sets) == Q,
             "lengths must be (B,) and probes (Q, stride) int8 on the "
             "reads' device, with a length and a read batch a probe")
    _require(1 <= Q <= MAX_PASSES,
             f"local_align takes 1 to {MAX_PASSES} passes a launch; got {Q}")
    _require(all(1 <= m <= min(MAX_PROBE, probes.shape[1])
                 for m in probe_lengths),
             f"local_align takes probes of 1 to {MAX_PROBE} bases; got "
             f"{list(probe_lengths)}")
    _require(all(0 <= r < R for r in read_sets),
             f"read batches {list(read_sets)} of {R}")
    if B == 0 or L == 0:
        return (torch.zeros(Q, B, dtype=torch.int32, device=dev),
                torch.zeros(Q, B, dtype=torch.int32, device=dev))
    lib = build()["local_align.cu"]
    reads, probes = reads.contiguous(), probes.contiguous()
    lengths32 = lengths.to(torch.int32).contiguous()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunks = align_chunks(Q, B, L, max(probe_lengths), sms)
    rows = -(-L // chunks)
    # every (pass, read) is written by its last chunk to finish
    score = torch.empty(Q, B, dtype=torch.int32, device=dev)
    end = torch.empty(Q, B, dtype=torch.int32, device=dev)
    work = torch.zeros(2, Q, B, dtype=torch.int64, device=dev)
    ints = lambda xs: (ctypes.c_int * Q)(*xs)
    with torch.cuda.device(dev):
        code = lib.advntr_local_align(
            _ptr(reads), _ptr(lengths32), _ptr(probes), ints(probe_lengths),
            ints(read_sets), _ptr(score), _ptr(end), _ptr(work), R, B, L, Q,
            probes.shape[1], chunks, rows, _stream(dev))
    _check(code, "local_align")
    LAUNCHES["local_align"] += 1
    return score, end
