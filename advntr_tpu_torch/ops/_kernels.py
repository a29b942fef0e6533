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

Both kernels take a group of G same-shape loci in one launch
(``ops/struct_model.py::StructModelStack``); one locus is G = 1.

``LAUNCHES`` counts the launches of each kernel, so a run can show that it
went through the kernels.  ``BUILD_LOG`` holds what ``ptxas -v`` said of
each kernel (registers, shared memory, spills) when this process built.
"""

from __future__ import annotations

import ctypes
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
SOURCES = ("viterbi_forward.cu", "viterbi_backward.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_THREADS = 1024          # B1 runs one thread per match position
MAX_UNITS = 128             # a lane of B1's warp 0 takes up to 4 units
MAX_STRUCT = 12288          # B2 stages a state table of 2P + nb entries

LAUNCHES = {"forward": 0, "backward": 0}
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
    fwd.advntr_viterbi_forward.argtypes = [_VP] * 18 + [_I] * 10 + [_F, _VP]
    fwd.advntr_viterbi_forward.restype = _I
    fwd.advntr_error_string.argtypes = [_I]
    fwd.advntr_error_string.restype = ctypes.c_char_p
    fn = libs["viterbi_backward.cu"].advntr_viterbi_backward
    fn.argtypes = [_VP] * 8 + [_I] * 9 + [_VP]
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


def forward(s, seqs, lengths, origin32: bool = False):
    """Launch B1 (csrc/viterbi_forward.cu) once for the G loci of the
    stack ``s``: seqs (G, B, L), lengths (G, B), CUDA tensors.  Returns
    best (G, B), bstate (G, B), oMI (G, L, B, 2P), oXH (G, L, B, 2nb)."""
    P, nb, C = s.P, s.nb, s.C
    if P > MAX_THREADS:
        raise ValueError(
            f"B1 takes at most {MAX_THREADS} match positions (model has "
            f"P={P}); long-read models are ROADMAP item A9")
    _require(P >= 32 and C + 2 <= nb <= P and 1 <= C <= MAX_UNITS
             and s.Wd.shape[1] <= 10,
             f"B1 takes 32 <= P, C <= {MAX_UNITS} and C + 2 <= nb <= P; "
             f"got P={P}, C={C}, nb={nb}")
    _require(seqs.dim() == 3 and seqs.shape[0] == s.G,
             f"seqs must be (G={s.G}, B, L); got {tuple(seqs.shape)}")
    G, B, L = seqs.shape
    dev = seqs.device
    _require(lengths.shape == (G, B) and lengths.device == dev,
             "lengths must be (G, B) on the device of seqs")
    _check_stack(s, dev)
    lib = build()["viterbi_forward.cu"]
    odt, mbit = origin_params(P, nb, origin32)
    seqs8 = seqs.to(torch.int8).contiguous()
    lengths32 = lengths.to(torch.int32).contiguous()
    oMI = torch.empty(G, L, B, 2 * P, dtype=odt, device=dev)
    oXH = torch.empty(G, L, B, 2 * nb, dtype=odt, device=dev)
    best = torch.empty(G, B, dtype=torch.float32, device=dev)
    bstate = torch.empty(G, B, dtype=torch.int32, device=dev)
    if B == 0 or L == 0:
        return best, bstate, oMI, oXH
    code = lib.advntr_viterbi_forward(
        _ptr(seqs8), _ptr(lengths32), _ptr(s.pos), _ptr(s.blk), _ptr(s.eM),
        _ptr(s.eI), _ptr(s.eI0), _ptr(s.Wd), _ptr(s.Wu), _ptr(s.blk_idx),
        _ptr(s.exp_base), _ptr(s.unit_last), _ptr(s.suffix_last),
        _ptr(s.r_unit), _ptr(oMI), _ptr(oXH), _ptr(best), _ptr(bstate),
        G, B, L, P, nb, C, s.Wd.shape[1], s.Wu.shape[1],
        int(odt == torch.int32), mbit, LN05, _stream(dev))
    _check(code, "viterbi_forward")
    LAUNCHES["forward"] += 1
    return best, bstate, oMI, oXH


def backward(s, lengths, bstate, oMI, oXH, return_path: bool = True):
    """Launch B2 (csrc/viterbi_backward.cu) once for the G loci of the
    stack ``s`` on planes (G, L, B, ...).  Returns path (G, B, L) int32,
    or None (nothing allocated, nothing written) unless ``return_path``,
    and stats (G, B, 16) int32."""
    _require(oMI.dim() == 4 and oXH.dim() == 4,
             "origin planes must be (G, L, B, width)")
    G, L, B, P2 = oMI.shape
    dev = oMI.device
    _require(G == s.G and P2 == 2 * s.P
             and oXH.shape == (G, L, B, 2 * s.nb),
             f"origin planes {tuple(oMI.shape)}, {tuple(oXH.shape)} do not "
             f"fit {s.G} models with P={s.P}, nb={s.nb}")
    _require(oMI.dtype == oXH.dtype
             and oMI.dtype in (torch.int16, torch.int32),
             "origin planes must both be int16 or both int32")
    _require(s.region.shape[1] <= MAX_STRUCT,
             f"B2 takes at most {MAX_STRUCT} struct states (model has "
             f"{s.region.shape[1]})")
    _require(lengths.shape == (G, B) and bstate.shape == (G, B)
             and oXH.device == lengths.device == bstate.device == dev,
             "lengths and bstate must be (G, B) on the planes' device")
    _check_stack(s, dev)
    lib = build()["viterbi_backward.cu"]
    origin32 = oMI.dtype == torch.int32
    mbit = MBIT32 if origin32 else MBIT16
    lengths32 = lengths.to(torch.int32).contiguous()
    bstate32 = bstate.to(torch.int32).contiguous()
    oMI, oXH = oMI.contiguous(), oXH.contiguous()
    path = None
    if return_path:
        path = torch.empty(G, B, L, dtype=torch.int32, device=dev)
    stats = torch.empty(G, B, 16, dtype=torch.int32, device=dev)
    if B == 0:
        return path, stats
    code = lib.advntr_viterbi_backward(
        _ptr(lengths32), _ptr(bstate32), _ptr(oMI), _ptr(oXH),
        _ptr(s.region), _ptr(s.unit), _ptr(path) if return_path else None,
        _ptr(stats), G, B, L, s.P, s.nb, s.region.shape[1], int(origin32),
        mbit, int(return_path), _stream(dev))
    _check(code, "viterbi_backward")
    LAUNCHES["backward"] += 1
    return path, stats
