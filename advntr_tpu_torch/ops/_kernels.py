"""Build, load and launch the hand-written CUDA kernels.

``csrc/*.cu`` are compiled with nvcc for sm_90a into one shared library
with a plain C interface, at first use, into ``advntr_tpu_torch/build/``.
The file name carries a hash of the sources and flags, so an edited source
is rebuilt.  The library is loaded with ctypes; every pointer and the
stream are passed as ``c_void_p``.  Each C entry point returns
``cudaGetLastError()`` after its launch, and a non-zero code raises here:
a launch refused for its thread count or shared memory never runs, and a
later synchronize would not report it.

``LAUNCHES`` counts the launches of each kernel, so a run can show that it
went through the kernels.
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
              "-O3", "-shared", "-Xcompiler", "-fPIC")
MAX_THREADS = 1024          # B1 runs one thread per match position

LAUNCHES = {"forward": 0, "backward": 0}
BUILD_SECONDS: float | None = None
_lib = None

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


def library_path() -> Path:
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libadvntr_kernels_{digest.hexdigest()[:16]}.so"


def build() -> ctypes.CDLL:
    """Compile (if the hashed library is missing) and load the kernels."""
    global _lib, BUILD_SECONDS
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(CSRC / name) for name in SOURCES)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc failed (%d):\n%s\n%s" % (
                res.returncode, " ".join(cmd), res.stderr[-4000:]))
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.advntr_viterbi_forward.argtypes = [_VP] * 16 + [_I] * 10 + \
        [_F, _F, _VP]
    lib.advntr_viterbi_forward.restype = _I
    lib.advntr_viterbi_backward.argtypes = [_VP] * 8 + [_I] * 7 + [_VP]
    lib.advntr_viterbi_backward.restype = _I
    lib.advntr_error_string.argtypes = [_I]
    lib.advntr_error_string.restype = ctypes.c_char_p
    BUILD_SECONDS = time.perf_counter() - t0
    _lib = lib
    return lib


def _check(lib, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError("%s launch failed: CUDA error %d (%s)" % (
            what, code, lib.advntr_error_string(code).decode()))


def _ptr(x: torch.Tensor) -> int:
    return x.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_model(m, device) -> None:
    """The kernels read the model tables by raw pointer: they must be
    contiguous, on the inputs' device, with the shapes the model states."""
    tables = (m.pos, m.blk, m.eM, m.eI, m.eI0, m.Wd, m.Wu, m.blk_idx,
              m.exp_base, m.unit_last, m.region, m.unit)
    _require(all(t.device == device and t.is_contiguous() for t in tables),
             "model tables must be contiguous and on the inputs' device")
    _require(m.pos.shape[1] == m.P and m.blk.shape[1] == m.nb
             and m.Wd.shape[1] == m.P and m.Wu.shape[1] == m.C
             and m.region.shape[0] == 2 * m.P + m.nb,
             "model tables disagree with (P, nb, C)")


def forward(m, seqs, lengths, origin32: bool = False):
    """Launch B1 (csrc/viterbi_forward.cu) on CUDA tensors."""
    P, nb, C = m.P, m.nb, m.C
    if max(P, nb) > MAX_THREADS:
        raise ValueError(
            f"B1 takes at most {MAX_THREADS} match positions (model has "
            f"P={P}); long-read models are ROADMAP item A9")
    B, L = seqs.shape
    dev = seqs.device
    _require(lengths.shape == (B,) and lengths.device == dev,
             "lengths must be (B,) on the device of seqs")
    _check_model(m, dev)
    lib = build()
    odt, mbit = origin_params(P, nb, origin32)
    seqs8 = seqs.to(torch.int8).contiguous()
    lengths32 = lengths.to(torch.int32).contiguous()
    oMI = torch.empty(L, B, 2 * P, dtype=odt, device=dev)
    oXH = torch.empty(L, B, 2 * nb, dtype=odt, device=dev)
    best = torch.empty(B, dtype=torch.float32, device=dev)
    bstate = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0 or L == 0:
        return best, bstate, oMI, oXH
    code = lib.advntr_viterbi_forward(
        _ptr(seqs8), _ptr(lengths32), _ptr(m.pos), _ptr(m.blk), _ptr(m.eM),
        _ptr(m.eI), _ptr(m.eI0), _ptr(m.Wd), _ptr(m.Wu), _ptr(m.blk_idx),
        _ptr(m.exp_base), _ptr(m.unit_last), _ptr(oMI), _ptr(oXH),
        _ptr(best), _ptr(bstate),
        B, L, P, nb, C, m.Wd.shape[0], m.Wu.shape[0], m.suffix_last,
        int(odt == torch.int32), mbit, m.r_unit, LN05, _stream(dev))
    _check(lib, code, "viterbi_forward")
    LAUNCHES["forward"] += 1
    return best, bstate, oMI, oXH


def backward(m, lengths, bstate, oMI, oXH):
    """Launch B2 (csrc/viterbi_backward.cu) on CUDA tensors."""
    L, B, P2 = oMI.shape
    nb = oXH.shape[2] // 2
    dev = oMI.device
    _require(P2 == 2 * m.P and oXH.shape == (L, B, 2 * m.nb),
             f"origin planes {tuple(oMI.shape)}, {tuple(oXH.shape)} do not "
             f"fit a model with P={m.P}, nb={m.nb}")
    _require(oMI.dtype == oXH.dtype
             and oMI.dtype in (torch.int16, torch.int32),
             "origin planes must both be int16 or both int32")
    _require(lengths.shape == (B,) and bstate.shape == (B,)
             and oXH.device == lengths.device == bstate.device == dev,
             "lengths and bstate must be (B,) on the planes' device")
    _check_model(m, dev)
    lib = build()
    origin32 = oMI.dtype == torch.int32
    mbit = MBIT32 if origin32 else MBIT16
    lengths32 = lengths.to(torch.int32).contiguous()
    bstate32 = bstate.to(torch.int32).contiguous()
    oMI, oXH = oMI.contiguous(), oXH.contiguous()
    path = torch.empty(B, L, dtype=torch.int32, device=dev)
    stats = torch.empty(B, 16, dtype=torch.int32, device=dev)
    if B == 0 or L == 0:
        return path, stats
    code = lib.advntr_viterbi_backward(
        _ptr(lengths32), _ptr(bstate32), _ptr(oMI), _ptr(oXH),
        _ptr(m.region), _ptr(m.unit), _ptr(path), _ptr(stats),
        B, L, P2 // 2, nb, m.region.shape[0], int(origin32), mbit,
        _stream(dev))
    _check(lib, code, "viterbi_backward")
    LAUNCHES["backward"] += 1
    return path, stats
