"""ctypes bridges to the port's native host code.

Counterpart of advntr_tpu/native_bridge.py.  Each source is compiled with
g++ on first use into ``advntr_tpu_torch/build/``; the first two are the
port's own copies of the reference's sources, the third is the port's
alone:

- ``load_closure``: ``csrc/model_closure.cc``, the three max-plus closure
  loops of ``models/compiler.compile_graph`` and the decode payload's part
  of them, ``models/decode_compiler.compile_decode`` (each compiler falls
  back to its numpy loops when no toolchain is found);
- ``SparseViterbiModel``: ``csrc/viterbi_sparse.cc``, the sparse Viterbi
  over the full silent-state graph in float64 on one CPU core, the
  baseline the reference's kernels are timed against (bench.py);
- ``load_bam_scan``: ``csrc/bam_scan.cc``, the record walk of
  ``io/bam_scan.py`` (recruitment's unmapped pass over a BAM).

All three are host C++, not device kernels.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_CLOSURE_SRC = os.path.join(_PKG, "csrc", "model_closure.cc")
_BUILD_DIR = os.path.join(_PKG, "build")
_CLOSURE_SO = os.path.join(_BUILD_DIR, "libmodel_closure.so")
_SRC = os.path.join(_PKG, "csrc", "viterbi_sparse.cc")
_SO = os.path.join(_BUILD_DIR, "libviterbi_sparse.so")
_SCAN_SRC = os.path.join(_PKG, "csrc", "bam_scan.cc")
_SCAN_SO = os.path.join(_BUILD_DIR, "libbam_scan.so")

_closure_lib = None
_lib = None
_scan_lib = None


def _build(src: str, so: str) -> None:
    """g++ ``src`` into ``so`` where it is missing or older than its
    source; written under a temporary name and renamed."""
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = "%s.tmp%d" % (so, os.getpid())
    subprocess.check_call(["g++", "-O3", "-march=native", "-shared",
                           "-fPIC", src, "-o", tmp])
    os.replace(tmp, so)


def load_closure():
    """Load (building on first use) the native silent-closure loops used
    by models/compiler.compile_graph and
    models/decode_compiler.compile_decode.  Raises on toolchain failure;
    the caller falls back to the numpy loops."""
    global _closure_lib
    if _closure_lib is not None:
        return _closure_lib
    _build(_CLOSURE_SRC, _CLOSURE_SO)
    lib = ctypes.CDLL(_CLOSURE_SO)
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i16 = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    i8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.model_closure.restype = None
    lib.model_closure.argtypes = [
        ctypes.c_int32, ctypes.c_int32,
        i32, i32, f64,          # ss_count, ss_src, ss_w
        i8, i8,                 # is_us, is_ue
        f64,                    # W_se
        f64, i32, i16, i16,     # C, parent, cross_us, cross_ue
        f64, i32, i16, i16,     # C0, p0, c0_us, c0_ue
        f64, i32, i16, i16,     # log_T, hop_choice, t_us, t_ue
        f64, i32, i16, i16,     # log_start, start_choice, s_us, s_ue
    ]
    lib.model_decode_closure.restype = None
    lib.model_decode_closure.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32, i32, f64,          # es_count, es_dst, es_w
        i32, i32, f64,          # ss_count, ss_src, ss_w
        i32, i32, f64,          # se_count, se_dst, se_w
        i8, i8,                 # is_us, is_ue
        f64, i16, i16,          # log_end, e_us, e_ue
        f64, i32, i16, i16,     # C0, p0, c0_us, c0_ue
        f64, i32, i16, i16,     # log_start, start_choice, s_us, s_ue
    ]
    _closure_lib = lib
    return lib


def load_bam_scan():
    """Load (building on first use) the BAM record walk of
    ``io/bam_scan.py``.  Raises on toolchain failure; the caller then
    parses the records one at a time."""
    global _scan_lib
    if _scan_lib is not None:
        return _scan_lib
    _build(_SCAN_SRC, _SCAN_SO)
    lib = ctypes.CDLL(_SCAN_SO)
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.bam_scan_chunk.restype = ctypes.c_int
    lib.bam_scan_chunk.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,    # buf, n
        u8, i64,                            # names, name_off
        u8, i64,                            # packed, seq_off
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),  # lengths
        i64,                                # out
    ]
    _scan_lib = lib
    return lib


def _load():
    global _lib
    if _lib is not None:
        return _lib
    _build(_SRC, _SO)
    lib = ctypes.CDLL(_SO)
    lib.viterbi_sparse.restype = ctypes.c_int
    lib.viterbi_sparse.argtypes = [
        ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.float64),
        np.ctypeslib.ndpointer(np.float64),
        ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
        np.ctypeslib.ndpointer(np.int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return lib


class SparseViterbiModel:
    """CSR form of a full HmmGraph for the native engine."""

    def __init__(self, graph):
        from advntr_tpu_torch.models.compiler import _topo_sort_silent
        g = graph
        emitting = [i for i, s in enumerate(g.states)
                    if not s.is_silent and i not in (g.start, g.end)]
        silent_topo = _topo_sort_silent(
            g, [i for i, s in enumerate(g.states)
                if s.is_silent or i in (g.start, g.end)])
        order = emitting + silent_topo
        o_of = {s: k for k, s in enumerate(order)}
        self.names = [g.states[s].name for s in order]
        self.m = len(order)
        self.silent_start = len(emitting)
        self.start_index = o_of[g.start]
        self.end_index = o_of[g.end]

        in_edges: list[list[tuple[int, float]]] = [[] for _ in range(self.m)]
        with np.errstate(divide="ignore"):
            for (a, b), p in g.edges.items():
                in_edges[o_of[b]].append(
                    (o_of[a], np.log(p) if p > 0 else -np.inf))
        counts = np.zeros(self.m + 1, dtype=np.int32)
        trans, logw = [], []
        for l in range(self.m):
            counts[l + 1] = counts[l] + len(in_edges[l])
            for (src, w) in in_edges[l]:
                trans.append(src)
                logw.append(w)
        self.in_edge_count = counts
        self.in_transitions = np.array(trans, dtype=np.int32)
        self.in_logw = np.array(logw, dtype=np.float64)

        log_e = np.full((self.silent_start, 4), -np.inf)
        for k in range(self.silent_start):
            st = g.states[order[k]]
            for bi, b in enumerate("ACGT"):
                p = st.emission.get(b, 0.0)
                log_e[k, bi] = np.log(p) if p > 0 else -np.inf
        self.log_e = np.ascontiguousarray(log_e)

    def viterbi(self, codes: np.ndarray):
        lib = _load()
        n = len(codes)
        logp = ctypes.c_double()
        path = np.zeros(n + self.m + 2, dtype=np.int32)
        path_len = ctypes.c_int32()
        rc = lib.viterbi_sparse(
            self.m, self.silent_start, self.in_edge_count,
            self.in_transitions, self.in_logw, self.log_e,
            self.start_index, self.end_index,
            np.ascontiguousarray(codes, dtype=np.int8), n,
            ctypes.byref(logp), path, ctypes.byref(path_len))
        if rc != 0:
            return float("-inf"), None
        names = [self.names[i] for i in path[: path_len.value]]
        return logp.value, names
