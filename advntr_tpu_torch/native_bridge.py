"""ctypes bridge to the native silent-closure loops of the model compiler.

Counterpart of ``load_closure`` in advntr_tpu/native_bridge.py: compiles
``csrc/model_closure.cc`` with g++ on first use into
``advntr_tpu_torch/build/``.  It is host C++ (the three max-plus closure
loops of ``models/compiler.compile_graph``), not a device kernel; the
compiler falls back to its numpy loops when no toolchain is found.
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

_closure_lib = None


def load_closure():
    """Load (building on first use) the native silent-closure loops used
    by models/compiler.compile_graph.  Raises on toolchain failure; the
    caller falls back to the numpy loops."""
    global _closure_lib
    if _closure_lib is not None:
        return _closure_lib
    if (not os.path.exists(_CLOSURE_SO)
            or os.path.getmtime(_CLOSURE_SO)
            < os.path.getmtime(_CLOSURE_SRC)):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = "%s.tmp%d" % (_CLOSURE_SO, os.getpid())
        subprocess.check_call(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             _CLOSURE_SRC, "-o", tmp])
        os.replace(tmp, _CLOSURE_SO)
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
    _closure_lib = lib
    return lib
