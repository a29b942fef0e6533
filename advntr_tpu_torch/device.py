"""Explicit device selection: nothing in the package moves to the CPU on
its own.  ``cuda`` (the default) raises when no GPU is visible; the CPU
path runs the kernels' plain PyTorch twins and only when asked for."""

from __future__ import annotations

import contextlib

import torch

DEVICES = ("cuda", "cpu")


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(name)
    if dev.type not in DEVICES:
        raise ValueError(f"unsupported device {name!r}; use one of {DEVICES}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but torch sees no CUDA "
                           "device; pass --device cpu to run the plain "
                           "PyTorch path")
    return dev


@contextlib.contextmanager
def full_float32_matmul():
    """Float32 products in full float32 inside the block, whatever the
    process-wide TF32 switch says; the switch is put back on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
