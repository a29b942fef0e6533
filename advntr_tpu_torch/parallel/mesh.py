"""Scale-out over several devices: a group's loci and reads split over a
grid of devices.

Counterpart of advntr_tpu/parallel/mesh.py (``make_mesh`` :31,
``sharded_grouped_read_stats`` :121, ``panel_mesh`` :162).  The reference
shards one jitted executable over a ``(loci, reads)`` jax Mesh; here the
mesh is a plain grid of ``torch.device``s and each shard is one grouped
launch of B1 and B2 on its own device:

- ``loci``: each row of the grid scores a contiguous slice of the group's
  loci, with its own copy of those loci's stacked tables;
- ``reads``: each column scores a contiguous slice of every locus's rows.

Per-read results depend on no other read and no other locus, so every
statistic equals the unsharded launch's, bit for bit, and the only traffic
between devices is the tables' copy in and the (G, B) outputs' copy back.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from advntr_tpu_torch.ops import viterbi_fused as vf
from advntr_tpu_torch.ops.struct_model import TorchStructModel


@dataclasses.dataclass(frozen=True)
class PanelMesh:
    """A (n_loci, n_reads) grid of devices: ``devices[i][j]`` scores the
    i-th slice of a group's loci and the j-th slice of their reads."""
    devices: tuple

    @property
    def n_loci(self) -> int:
        return len(self.devices)

    @property
    def n_reads(self) -> int:
        return len(self.devices[0])


def visible_devices(device_type: str) -> list:
    """Every device of this type the process may use: each visible GPU
    (``CUDA_VISIBLE_DEVICES`` narrows them) for ``cuda``, none for the
    CPU, whose twins gain nothing from a split."""
    if device_type == "cuda" and torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return []


def _indexed(device) -> torch.device:
    """``cuda`` as the card it names, the current one, as tensors name
    their device: a shard's tables are copied only to another card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(n_loci: int = 1, n_reads: int | None = None,
              devices=None) -> PanelMesh:
    """An n_loci x n_reads grid of ``devices`` (every visible GPU by
    default), row by row."""
    devices = [_indexed(d) for d in (
        devices if devices is not None else visible_devices("cuda"))]
    n_total = len(devices)
    if n_reads is None:
        n_reads = n_total // n_loci
    if n_loci * n_reads != n_total or n_total == 0:
        raise ValueError(f"a {n_loci} x {n_reads} mesh must use all "
                         f"{n_total} devices")
    return PanelMesh(tuple(tuple(devices[i * n_reads:(i + 1) * n_reads])
                           for i in range(n_loci)))


def panel_mesh(group_size: int, batch: int, devices=None,
               device_type: str = "cuda") -> PanelMesh | None:
    """Factor the devices into a (loci, reads) mesh for the analyzer's
    grouped dispatch shapes, as the reference does, or None where one
    device (or none) is visible or the reads axis does not divide
    ``batch``."""
    devices = devices if devices is not None else \
        visible_devices(device_type)
    n = len(devices)
    if n <= 1:
        return None
    n_loci = math.gcd(group_size, n)
    n_reads = n // n_loci
    if n_loci * n_reads != n or batch % n_reads != 0:
        return None
    return make_mesh(n_loci=n_loci, n_reads=n_reads, devices=devices)


def _on(device: torch.device):
    """The device a CUDA launch goes to: the wrappers take the stream of
    their inputs' device, but the kernels' attributes and launches act on
    the process's current device, so each shard runs with its own device
    current."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def sharded_grouped_read_stats(mesh: PanelMesh, models, seqs,
                               lengths) -> dict:
    """``read_stats_grouped`` (engine/device_analytics.py) for G loci x B
    reads split over ``mesh``: each shard stacks its loci's tables, copies
    them and its rows to its device, and launches B1 and B2 there once.
    All shards are queued before any result is read, so shards on
    different cards run at once.

    models: G same-shape ``TorchStructModel``s on one device; seqs
    (G, B, L) and lengths (G, B) on any device.  B must divide by the
    ``reads`` axis; G need not divide by the ``loci`` axis (a short chunk
    splits into uneven contiguous slices, as ``torch.tensor_split`` splits
    it, and a slice with no locus launches nothing).  Returns the dict of
    (G, B) tensors on the device of ``seqs``, equal to the unsharded
    launch's.  A launch that fails on any device raises."""
    G, B, _ = seqs.shape
    if len(models) != G or lengths.shape != (G, B):
        raise ValueError(f"{len(models)} models for seqs "
                         f"{tuple(seqs.shape)} and lengths "
                         f"{tuple(lengths.shape)}")
    if B % mesh.n_reads:
        raise ValueError(f"batch {B} does not divide over {mesh.n_reads} "
                         "read shards")
    rows = B // mesh.n_reads
    bounds = np.cumsum([0] + [len(part) for part in
                              np.array_split(np.arange(G), mesh.n_loci)])
    parts = []
    for i, row in enumerate(mesh.devices):
        g0, g1 = int(bounds[i]), int(bounds[i + 1])
        if g0 == g1:
            continue
        stack = TorchStructModel.stack(models[g0:g1])
        copies, outs = {}, []
        for j, dev in enumerate(row):
            with _on(dev):
                if dev not in copies:
                    copies[dev] = stack.to(dev)
                outs.append(vf.viterbi_stats_grouped(
                    copies[dev],
                    seqs[g0:g1, j * rows:(j + 1) * rows].to(dev),
                    lengths[g0:g1, j * rows:(j + 1) * rows].to(dev)))
        parts.append(outs)
    out_dev = seqs.device
    return {k: torch.cat([torch.cat([o[k].to(out_dev) for o in outs], dim=1)
                          for outs in parts])
            for k in parts[0][0]}
