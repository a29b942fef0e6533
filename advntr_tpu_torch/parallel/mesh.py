"""Scale-out over several devices: a group's loci and reads split over a
grid of devices.

Counterpart of advntr_tpu/parallel/mesh.py (``make_mesh`` :31,
``stack_models`` :42, ``multi_locus_read_stats`` :69,
``sharded_grouped_read_stats`` :121, ``panel_mesh`` :162,
``data_parallel_read_stats`` :176).  The reference shards one jitted
executable over a ``(loci, reads)`` jax Mesh; here the mesh is a plain
grid of ``torch.device``s and each shard is one grouped launch of B1 and
B2 (under ``kernel="struct"``, one grouped run of the structured decoder)
on its own device:

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

from advntr_tpu_torch.engine import device_analytics as da
from advntr_tpu_torch.ops import viterbi_fused as vf
from advntr_tpu_torch.ops.struct_model import TorchStructModel
from advntr_tpu_torch.ops.viterbi_struct import StructDeviceModel


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


def struct_shard(models, metas, suffix_lasts):
    """The tables of a shard of struct loci and how they move and score."""
    tables = (StructDeviceModel.stack(models), da.stack_meta(metas),
              torch.tensor(suffix_lasts, device=models[0].device))

    def move(t, dev):
        return t[0].to(dev), tuple(x.to(dev) for x in t[1]), t[2].to(dev)

    def score(t, seqs, lengths):
        return da.read_stats_struct_grouped(t[0], t[1], seqs, lengths, t[2])
    return tables, move, score


def sharded_grouped_read_stats(mesh: PanelMesh, models, seqs, lengths,
                               kernel: str = "pallas", metas=None,
                               suffix_lasts=None) -> dict:
    """``read_stats_grouped`` (engine/device_analytics.py) for G loci x B
    reads split over ``mesh``: each shard stacks its loci's tables, copies
    them and its rows to its device, and launches B1 and B2 there once.
    All shards are queued before any result is read, so shards on
    different cards run at once.

    models: G same-shape ``TorchStructModel``s on one device; seqs
    (G, B, L) and lengths (G, B) on any device.  With ``kernel="struct"``
    the models are ``StructDeviceModel``s, each with its locus's
    (kind, region, exp_base, unit) in ``metas`` and its int in
    ``suffix_lasts``, and each shard runs ``read_stats_struct_grouped``.  B must divide by the
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
    if kernel not in ("pallas", "struct"):
        raise ValueError(f"unknown kernel {kernel!r}")
    parts = []
    for i, row in enumerate(mesh.devices):
        g0, g1 = int(bounds[i]), int(bounds[i + 1])
        if g0 == g1:
            continue
        if kernel == "struct":
            tables, move, score = struct_shard(
                models[g0:g1], metas[g0:g1], suffix_lasts[g0:g1])
        else:
            tables = TorchStructModel.stack(models[g0:g1])
            move, score = (lambda t, dev: t.to(dev)), vf.viterbi_stats_grouped
        copies, outs = {}, []
        for j, dev in enumerate(row):
            with _on(dev):
                if dev not in copies:
                    copies[dev] = move(tables, dev)
                outs.append(score(
                    copies[dev],
                    seqs[g0:g1, j * rows:(j + 1) * rows].to(dev),
                    lengths[g0:g1, j * rows:(j + 1) * rows].to(dev)))
        parts.append(outs)
    out_dev = seqs.device
    return {k: torch.cat([torch.cat([o[k].to(out_dev) for o in outs], dim=1)
                          for outs in parts])
            for k in parts[0][0]}


# ---- the dense model over a mesh (mesh.py:42-89, :176-189) ----------------

def stack_models(models) -> da.DenseModel:
    """G same-shape ``DenseModel``s as one whose tensors carry a leading
    locus axis (mesh.py:42-47)."""
    fields = [f.name for f in dataclasses.fields(da.DenseModel)]
    return da.DenseModel(**{f: torch.stack([getattr(m, f) for m in models])
                            for f in fields})


def _dense_to(model: da.DenseModel, device, index=slice(None)):
    """The tables of ``model[index]`` (all of a single model) on
    ``device``."""
    return da.DenseModel(**{f.name: getattr(model, f.name)[index].to(device)
                            for f in dataclasses.fields(da.DenseModel)})


def multi_locus_read_stats(mesh: PanelMesh, stacked: da.DenseModel, seqs,
                           lengths) -> dict:
    """``read_stats_dense`` for G loci x B reads split over ``mesh``
    (mesh.py:69-89): ``stacked`` from ``stack_models``, seqs (G, B, L),
    lengths (G, B); G must divide by the loci axis and B by the reads
    axis.  Each shard scores its loci's slice of rows on its own device.
    Returns the dict of (G, B) tensors on the device of ``seqs``."""
    G, B, _ = seqs.shape
    if G % mesh.n_loci or B % mesh.n_reads:
        raise ValueError(f"seqs {tuple(seqs.shape)} do not divide over a "
                         f"{mesh.n_loci} x {mesh.n_reads} mesh")
    per, rows = G // mesh.n_loci, B // mesh.n_reads
    parts = []
    for i, row in enumerate(mesh.devices):
        outs = []
        for j, dev in enumerate(row):
            b = slice(j * rows, (j + 1) * rows)
            with _on(dev):
                locus = [da.read_stats_dense(
                    _dense_to(stacked, dev, g), seqs[g, b].to(dev),
                    lengths[g, b].to(dev))
                    for g in range(i * per, (i + 1) * per)]
            outs.append({k: torch.stack([o[k] for o in locus])
                         for k in locus[0]})
        parts.append(outs)
    out_dev = seqs.device
    return {k: torch.cat([torch.cat([o[k].to(out_dev) for o in outs], dim=1)
                          for outs in parts])
            for k in parts[0][0]}


def data_parallel_read_stats(mesh: PanelMesh, model: da.DenseModel, seqs,
                             lengths) -> dict:
    """One locus's reads (B, L) split over every device of ``mesh``
    (mesh.py:176-189); B must divide by their number.  Returns the dict of
    (B,) tensors on the device of ``seqs``."""
    devices = [d for row in mesh.devices for d in row]
    B = seqs.shape[0]
    if B % len(devices):
        raise ValueError(f"batch {B} does not divide over {len(devices)} "
                         "devices")
    rows = B // len(devices)
    outs = []
    for j, dev in enumerate(devices):
        b = slice(j * rows, (j + 1) * rows)
        with _on(dev):
            outs.append(da.read_stats_dense(_dense_to(model, dev),
                                            seqs[b].to(dev),
                                            lengths[b].to(dev)))
    return {k: torch.cat([o[k].to(seqs.device) for o in outs])
            for k in outs[0]}
