"""A locus model on the device, the cache that makes it from host tables
(models/bank.py), and the choice of its decoder (``LocusModel.decode``,
``decode_group``): the dense fallback of an imported model the structured
extractor refuses, else the kernel ``ADVNTR_TPU_KERNEL`` names, ``pallas``
(B1 and B2 on the card, their plain twins on the CPU) or ``struct`` (the
reference's structured decoder in plain PyTorch, ops/viterbi_struct.py);
the checkpointed traceback past ``CKPT_TRACEBACK_L`` columns; the mesh
where a group splits over several devices."""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os

import numpy as np
import torch

from advntr_tpu_torch.engine import device_analytics as da
from advntr_tpu_torch.models import bank
from advntr_tpu_torch.models.compiler import (ModelArtifact, compile_graph,
                                             expand_path)
from advntr_tpu_torch.models.struct_compiler import (StructModel,
                                                     build_structured,
                                                     pad_structured)
from advntr_tpu_torch.ops.struct_model import TorchStructModel
from advntr_tpu_torch.ops.viterbi_struct import StructDeviceModel
from advntr_tpu_torch.parallel import mesh as pmesh
from advntr_tpu_torch.utils.profiler import count, span

# batches longer than this many columns take the checkpointed (recompute)
# traceback in segments of CKPT_SEGMENT columns: whole origin planes
# outgrow the device there (finder.py:94-97)
CKPT_TRACEBACK_L = 2048
CKPT_SEGMENT = 512

KERNELS = ("pallas", "struct")

# the padding buckets of a model's states, positions and units
STATE_BUCKET, POS_BUCKET, UNIT_BUCKET = 128, 128, 8


def _default_kernel() -> str:
    """The decoder of structured models (finder.py:100-112):
    ``ADVNTR_TPU_KERNEL``, ``pallas`` unless it says ``struct``.  Where
    the reference defaults to ``struct`` on the CPU, the port defaults to
    ``pallas`` on both devices: on the CPU that is B1/B2's plain twins."""
    kernel = os.environ.get("ADVNTR_TPU_KERNEL") or "pallas"
    if kernel not in KERNELS:
        raise ValueError(f"ADVNTR_TPU_KERNEL={kernel!r}: use one of "
                         f"{KERNELS}")
    return kernel


class HostStepError(Exception):
    """A locus's host work failed (its model build, the haplotyper): the
    analyzer prints that locus's Error row and goes on, as the reference
    does.  A device error is not one of these and propagates."""


@contextlib.contextmanager
def host_step():
    """Turn an error of the host work inside into a ``HostStepError``
    (an unported feature's NotImplementedError stays as it is)."""
    try:
        yield
    except NotImplementedError:
        raise
    except Exception as error:
        raise HostStepError(str(error)) from error


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _bucketed(size: int, bucket: int) -> int:
    """``size`` padded to ``bucket``; axes past 1024 pad to 512-multiples
    (finder.py:297-304)."""
    return _round_up(size, max(bucket, 512) if size > 1024 else bucket)


@dataclasses.dataclass
class LocusModel:
    """Everything a decode needs for one compiled locus model: the
    structured tables of the kernels or, for an imported model the
    structured extractor refuses, the dense fallback's.  Under the
    ``struct`` kernel the structured decoder's tables are built from
    ``sm`` at first use (``struct_model``).  The artifact's dense tables
    are filled from ``source`` the first time a mode reads them."""
    model: TorchStructModel | None     # padded device tables
    n_pad: int                     # state count padded to the bucket
    art: ModelArtifact | None = None   # unpadded host artifact (names)
    dense: da.DenseModel | None = None  # dense fallback, model is None
    kernel: str = "pallas"         # the decoder this model was built for
    sm: StructModel | None = None  # padded host StructModel
    struct: StructDeviceModel | None = None   # built by struct_model()
    source: bank.DenseSource | None = None  # where art's dense tables are

    def dense_art(self) -> ModelArtifact:
        """The artifact with its dense tables, filled once from
        ``source``."""
        if self.source is not None:
            self.art = self.source.fill(self.art)
            self.source = None
        return self.art

    def struct_model(self) -> StructDeviceModel | None:
        """The structured decoder's tables on the model's device, built at
        the first call and kept (finder.py:79-91): their dense (S, S)
        in-edge table reads the artifact's dense ``log_T``."""
        if self.struct is None and self.sm is not None:
            self.struct = StructDeviceModel.from_struct(
                self.sm, self.dense_art(), self.model.device)
        return self.struct

    def visited_states(self, path) -> list[str]:
        """A decoded artifact-space path as the full visited-state names
        (``expand_path``, through the dense ``hop_choice``), for the modes
        that read paths as text."""
        return expand_path(self.dense_art(), path)

    def shape_key(self) -> tuple | None:
        """Same-key loci share kernel shapes and score as one group (the
        keys of analyzer.py:496-506); a dense model has none and scores
        alone."""
        if self.dense is not None:
            return None
        if self.kernel == "struct":
            return ("struct", self.sm.P, self.sm.C,
                    self.model.struct_to_art.shape[0], self.n_pad)
        return self.model.shape_key() + (self.n_pad,)

    def decode(self, seqs, lengths, return_path: bool = False) -> dict:
        """A dict of (B,) tensors for a (B, L) batch, the paths (B, L)
        under "path" when ``return_path``.  Long lattices take the
        checkpointed traceback of the model's kernel (finder.py:772-781),
        where the reference takes its struct kernel's; a dense model the
        dense fallback, whatever the length (finder.py:793-796)."""
        kw = {"return_path": True} if return_path else {}
        if self.dense is not None:
            return da.read_stats_dense(self.dense, seqs, lengths, **kw)
        long = seqs.shape[1] > CKPT_TRACEBACK_L
        if long:
            kw["segment"] = CKPT_SEGMENT
        if self.kernel == "struct":
            read_stats = da.read_stats_struct_ckpt if long \
                else da.read_stats_struct
            return read_stats(self.struct_model(), self.model.art_meta, seqs,
                              lengths, self.sm.suffix_last, **kw)
        read_stats = da.read_stats_ckpt if long else da.read_stats
        return read_stats(self.model, seqs, lengths, **kw)


def decode_group(lms, seqs, lengths, mesh) -> dict:
    """G same-shape loci in one launch of each kernel (reference
    analyzer.py:592-624): ``lms[g]`` scores seqs[g] (B, L) with
    lengths[g], over ``mesh``'s devices where one is given; a dict of
    (G, B) tensors."""
    if lms[0].kernel == "struct":
        models = [lm.struct_model() for lm in lms]
        kw = {"kernel": "struct", "metas": [lm.model.art_meta for lm in lms],
              "suffix_lasts": [lm.sm.suffix_last for lm in lms]}
    else:
        models, kw = [lm.model for lm in lms], {}
    if mesh is not None:
        return pmesh.sharded_grouped_read_stats(mesh, models, seqs, lengths,
                                                **kw)
    if not kw:
        return da.read_stats_grouped(models, seqs, lengths)
    tables, _, score = pmesh.struct_shard(models, kw["metas"],
                                          kw["suffix_lasts"])
    return score(tables, seqs, lengths)


class LocusModelCache:
    """Per-(locus, read length) compiled model cache (finder.py:175-348).

    Pads the structured position/unit axes to buckets, so that same-bucket
    loci share kernel shapes and score as one group.  ``workers`` builds
    scheduled loci in a spawn process pool while earlier loci score;
    ``bank_dir`` persists and reuses the built payloads.  A build compiles
    the decode payload alone unless its models' dense tables will be
    read (``whole``)."""

    def __init__(self, device="cuda", workers: int = 0,
                 bank_dir: str | None = None):
        self.device = torch.device(device)
        self.bank_dir = bank_dir
        # set by a mode that reads every model's decoded paths as text
        # (``-fs``, ``-u``) before its first model
        self.reads_paths = False
        self._cache: dict = {}
        self._futures: dict = {}
        self._pool = None
        if workers:
            import concurrent.futures
            import multiprocessing
            # spawn: the workers are host-only builders and must not
            # inherit the parent's CUDA context
            self._pool = concurrent.futures.ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn"))

    def close(self) -> None:
        """Stop the worker pool, if any."""
        if self._pool is not None:
            self._pool.shutdown(cancel_futures=True)
            self._pool = None

    @staticmethod
    def _key(key):
        # the kernel choice is part of the key (finder.py:214-220): a
        # LocusModel carries its kernel's tables, and ADVNTR_TPU_KERNEL may
        # change between calls while the cache persists
        return (key[0].id, *key[1:], _default_kernel())

    def whole(self) -> bool:
        """Whether a build keeps the artifact's dense tables: for the
        ``struct`` decoder, whose tables read ``log_T``, and for a mode
        whose ``visited_states`` read ``hop_choice``.  Elsewhere a mode
        that reads them fills them from the ``DenseSource``."""
        return self.reads_paths or _default_kernel() == "struct"

    def schedule(self, key) -> None:
        """Queue background compilation of the model of ``key``."""
        k = self._key(key)
        if k in self._cache or k in self._futures or self._pool is None:
            return
        if self.bank_dir and os.path.exists(
                bank.bank_payload_path(self.bank_dir, *k[:4])):
            return  # bank hit; loaded lazily in get()
        self._futures[k] = self._pool.submit(bank.build_locus_payload, *key,
                                             self.whole())

    def get(self, key) -> LocusModel:
        """The model of ``key``, a ``bank.model_key``, on the cache's
        device, of its payload from the pool, the bank or a build here
        (``bank.read_or_build``).  An error of the host build (the
        compile, the bank, the padding) raises ``HostStepError``; one of
        the upload to the device propagates as it is."""
        k = self._key(key)
        if k in self._cache:
            count("model.hit")
            return self._cache[k]
        with span("advntr.model", vid=k[0]):
            with host_step():
                art, sm, source = bank.read_or_build(
                    self.bank_dir, *key, self._futures.pop(k, None),
                    self.whole())
            lm = self.build(art, sm)
            lm.source = source
            self._cache[k] = lm
        return lm

    def evict(self, key) -> None:
        """Drop the model of ``key`` from the in-RAM cache (the bank copy
        on disk stays); panel runs evict each finished wave."""
        self._cache.pop(self._key(key), None)

    def build(self, art=None, sm=None, graph=None,
              dense_fallback: bool = False) -> LocusModel:
        """A model, not cached, of a payload ``(art, sm)`` or of a
        ``graph`` (compiled here where ``art`` is not given,
        finder.py:290).  With
        ``dense_fallback`` (an imported graph, finder.py:502-508) a
        topology the structured extractor refuses gives the dense
        fallback over the artifact padded to the state bucket
        (finder.py:339-345).  The host build raises ``HostStepError``;
        the upload is outside."""
        with host_step():
            art = compile_graph(graph) if art is None else art
            n_pad = _bucketed(art.n_states, STATE_BUCKET)
            try:
                if sm is None:
                    sm = build_structured(graph, art)
                with span("advntr.model.pad"):
                    sm = pad_structured(
                        sm, art, _bucketed(sm.P + 1, POS_BUCKET),
                        _round_up(sm.C, UNIT_BUCKET if sm.C <= 24
                                  else max(UNIT_BUCKET, 32)))
            except Exception as error:
                if not dense_fallback:
                    raise
                logging.info("imported topology refused by the structured "
                             "extractor (%s): dense fallback", error)
                sm, dense = None, _pad_artifact(art, n_pad)
        if sm is None:
            return LocusModel(model=None, n_pad=n_pad, art=art,
                              dense=da.DenseModel.from_artifact(dense,
                                                                self.device))
        with span("advntr.model.upload"):
            return LocusModel(
                model=TorchStructModel.from_payload(art, sm, self.device),
                n_pad=n_pad, art=art, kernel=_default_kernel(), sm=sm)


def _pad_artifact(art, n_pad: int):
    """Pad an artifact to n_pad states with unreachable dummy states."""
    n = art.n_states
    if n_pad == n:
        return art
    pad = n_pad - n

    def pad2(x, fill):
        out = np.full((n_pad, n_pad), fill, dtype=x.dtype)
        out[:n, :n] = x
        return out

    def pad1(x, fill):
        out = np.full((n_pad,) + x.shape[1:], fill, dtype=x.dtype)
        out[:n] = x
        return out

    return dataclasses.replace(
        art,
        log_T=pad2(art.log_T, -np.inf),
        log_E=pad1(art.log_E, -np.inf),
        log_start=pad1(art.log_start, -np.inf),
        log_end=pad1(art.log_end, -np.inf),
        t_unit_starts=pad2(art.t_unit_starts, 0),
        t_unit_ends=pad2(art.t_unit_ends, 0),
        s_unit_starts=pad1(art.s_unit_starts, 0),
        s_unit_ends=pad1(art.s_unit_ends, 0),
        e_unit_starts=pad1(art.e_unit_starts, 0),
        e_unit_ends=pad1(art.e_unit_ends, 0),
        kind=pad1(art.kind, 3), region=pad1(art.region, 3),
        pos=pad1(art.pos, 0), unit=pad1(art.unit, -1),
        exp_base=pad1(art.exp_base, -1),
        names=art.names + [f"__pad_{i}" for i in range(pad)],
    )
