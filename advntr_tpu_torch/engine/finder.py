"""Per-locus VNTR genotyping engine, Illumina and long reads.

Counterpart of advntr_tpu/engine/finder.py's genotype paths: all
candidate reads of a locus (mapped, plus both orientations of unmapped)
are encoded, padded and scored in one fused Viterbi + analytics call on
the device; the host applies the scalar gates and the genotype model
(engine/genotype.py).  Long reads (PacBio) are first cut to the window
between their two flank anchors (ops/align.py) and then decoded against a
model as wide as the longest window, through the checkpointed traceback
where the window is longer than ``CKPT_TRACEBACK_L`` columns.

Model "weights" are the numpy ``(art, sm)`` payload of
``build_locus_payload``.  A bank file ``model_bank/*.pkl.gz`` holds its
decode payload: the artifact without its O(n^2) tables (``DENSE_FIELDS``),
which only the ``struct`` decoder and the path expansion of ``-fs`` and
``-u`` read; those load on demand (``DenseSource``) from a companion file
``*.dense.pkl.gz`` or a rebuild of the locus.  Payloads are pickled with
this package's classes; ``load_reference_payload`` also reads a bank file
that the reference package wrote, full or slim, without importing that
package.  With
``Config.trained_hmms_dir`` set, a locus's model comes from its
pomegranate-JSON checkpoint ``<vid>_<read length>.json`` where one exists:
structured when the extractor takes its topology, else the dense fallback
(``device_analytics.read_stats_dense``).  ``ADVNTR_TPU_KERNEL`` chooses the
decoder of structured models: ``pallas`` (the default), B1 and B2 on the
card or their plain twins on the CPU; or ``struct``, the reference's
structured decoder in plain PyTorch (ops/viterbi_struct.py) on either
device.  A per-locus DNN model
``<dnn_models_dir>/<vid>.npz`` pre-screens the orientations of unmapped
reads before they are scored (engine/deep_recruitment.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gzip
import importlib
import logging
import os
import pickle

import numpy as np
import torch

from advntr_tpu_torch import dna
from advntr_tpu_torch.config import Config, DEFAULT_CONFIG
from advntr_tpu_torch.engine.genotype import find_genotype, identify_frameshift
from advntr_tpu_torch.engine import deep_recruitment as dr
from advntr_tpu_torch.engine.haplotyper import PacBioHaplotyper
from advntr_tpu_torch.io.bam import get_reference_genome_style
from advntr_tpu_torch.models.compiler import (ModelArtifact, compile_graph,
                                             expand_path)
from advntr_tpu_torch.models.graph import build_read_matcher
from advntr_tpu_torch.models.hmm_json import load_trained_hmm
from advntr_tpu_torch.models.profile import profile_for_repeats
from advntr_tpu_torch.models.struct_compiler import (StructModel,
                                                     build_structured,
                                                     pad_structured)
from advntr_tpu_torch.utils.profiler import count, span
from advntr_tpu_torch.engine import device_analytics as da
from advntr_tpu_torch.ops.align import anchor_probes_batch, local_align
from advntr_tpu_torch.ops.struct_model import TorchStructModel
from advntr_tpu_torch.ops.viterbi_struct import StructDeviceModel

# batches longer than this many columns take the checkpointed (recompute)
# traceback in segments of CKPT_SEGMENT columns: whole origin planes
# outgrow the device there (finder.py:94-97)
CKPT_TRACEBACK_L = 2048
CKPT_SEGMENT = 512

KERNELS = ("pallas", "struct")


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

# The artifact's O(n^2) tables: a bank payload leaves them out, since the
# default decode reads only the O(n) fields (finder.py:115-125)
DENSE_FIELDS = ("log_T", "t_unit_starts", "t_unit_ends", "hop_choice",
                "closure_parent")


def has_dense_tables(art) -> bool:
    """Whether the artifact carries its dense tables (a decode payload's
    artifact does not)."""
    return all(getattr(art, f) is not None for f in DENSE_FIELDS)


@dataclasses.dataclass
class GenotypeResult:
    copy_numbers: tuple | None
    recruited_reads_count: int
    spanning_reads_count: int
    flanking_reads_count: int
    maximum_likelihood: float


class FrameshiftCall(str):
    """Frameshift candidate state name (a plain str, printed and compared
    as the reference's) carrying the posterior indel report as attributes:
    ``lr_support`` (the Viterbi-path indel count that fed the binomial LR)
    and ``posterior`` (the frameshift_posterior dict or None)."""
    lr_support: int = 0
    posterior: dict | None = None


@dataclasses.dataclass
class ScoredRead:
    sequence: str
    logp: float
    repeats: int
    repeat_bp: int
    left_flank_bp: int
    right_flank_bp: int
    flank_rate: float
    n_matches: int
    is_mapped: bool
    query_name: str | None = None
    row: int = -1  # batch row of the winning orientation


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


@dataclasses.dataclass
class LocusModel:
    """Everything score_reads needs for one compiled locus model: the
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
    source: DenseSource | None = None  # where art's dense tables come from

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

    def shape_key(self) -> tuple:
        """Same-key loci share kernel shapes and score as one group (the
        keys of analyzer.py:496-506); a dense model scores alone."""
        if self.kernel == "struct":
            return ("struct", self.sm.P, self.sm.C,
                    self.model.struct_to_art.shape[0], self.n_pad)
        return self.model.shape_key() + (self.n_pad,)


@span("advntr.model.build")
def build_locus_payload(ref_vntr, copies: int, flank_size: int,
                        error_rate: float):
    """Host-side model construction for one locus (finder.py:128-143):
    profile estimation, graph build, silent-state elimination, structured
    extraction.  Pure numpy output, so it can run in worker processes; the
    artifact is whole (``decode_payload`` is what a bank file holds)."""
    left = ref_vntr.left_flanking_region[-flank_size:]
    right = ref_vntr.right_flanking_region[:flank_size]
    with span("advntr.model.build.profile"):
        trans, emis = profile_for_repeats(
            list(ref_vntr.get_repeat_segments()), error_rate)
    with span("advntr.model.build.graph"):
        g = build_read_matcher(left, right, trans, emis, copies, error_rate)
    with span("advntr.model.build.compile"):
        art = compile_graph(g)
    with span("advntr.model.build.struct"):
        sm = build_structured(g, art)
    return art, sm


def decode_payload(art, sm):
    """The payload a bank file holds: the artifact without its dense
    tables, and the structured model."""
    return dataclasses.replace(art, **{f: None for f in DENSE_FIELDS}), sm


def dense_tables(art) -> dict:
    """The artifact's dense tables, as a companion file holds them."""
    return {f: getattr(art, f) for f in DENSE_FIELDS}


def bank_payload_path(bank_dir: str, vid, copies: int, flank_size: int,
                      error_rate: float) -> str:
    """The reference's per-locus bank file name (finder.py:146-155), so
    a bank directory the reference wrote is found and read."""
    return os.path.join(bank_dir, "model_%s_%s_%s_%s.pkl.gz"
                        % (vid, copies, flank_size, error_rate))


def dense_payload_path(path: str) -> str:
    """The companion of a bank file, which holds its dense tables."""
    return path[:-len(".pkl.gz")] + ".dense.pkl.gz"


def write_payload(path: str, obj) -> int:
    """Pickle ``obj`` into ``path`` gzipped and publish it atomically (tmp
    file, then ``os.replace``), so that concurrent builders and readers
    never see a torn pickle; the compressed bytes written."""
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with gzip.open(tmp, "wb", compresslevel=1) as fh:
        pickle.dump(obj, fh)
    size = os.path.getsize(tmp)
    os.replace(tmp, path)
    return size


def build_and_save_payload(ref_vntr, copies: int, flank_size: int,
                           error_rate: float, path: str) -> str:
    """Build one locus payload and bank it, the dense tables' companion
    first, so that a bank file found means its companion is there too:
    the worker of ``buildbank`` (finder.py:158-172)."""
    if os.path.exists(path):
        return path
    art, sm = build_locus_payload(ref_vntr, copies, flank_size, error_rate)
    write_payload(dense_payload_path(path), dense_tables(art))
    write_payload(path, decode_payload(art, sm))
    return path


_REFERENCE_MODELS = "advntr_tpu.models."
_OWN_MODELS = "advntr_tpu_torch.models."


class _BankUnpickler(pickle.Unpickler):
    """Reads bank payloads of either package with this package's classes:
    ``advntr_tpu.models.*`` resolves to ``advntr_tpu_torch.models.*``, any
    other ``advntr_tpu`` name is refused, and the reference package is
    never imported."""

    def find_class(self, module, name):
        if module.startswith(_REFERENCE_MODELS):
            module = _OWN_MODELS + module[len(_REFERENCE_MODELS):]
            return getattr(importlib.import_module(module), name)
        if module == "advntr_tpu" or module.startswith("advntr_tpu."):
            raise pickle.UnpicklingError(
                "bank payload names %s.%s; only advntr_tpu.models.* classes "
                "are read from a reference-built bank" % (module, name))
        return super().find_class(module, name)


def load_reference_payload(path: str):
    """The (art, sm) payload of one bank file, written by this package or
    by the reference's ``buildbank``, as this package's dataclasses; also
    reads a companion's dense tables."""
    with gzip.open(path, "rb") as fh:
        return _BankUnpickler(fh).load()


@dataclasses.dataclass
class DenseSource:
    """Where a locus model's dense tables come from when a mode reads them
    (``LocusModel.dense_art``): the bank's companion file, else a rebuild
    of the locus.  A companion missing from the bank is written then."""
    ref_vntr: object
    key: tuple                 # (copies, flank_size, error_rate)
    path: str | None           # the companion, where the cache has a bank

    def fill(self, art) -> ModelArtifact:
        """``art`` with its dense tables."""
        with span("advntr.model.dense"):
            if not has_dense_tables(art):
                if self.path is not None and os.path.exists(self.path):
                    tables = load_reference_payload(self.path)
                    count("model.dense_read")
                    return dataclasses.replace(art, **tables)
                full, _ = build_locus_payload(self.ref_vntr, *self.key)
                count("model.dense_rebuild")
                art = dataclasses.replace(art, **dense_tables(full))
            if self.path is not None and not os.path.exists(self.path):
                try:
                    write_payload(self.path, dense_tables(art))
                    count("model.dense_write")
                except OSError as error:   # a bank the call cannot write
                    logging.warning("dense tables not banked: %s", error)
        return art


def payload_from_arrays(art_fields: dict, sm_fields: dict):
    """This package's (ModelArtifact, StructModel) from the fields of the
    reference's, given as plain dicts of numpy arrays and scalars
    (``dataclasses.asdict`` of each, or ``vars``)."""
    return ModelArtifact(**art_fields), StructModel(**sm_fields)


class LocusModelCache:
    """Per-(locus, read length) compiled model cache (finder.py:175-348).

    Pads the structured position/unit axes to buckets, so that same-bucket
    loci share kernel shapes and score as one group.  ``workers`` builds
    scheduled loci in a spawn process pool while earlier loci score;
    ``bank_dir`` persists and reuses the built payloads."""

    def __init__(self, device="cuda", state_bucket: int = 128,
                 pos_bucket: int = 128, unit_bucket: int = 8,
                 workers: int = 0, bank_dir: str | None = None):
        self.device = torch.device(device)
        self.state_bucket = state_bucket
        self.pos_bucket = pos_bucket
        self.unit_bucket = unit_bucket
        self.bank_dir = bank_dir
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
    def _key(ref_vntr, copies, flank_size, error_rate):
        # the kernel choice is part of the key (finder.py:214-220): a
        # LocusModel carries its kernel's tables, and ADVNTR_TPU_KERNEL may
        # change between calls while the cache persists
        return (ref_vntr.id, copies, flank_size, error_rate,
                _default_kernel())

    def _bank_path(self, key):
        if not self.bank_dir:
            return None
        # payloads do not depend on the kernel
        return bank_payload_path(self.bank_dir, *key[:4])

    def schedule(self, ref_vntr, copies: int, flank_size: int,
                 error_rate: float) -> None:
        """Queue background compilation of a locus model."""
        key = self._key(ref_vntr, copies, flank_size, error_rate)
        if key in self._cache or key in self._futures or self._pool is None:
            return
        path = self._bank_path(key)
        if path is not None and os.path.exists(path):
            return  # bank hit; loaded lazily in get()
        self._futures[key] = self._pool.submit(
            build_locus_payload, ref_vntr, copies, flank_size, error_rate)

    def get(self, ref_vntr, copies: int, flank_size: int,
            error_rate: float) -> LocusModel:
        """The locus's model on the cache's device.  An error of the host
        build (the compile, the bank, the padding) raises
        ``HostStepError``; one of the upload to the device propagates as
        it is."""
        key = self._key(ref_vntr, copies, flank_size, error_rate)
        if key in self._cache:
            count("model.hit")
            return self._cache[key]
        with span("advntr.model", vid=ref_vntr.id):
            with host_step():
                payload, built = self._payload(key, ref_vntr)
                padded = self._pad(*payload)
            lm = self._upload(*padded)
            path = self._bank_path(key)
            # a full payload read from the bank carries its dense tables;
            # a built one's companion is written when a mode reads them
            if not has_dense_tables(payload[0]) or (built and path):
                lm.source = DenseSource(
                    ref_vntr, key[1:4],
                    dense_payload_path(path) if path else None)
            self._cache[key] = lm
        return lm

    def _payload(self, key, ref_vntr):
        """(the locus's (art, sm), whether it was built): from the pool,
        the bank or a build here.  A build keeps its whole artifact and
        banks its decode payload.  A build here counts its artifact's
        states (``model.build_states``) and the bytes of its dense tables
        (``model.build_dense_bytes``), which the cache holds until the
        wave's ``evict``; a pool's build adds to neither, since its
        ``advntr.model.build`` span stays in the worker's process."""
        path = self._bank_path(key)
        payload = None
        built = False
        fut = self._futures.pop(key, None)
        if fut is not None:
            with span("advntr.model.pool_wait"):
                payload, built = fut.result(), True
            count("model.pool_hit")
        if payload is None and path is not None and os.path.exists(path):
            with span("advntr.model.bank_read"):
                payload = load_reference_payload(path)
            count("model.bank_hit")
            count("model.bank_bytes_read", os.path.getsize(path))
        if payload is None:
            payload, built = build_locus_payload(ref_vntr, *key[1:4]), True
            count("model.built")
            count("model.build_states", len(payload[0].names))
            count("model.build_dense_bytes", sum(
                t.nbytes for t in dense_tables(payload[0]).values()))
        if built and path is not None and not os.path.exists(path):
            with span("advntr.model.bank_write"):
                os.makedirs(self.bank_dir, exist_ok=True)
                n = write_payload(path, decode_payload(*payload))
            count("model.bank_bytes_written", n)
        return payload, built

    def evict(self, ref_vntr, copies: int, flank_size: int,
              error_rate: float) -> None:
        """Drop a locus's model from the in-RAM cache (the bank copy on
        disk stays); panel runs evict each finished wave."""
        self._cache.pop(self._key(ref_vntr, copies, flank_size, error_rate),
                        None)

    @staticmethod
    def _coarse_bucket(size: int, bucket: int) -> int:
        """Axes past 1024 pad to 512-multiples (finder.py:297-304)."""
        return max(bucket, 512) if size > 1024 else bucket

    def _state_pad(self, art) -> int:
        """The artifact's state count padded to its bucket."""
        return _round_up(art.n_states,
                         self._coarse_bucket(art.n_states,
                                             self.state_bucket))

    @span("advntr.model.pad")
    def _pad(self, art, sm):
        """(art, sm padded to the buckets, the padded state count)."""
        n_pad = self._state_pad(art)
        P_pad = _round_up(sm.P + 1,
                          self._coarse_bucket(sm.P + 1, self.pos_bucket))
        C_pad = _round_up(sm.C, self.unit_bucket if sm.C <= 24
                          else max(self.unit_bucket, 32))
        return art, pad_structured(sm, art, P_pad, C_pad), n_pad

    @span("advntr.model.upload")
    def _upload(self, art, sm, n_pad) -> LocusModel:
        return LocusModel(
            model=TorchStructModel.from_payload(art, sm, self.device),
            n_pad=n_pad, art=art, kernel=_default_kernel(), sm=sm)

    def _build_from_payload(self, art, sm) -> LocusModel:
        return self._upload(*self._pad(art, sm))

    def _build(self, g, art) -> LocusModel:
        """The model of a graph compiled here (finder.py:290): the
        re-estimated models of ``-u`` and ``--em``, not cached."""
        with host_step():
            padded = self._pad(art, build_structured(g, art))
        return self._upload(*padded)

    def _build_imported(self, g, art) -> LocusModel:
        """The model of an imported graph (finder.py:502-508): structured
        when the extractor takes its topology, else the dense fallback
        over the artifact padded to the state bucket (finder.py:339-345).
        The host build raises ``HostStepError``; the upload is outside."""
        with host_step():
            try:
                padded = self._pad(art, build_structured(g, art))
            except Exception as error:
                logging.info("imported topology refused by the structured "
                             "extractor (%s): dense fallback", error)
                padded = None
            if padded is None:
                n_pad = self._state_pad(art)
                dense = _pad_artifact(art, n_pad)
        if padded is not None:
            return self._upload(*padded)
        return LocusModel(model=None, n_pad=n_pad, art=art,
                          dense=da.DenseModel.from_artifact(dense,
                                                            self.device))


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


def flank_pattern_homology(pattern: str, left_flank: str,
                           right_flank: str) -> tuple[int, int]:
    """(left, right) homology runs between the flanks and the repeat
    (finder.py:399-426): the longest flank run that continues some
    rotation of the pattern, on each side."""
    if not pattern:
        return 0, 0
    p = len(pattern)
    best_r = 0
    for r in range(p):
        tiled = (pattern[r:] + pattern * (len(right_flank) // p + 1))
        k = 0
        while k < len(right_flank) and right_flank[k] == tiled[k]:
            k += 1
        best_r = max(best_r, k)
    best_l = 0
    rev_f = left_flank[::-1]
    rev_p = pattern[::-1]
    for r in range(p):
        tiled = (rev_p[r:] + rev_p * (len(left_flank) // p + 1))
        k = 0
        while k < len(rev_f) and rev_f[k] == tiled[k]:
            k += 1
        best_l = max(best_l, k)
    return best_l, best_r


class VNTRFinder:
    """Find the VNTR genotype of one locus in a pool of candidate reads."""

    def __init__(self, reference_vntr, config: Config = DEFAULT_CONFIG,
                 is_haploid: bool = False,
                 model_cache: LocusModelCache | None = None,
                 device="cuda"):
        self.reference_vntr = reference_vntr
        self.config = config
        self.is_haploid = is_haploid
        self.cache = model_cache or LocusModelCache(device=device)
        self.device = self.cache.device
        self.coverage_corrector = None
        # reference: vntr_finder.py:66-73
        self.min_repeat_bp_to_add_read = 2
        self.min_repeat_bp_to_count_repeats = 2
        self.minimum_flanking_size = 5
        self.minimum_left_flanking_size = 5
        self.minimum_right_flanking_size = 5
        if config.spanning_homology_guard:
            lh, rh = flank_pattern_homology(
                reference_vntr.pattern,
                reference_vntr.left_flanking_region,
                reference_vntr.right_flanking_region)
            self.minimum_left_flanking_size = max(
                self.minimum_left_flanking_size, lh)
            self.minimum_right_flanking_size = max(
                self.minimum_right_flanking_size, rh)
        self.vntr_start = reference_vntr.start_point
        self.vntr_end = self.vntr_start + reference_vntr.get_length()
        self._trained: dict = {}
        self._dnn_loaded = False
        self._dnn = None

    # -- model construction --------------------------------------------------

    def get_copies_for_hmm(self, read_length: int) -> int:
        # reference: vntr_finder.py:98-99
        return int(round(read_length / len(self.reference_vntr.pattern) + 0.5))

    def get_model(self, read_length: int, copies: int | None = None,
                  flank_size: int | None = None) -> LocusModel:
        trained = self._load_trained_hmm(read_length)
        if trained is not None:
            return trained
        copies = copies if copies is not None else \
            self.get_copies_for_hmm(read_length)
        flank_size = flank_size if flank_size is not None else read_length
        return self.cache.get(self.reference_vntr, copies, flank_size,
                              self.config.max_error_rate)

    def _load_trained_hmm(self, read_length: int) -> LocusModel | None:
        """The locus's pomegranate-JSON checkpoint for this read length,
        ``<trained_hmms_dir>/<vid>_<read_length>.json``, if a trained-HMM
        directory is configured and the file exists (finder.py:475-512,
        reference vntr_finder.py:117-138); cached per read length."""
        if not self.config.trained_hmms_dir:
            return None
        if read_length in self._trained:
            return self._trained[read_length]
        path = os.path.join(self.config.trained_hmms_dir,
                            f"{self.reference_vntr.id}_{read_length}.json")
        lm = None
        if os.path.exists(path):
            with host_step():
                g = load_trained_hmm(path)
                art = compile_graph(g)
            lm = self.cache._build_imported(g, art)
            logging.info("loaded trained HMM %s", path)
        self._trained[read_length] = lm
        return lm

    def _load_dnn_model(self) -> dr.RecruitmentMLP | None:
        """The locus's DNN recruitment model ``<dnn_models_dir>/<vid>.npz``
        on the finder's device, or None (finder.py:514-524, reference
        vntr_finder.py:755-759); loaded once per finder."""
        if not self._dnn_loaded:
            path = os.path.join(self.config.dnn_models_dir,
                                f"{self.reference_vntr.id}.npz")
            with host_step():
                model = dr.load_model(path)
            self._dnn = model.to(self.device) if model is not None else None
            self._dnn_loaded = True
        return self._dnn

    def _dnn_gate(self, reads) -> dict | None:
        """{(read index, orientation): kept} for both orientations of each
        unmapped read, or None without a DNN model (finder.py:574-594,
        reference process_unmapped_read_with_dnn, vntr_finder.py:192-233):
        an orientation is kept when the model's VNTR score beats its
        decoy score.  The embeddings and the model run on the device."""
        model = self._load_dnn_model()
        if model is None or not reads:
            return None
        with host_step():
            emb_rows, emb_info = [], []
            for ri, (name, seq, is_mapped) in enumerate(reads):
                if is_mapped:
                    continue
                codes = dna.encode(seq)
                emb_rows += [codes, dna.revcomp_codes(codes)]
                emb_info += [(ri, 0), (ri, 1)]
            if not emb_rows:
                return None
            batch, lengths = dna.pad_batch(emb_rows, multiple=8)
        probs = dr.predict(model, dr.embed_batch(batch, lengths,
                                                 self.device)).cpu().numpy()
        return {info: bool(probs[k, 0] > probs[k, 1])
                for k, info in enumerate(emb_info)}

    def recruitment_score_threshold(self, read_length: int):
        # reference: vntr_finder.py:174-177
        score = self.reference_vntr.scaled_score
        if score is None or score == 0:
            return None
        return score * read_length

    # -- scoring -------------------------------------------------------------

    @span("advntr.engine.prepare")
    def prepare_rows(self, mapped_reads, unmapped_reads):
        """Batch prep (finder.py:545-611): N-filter, the DNN pre-screen of
        unmapped orientations where the locus has a DNN model, both
        orientations of unmapped reads.  A read whose two orientations
        the gate both drops gets no row.  Returns (reads, rows,
        row_info); the host steps raise ``HostStepError``."""
        reads = []
        with host_step():
            for name, seq in mapped_reads:
                seq = seq.upper()
                if not dna.has_n(seq):
                    reads.append((name, seq, True))
            for name, seq in unmapped_reads:
                seq = seq.upper()
                if not dna.has_n(seq):
                    reads.append((name, seq, False))
        gate = self._dnn_gate(reads)
        rows: list[np.ndarray] = []
        row_info = []  # (read_index, orientation)
        with host_step():
            for ri, (name, seq, is_mapped) in enumerate(reads):
                codes = dna.encode(seq)
                if is_mapped:
                    rows.append(codes)
                    row_info.append((ri, 0))
                    continue
                if gate is None or gate.get((ri, 0), False):
                    rows.append(codes)
                    row_info.append((ri, 0))
                if gate is None or gate.get((ri, 1), False):
                    rows.append(dna.revcomp_codes(codes))
                    row_info.append((ri, 1))
        return reads, rows, row_info

    @staticmethod
    def pad_rows(rows, length_bucket: int = 32, pad_to: int | None = None,
                 b_pad: int | None = None):
        """Pad rows into a (B, L) batch with bucketed dimensions
        (finder.py:613-639): padded rows have length 1 and base 0."""
        if pad_to is None and rows:
            maxlen = max(len(r) for r in rows)
            if maxlen > 1024:
                length_bucket = max(length_bucket, 512)
            elif maxlen > 256:
                length_bucket = max(length_bucket, 128)
        batch, lengths = dna.pad_batch(rows, pad_to=pad_to,
                                       multiple=length_bucket)
        if b_pad is None:
            b_pad = 1 << (len(rows) - 1).bit_length()
        if b_pad != len(rows):
            batch = np.concatenate(
                [batch, np.zeros((b_pad - len(rows), batch.shape[1]),
                                 dtype=batch.dtype)])
            lengths = np.concatenate(
                [lengths, np.ones(b_pad - len(rows), dtype=lengths.dtype)])
        return batch, lengths

    def collect_scored(self, reads, row_info, stats) -> list[ScoredRead]:
        """Orientation resolution + ScoredReads (finder.py:641-670)."""
        rates = da.flank_rates(stats, accuracy_filter=False)
        best_row: dict[int, int] = {}
        for row, (ri, orient) in enumerate(row_info):
            cur = best_row.get(ri)
            if cur is None or stats["logp"][row] > stats["logp"][cur]:
                best_row[ri] = row
        scored = []
        for ri, (name, seq, is_mapped) in enumerate(reads):
            if ri not in best_row:
                continue
            row = best_row[ri]
            orient = row_info[row][1]
            scored.append(ScoredRead(
                sequence=seq if orient == 0 else dna.revcomp(seq),
                logp=float(stats["logp"][row]),
                repeats=int(stats["repeats"][row]),
                repeat_bp=int(stats["repeat_bp"][row]),
                left_flank_bp=int(stats["left_flank_bp"][row]),
                right_flank_bp=int(stats["right_flank_bp"][row]),
                flank_rate=float(rates[row]),
                n_matches=int(stats["n_matches"][row]),
                is_mapped=is_mapped, query_name=name, row=row))
        return scored

    def counts_from_stats(self, reads, row_info, stats,
                          read_length: int, accuracy_filter: bool = False):
        """Vectorized recruit gates + RU-count extraction, the grouped
        path's fast lane (finder.py:672-730)."""
        R = len(row_info)
        if R == 0:
            return [], [], 0, 0
        read_idx = np.fromiter((ri for ri, _ in row_info), dtype=np.int64,
                               count=R)
        logp = np.asarray(stats["logp"][:R], dtype=np.float64)
        n_reads = len(reads)
        # best orientation per read; the first row wins ties
        best_val = np.full(n_reads, -np.inf)
        np.maximum.at(best_val, read_idx, logp)
        is_best = logp == best_val[read_idx]
        rows_rev = np.arange(R)[is_best][::-1]
        first_best = np.full(n_reads, -1, dtype=np.int64)
        first_best[read_idx[is_best][::-1]] = rows_rev
        sel = first_best[first_best >= 0]
        if sel.size == 0:
            return [], [], 0, 0
        rates = da.flank_rates(stats)[sel]
        seq_lens = np.fromiter(
            (len(reads[i][1]) for i in np.nonzero(first_best >= 0)[0]),
            dtype=np.int64, count=sel.size)
        lp = logp[sel]
        n_matches = np.asarray(stats["n_matches"])[sel]
        repeat_bp = np.asarray(stats["repeat_bp"])[sel]
        left_bp = np.asarray(stats["left_flank_bp"])[sel]
        right_bp = np.asarray(stats["right_flank_bp"])[sel]
        repeats = np.asarray(stats["repeats"])[sel]
        min_score = self.recruitment_score_threshold(read_length)
        gate_rate = rates >= 0.90
        if min_score is not None:
            recruited = gate_rate & (lp > min_score)
        else:
            recruited = gate_rate & (n_matches >= 0.9 * seq_lens) & \
                (lp > -seq_lens)
        selected = np.isfinite(lp) & recruited & \
            (repeat_bp > self.min_repeat_bp_to_add_read)
        spanning = selected & (rates >= 0.95) & \
            (left_bp > self.minimum_left_flanking_size) & \
            (right_bp > self.minimum_right_flanking_size)
        covered_repeats = repeats[spanning].tolist()
        # the reference collects no flanking reads under the accuracy
        # filter (vntr_finder.py:838-845)
        flanking_repeats = [] if accuracy_filter else \
            repeats[selected & ~spanning].tolist()
        return (covered_repeats, flanking_repeats, int(selected.sum()),
                int(repeat_bp[selected].sum()))

    def genotype_from_counts(self, covered_repeats, flanking_repeats,
                             n_selected: int,
                             accuracy_filter: bool = False,
                             average_coverage=None) -> GenotypeResult:
        """Count combination + ML genotype (vntr_finder.py:848-887)."""
        flanking_repeats = sorted(flanking_repeats)
        min_valid_flanked = max(covered_repeats) if covered_repeats else 0
        max_flanking_repeat = [r for r in flanking_repeats
                               if r == max(flanking_repeats)
                               and r >= min_valid_flanked] \
            if flanking_repeats else []
        if len(max_flanking_repeat) < 5:
            max_flanking_repeat = []
        if accuracy_filter:
            covered_repeats = _filter_by_support(
                covered_repeats, self.config.accuracy_filter_sr_min_support)
            max_flanking_repeat = []
        genotype, max_prob = find_genotype(
            covered_repeats + max_flanking_repeat, self.is_haploid,
            self.config.genotype_error_rate)
        if average_coverage:
            pattern_occurrences = sum(flanking_repeats) + sum(covered_repeats)
            if self.coverage_corrector is not None:
                pattern_occurrences = \
                    self.coverage_corrector.get_scaled_coverage(
                        self.reference_vntr, pattern_occurrences)
            haplotypes = 1 if self.is_haploid else 2
            estimate = int(pattern_occurrences /
                           (float(average_coverage) * haplotypes))
            return GenotypeResult([estimate, estimate], n_selected,
                                  len(covered_repeats),
                                  len(flanking_repeats), 0)
        return GenotypeResult(genotype, n_selected, len(covered_repeats),
                              len(flanking_repeats), max_prob)

    def run_device(self, lm: LocusModel, batch, lengths,
                   return_paths: bool = False) -> dict:
        """Score a padded batch on the cache's device; numpy stats, with
        the decoded artifact-space paths (B, L) under "path" when
        ``return_paths``.  Long lattices (multi-kb long-read windows) take
        the checkpointed traceback (finder.py:772-781) of the model's
        kernel; a dense model the dense fallback, whatever the length
        (finder.py:793-796).  Where the reference decodes every long
        lattice with its struct kernel, the port's ``pallas`` models keep
        B1/B2's checkpointed path."""
        with span("advntr.decode.launch"):
            seqs = torch.as_tensor(batch, device=self.device)
            lens = torch.as_tensor(lengths, device=self.device)
            path = {"return_path": True} if return_paths else {}
            if lm.dense is not None:
                stats = da.read_stats_dense(lm.dense, seqs, lens, **path)
            elif lm.kernel == "struct":
                read_stats = da.read_stats_struct
                if seqs.shape[1] > CKPT_TRACEBACK_L:
                    read_stats = functools.partial(
                        da.read_stats_struct_ckpt, segment=CKPT_SEGMENT)
                stats = read_stats(lm.struct_model(), lm.model.art_meta,
                                   seqs, lens, lm.sm.suffix_last, **path)
            elif seqs.shape[1] > CKPT_TRACEBACK_L:
                stats = da.read_stats_ckpt(lm.model, seqs, lens,
                                           segment=CKPT_SEGMENT, **path)
            else:
                stats = da.read_stats(lm.model, seqs, lens, **path)
        with span("advntr.decode.wait"):
            return {k: v.cpu().numpy() for k, v in stats.items()}

    @span("advntr.score")
    def score_reads(self, mapped_reads, unmapped_reads, read_length: int,
                    model=None, length_bucket: int = 32,
                    return_paths: bool = False):
        """Batch-score candidate reads; unmapped reads are scored in both
        orientations and the better one wins (vntr_finder.py:235-246).
        Returns (ScoredReads, raw stats)."""
        lm = model if model is not None else self.get_model(read_length)
        reads, rows, row_info = self.prepare_rows(mapped_reads,
                                                  unmapped_reads)
        if not rows:
            return [], None
        with span("advntr.decode.stack"):
            batch, lengths = self.pad_rows(rows, length_bucket)
        count("decode.rows", len(rows))
        count("decode.rows_padded", batch.shape[0])
        count("decode.bases", int(lengths[:len(rows)].sum()))
        count("decode.cells", batch.size)
        stats = self.run_device(lm, batch, lengths, return_paths)
        return self.collect_scored(reads, row_info, stats), stats

    # -- recruitment gate (reference: vntr_finder.py:179-190) ----------------

    def recruit_read(self, read: ScoredRead, min_score) -> bool:
        if read.flank_rate < 0.90:
            return False
        read_length = len(read.sequence)
        if min_score is not None and read.logp > min_score:
            return True
        return min_score is None and read.n_matches >= 0.9 * read_length \
            and read.logp > -read_length

    def spans_with_confidence(self, read: ScoredRead) -> bool:
        # reference: vntr_finder.py:311-322
        if read.flank_rate < 0.95:
            return False
        return (read.left_flank_bp > self.minimum_left_flanking_size and
                read.right_flank_bp > self.minimum_right_flanking_size)

    # -- top-level Illumina genotyping ---------------------------------------

    def select_reads(self, mapped_reads, unmapped_reads, read_length: int,
                     return_paths: bool = False, model=None):
        scored, stats = self.score_reads(mapped_reads, unmapped_reads,
                                         read_length, model=model,
                                         return_paths=return_paths)
        return self.select_from_scored(scored, read_length), stats

    def _decoded(self, lm: LocusModel, reads, stats):
        """(sequence, visited-state names) of each scored read, its path
        cut to its own length (finder.py:892-896)."""
        return [(read.sequence, lm.visited_states(
            stats["path"][read.row][:len(read.sequence)])) for read in reads]

    # -- model updating (reference: iteratively_update_model,
    #    vntr_finder.py:668-698) ---------------------------------------------

    def _read_matcher(self, read_length: int, trans, emis):
        """The locus's read-matcher graph over a repeat profile, with
        ``read_length`` bp flanks."""
        left = self.reference_vntr.left_flanking_region[-read_length:]
        right = self.reference_vntr.right_flanking_region[:read_length]
        return build_read_matcher(left, right, trans, emis,
                                  self.get_copies_for_hmm(read_length),
                                  self.config.max_error_rate)

    def rebuild_model_from_vpaths(self, seq_vpaths, read_length: int):
        """Re-estimate the repeat profile from the MSA of decoded unit paths
        and rebuild the read-matcher model (finder.py:853; the reference
        builds it via get_read_matcher_model(..., vpaths),
        hmm_utils.py:553-555 + profile_hmm.py:13)."""
        from advntr_tpu_torch.engine import analytics as an
        from advntr_tpu_torch.models.msa import msa_from_viterbi_paths
        from advntr_tpu_torch.models.profile import profile_from_alignment

        with host_step():
            repeats_sequences: list[str] = []
            repeats_states: list[list[str]] = []
            for seq, visited in seq_vpaths:
                reps, vps = an.extract_repeating_segments(seq, visited)
                repeats_sequences += reps
                repeats_states += vps
            if not repeats_sequences:
                return None
            alignment = msa_from_viterbi_paths(repeats_sequences,
                                               repeats_states)
            trans, emis = profile_from_alignment(self.config.max_error_rate,
                                                 alignment)
            g = self._read_matcher(read_length, trans, emis)
            art = compile_graph(g)
        return self.cache._build(g, art)

    def update_and_reselect(self, mapped_reads, unmapped_reads,
                            read_length: int):
        """One model-update iteration (finder.py:882): decode the selected
        reads and the reference repeat units, re-estimate, re-select (the
        reference's loop runs a single iteration: its fitness is computed
        from the pre-update read set and never changes,
        vntr_finder.py:692-695)."""
        lm = self.get_model(read_length)
        selected, stats = self.select_reads(mapped_reads, unmapped_reads,
                                            read_length, return_paths=True)
        with host_step():
            seq_vpaths = self._decoded(lm, selected, stats)
        # the reference repeat segments join the update set
        # (vntr_finder.py:673-677)
        ref_repeats = [(f"ref{i}", s.upper()) for i, s in
                       enumerate(self.reference_vntr.get_repeat_segments())]
        ref_scored, ref_stats = self.score_reads(
            ref_repeats, [], read_length, return_paths=True)
        with host_step():
            seq_vpaths += self._decoded(
                lm, [r for r in ref_scored if np.isfinite(r.logp)],
                ref_stats)
        updated = self.rebuild_model_from_vpaths(seq_vpaths, read_length)
        if updated is None:
            return selected
        new_selected, _ = self.select_reads(mapped_reads, unmapped_reads,
                                            read_length, model=updated)
        return new_selected

    def em_update_and_reselect(self, mapped_reads, unmapped_reads,
                               read_length: int, max_iters: int = 5):
        """EM-based model update (``--update --em``, finder.py:913):
        select reads, run batched Baum-Welch over their sequences
        (ops/baum_welch.py), fold the EM-updated repeat-unit emissions back
        into the profile (averaged across unit copies), rebuild the model,
        and re-select.

        Emission-only by design: EM runs on the silent-eliminated
        first-order model, whose transitions close delete chains away, so
        only the emission rows map back onto profile states (M{i}/I{i});
        transitions keep the reference profile estimation."""
        import re
        selected, _ = self.select_reads(mapped_reads, unmapped_reads,
                                        read_length)
        if not selected:
            return selected
        out = self.em_update([r.sequence for r in selected], read_length,
                             max_iters=max_iters)
        with host_step():
            E = np.exp(np.asarray(out["log_E"], dtype=np.float64))
            # aggregate repeat-region states M{i}_{copy}/I{i}_{copy} (copy
            # is a bare integer; flank states carry _suffix/_prefix) per
            # unit position
            agg: dict[str, list[np.ndarray]] = {}
            for row, name in zip(E, out["names"]):
                m = re.fullmatch(r"([MI])(\d+)_(\d+)", name)
                if m:
                    agg.setdefault(f"{m.group(1)}{m.group(2)}",
                                   []).append(row)
            if not agg:
                return selected
            trans, emis = profile_for_repeats(
                list(self.reference_vntr.get_repeat_segments()),
                self.config.max_error_rate)
            for key, rows_ in agg.items():
                if key in emis:
                    mean = np.mean(rows_, axis=0)
                    mean = mean / mean.sum()
                    emis[key] = {b: float(mean[dna.encode(b)[0]])
                                 for b in "ACGT"}
            g = self._read_matcher(read_length, trans, emis)
            art = compile_graph(g)
        updated = self.cache._build(g, art)
        new_selected, _ = self.select_reads(mapped_reads, unmapped_reads,
                                            read_length, model=updated)
        return new_selected

    def find_repeat_count(self, mapped_reads, unmapped_reads,
                          read_length: int | None = None,
                          accuracy_filter: bool = False,
                          average_coverage=None,
                          update: bool = False,
                          em: bool = False) -> GenotypeResult:
        """Genotype from candidate reads (vntr_finder.py:789-887), after
        one model update under ``update`` (Baum-Welch under ``em``)."""
        with span("advntr.locus", vid=self.reference_vntr.id):
            if read_length is None:
                lens = sorted(len(s) for _, s in
                              (mapped_reads + unmapped_reads)[:5])
                read_length = lens[len(lens) // 2] if lens else 150
            if update and em:
                selected = self.em_update_and_reselect(mapped_reads,
                                                       unmapped_reads,
                                                       read_length)
            elif update:
                selected = self.update_and_reselect(
                    mapped_reads, unmapped_reads, read_length)
            else:
                selected, _ = self.select_reads(mapped_reads, unmapped_reads,
                                                read_length)
            return self.genotype_from_selected(selected, accuracy_filter,
                                               average_coverage)

    def select_from_scored(self, scored, read_length: int):
        """Recruitment gates over already-scored reads."""
        min_score = self.recruitment_score_threshold(read_length)
        return [read for read in scored
                if np.isfinite(read.logp)
                and self.recruit_read(read, min_score)
                and read.repeat_bp > self.min_repeat_bp_to_add_read]

    def genotype_from_selected(self, selected, accuracy_filter: bool = False,
                               average_coverage=None) -> GenotypeResult:
        """RU counting + diploid ML genotype from selected reads
        (vntr_finder.py:806-887)."""
        covered_repeats = []
        flanking_repeats = []
        for read in selected:
            if self.spans_with_confidence(read):
                covered_repeats.append(read.repeats)
            elif not accuracy_filter:
                flanking_repeats.append(read.repeats)
        logging.info("covered repeats: %s", covered_repeats)
        logging.info("flanking repeats: %s", sorted(flanking_repeats))
        return self.genotype_from_counts(covered_repeats, flanking_repeats,
                                         len(selected), accuracy_filter,
                                         average_coverage)

    # -- frameshift mode (reference: vntr_finder.py:256-309) -----------------

    def _sum_closure_tensors(self, read_length: int):
        """Sum-semiring model tensors for the posterior, split into the
        full closure and its repeat-delete-routed part, on the device
        (finder.py:1053; cached per read length).  See ops/posterior.py
        for the decomposition."""
        cached = getattr(self, "_sum_cache", {})
        if read_length in cached:
            return cached[read_length]
        from advntr_tpu_torch.ops.posterior import clean_neg, indel_model
        with host_step():
            trans, emis = profile_for_repeats(
                list(self.reference_vntr.get_repeat_segments()),
                self.config.max_error_rate)
            host, occ_mask = indel_model(
                self._read_matcher(read_length, trans, emis))
        tensors = tuple(clean_neg(x, self.device) for x in host) + (
            torch.as_tensor(occ_mask, device=self.device),)
        cached[read_length] = tensors
        self._sum_cache = cached
        return tensors

    def _encode_batch(self, sequences: list[str]):
        """(B, L) codes padded to a multiple of 32, and lengths, on the
        device."""
        batch, lengths = dna.pad_batch([dna.encode(s) for s in sequences],
                                       multiple=32)
        return (torch.as_tensor(batch, device=self.device),
                torch.as_tensor(lengths, device=self.device))

    def frameshift_posterior(self, sequences: list[str], read_length: int,
                             max_reads: int = 128) -> dict:
        """Posterior indel support over recruited reads (finder.py:1091):
        expected repeat insert-state emissions and expected
        repeat-delete-routed transitions per read under the
        forward-backward posterior."""
        from advntr_tpu_torch.ops.posterior import posterior_indel_batch
        tensors = self._sum_closure_tensors(read_length)
        seqs = sequences[:max_reads]
        out = posterior_indel_batch(*tensors, *self._encode_batch(seqs))
        occ = out["ins_occupancy"].cpu().numpy().astype(np.float64)
        dm = out["del_mass"].cpu().numpy().astype(np.float64)
        return {
            "reads": len(seqs),
            "insert_occupancy": occ,
            "delete_mass": dm,
            "mean_insert_occupancy": float(occ.mean()) if len(seqs) else 0.0,
            "mean_delete_mass": float(dm.mean()) if len(seqs) else 0.0,
            "indel_support": float(occ.sum() + dm.sum()),
        }

    def em_update(self, sequences: list[str], read_length: int,
                  max_iters: int = 5, inertia: float = 0.0,
                  max_reads: int = 256) -> dict:
        """Baum-Welch re-estimation over recruited reads (finder.py:1116):
        EM on the sum-closed model (ops/baum_welch.py).  Returns
        {"history": total loglik per iteration, "log_T", "log_E",
        "log_start", "log_end": the updated tables, "names": the emitting
        states' names}."""
        from advntr_tpu_torch.models.compiler import compile_graph_sum
        from advntr_tpu_torch.ops.baum_welch import baum_welch_fit
        with host_step():
            trans, emis = profile_for_repeats(
                list(self.reference_vntr.get_repeat_segments()),
                self.config.max_error_rate)
            g = self._read_matcher(read_length, trans, emis)
            log_T, log_E, log_start, log_end = compile_graph_sum(g)
            names = [s.name for i, s in enumerate(g.states)
                     if not s.is_silent and i not in (g.start, g.end)]
        params, history = baum_welch_fit(
            log_T, log_E, log_start, log_end,
            *self._encode_batch(sequences[:max_reads]),
            max_iters=max_iters, inertia=inertia)
        return {"history": history, "log_T": params[0], "log_E": params[1],
                "log_start": params[2], "log_end": params[3],
                "names": names}

    def find_frameshift(self, mapped_reads, unmapped_reads,
                        read_length: int | None = None,
                        posterior: bool | None = None):
        """The frameshift call of a locus (finder.py:1152): indel states
        counted per repeat unit on the decoded paths of the selected
        reads, the binomial LR of ``identify_frameshift``, and by default
        the posterior indel report (reporting only: a failure of the
        posterior is logged and the call stands)."""
        from advntr_tpu_torch.engine import analytics as an
        if read_length is None:
            lens = sorted(len(s) for _, s in
                          (mapped_reads + unmapped_reads)[:5])
            read_length = lens[len(lens) // 2] if lens else 150
        lm = self.get_model(read_length)
        selected, stats = self.select_reads(mapped_reads, unmapped_reads,
                                            read_length, return_paths=True)
        if not selected:
            return None
        with host_step():
            mutations: dict[str, int] = {}
            repeating_bps_in_data = 0
            pattern_len = len(self.reference_vntr.pattern)
            for read, (_, visited) in zip(
                    selected, self._decoded(lm, selected, stats)):
                lengths_per_unit = an.repeating_pattern_lengths(visited)
                repeating_bps_in_data += read.repeat_bp
                current_repeat = None
                for vs in visited:
                    if vs.endswith("fix") or vs.startswith("M"):
                        continue
                    if vs.startswith("unit_start"):
                        current_repeat = 0 if current_repeat is None \
                            else current_repeat + 1
                    if current_repeat is None or \
                            current_repeat >= len(lengths_per_unit):
                        continue
                    if not vs.startswith("I") and not vs.startswith("D"):
                        continue
                    if lengths_per_unit[current_repeat] == pattern_len:
                        continue
                    state = vs.split("_")[0]
                    if state.startswith("I"):
                        emitted = an.emitted_base_for_state(vs, visited,
                                                           read.sequence)
                        state += emitted or ""
                    if abs(lengths_per_unit[current_repeat]
                           - pattern_len) <= 2:
                        mutations[state] = mutations.get(state, 0) + 1
            sorted_mutations = sorted(mutations.items(), key=lambda x: x[1])
            candidate = sorted_mutations[-1] if sorted_mutations \
                else (None, 0)
            avg_bp_coverage = (repeating_bps_in_data /
                               self.reference_vntr.get_length() / 2)
            if avg_bp_coverage == 0:
                return None
            expected_indels = 1 / avg_bp_coverage
            if not identify_frameshift(avg_bp_coverage, candidate[1],
                                       expected_indels):
                return None
        if candidate[0] is None:
            # the LR fires with no concrete mutation to report (observed 0
            # at integer coverage): the reference returns None here
            return None
        if posterior is None:
            posterior = self.config.frameshift_posterior
        post = None
        if posterior:
            try:
                post = self.frameshift_posterior(
                    [r.sequence for r in selected], read_length)
                logging.info(
                    "frameshift posterior %s: candidate %s (LR support %d); "
                    "mean insert occupancy %.3f, mean delete mass %.3f "
                    "per read over %d reads",
                    self.reference_vntr.id, candidate[0], candidate[1],
                    post["mean_insert_occupancy"],
                    post["mean_delete_mass"], post["reads"])
            except Exception as error:  # the reference's reporting-only
                logging.warning("frameshift posterior failed for %s: %s",
                                self.reference_vntr.id, error)
        call = FrameshiftCall(candidate[0])
        call.lr_support = candidate[1]
        call.posterior = post
        return call

    # -- PacBio path (reference: vntr_finder.py:324-471, 534-665) ------------

    def _check_flanks_align(self, read_str: str, name: str,
                            spanning: list, length_dist: list,
                            flank_size: int = 100) -> None:
        """Anchor both 100bp flanks inside a long read by local alignment;
        on success, record the trimmed VNTR+-flank window
        (reference semantics: check_if_flanking_regions_align_to_str,
        vntr_finder.py:324-365)."""
        left = self.reference_vntr.left_flanking_region[-flank_size:]
        right = self.reference_vntr.right_flanking_region[:flank_size]
        min_score_l = len(left) * (1 - self.config.max_error_rate)
        score_l, start_l, _ = local_align(read_str, left)
        if score_l < min_score_l:
            return
        min_score_r = len(right) * (1 - self.config.max_error_rate)
        score_r, start_r, _ = local_align(read_str, right)
        if score_r < min_score_r:
            return
        if start_r < start_l:
            return
        spanning.append((name, read_str[start_l:start_r + flank_size]))
        length_dist.append(start_r - (start_l + flank_size))

    @span("advntr.engine.windows")
    def get_spanning_reads_of_unaligned_pacbio_reads(self, unmapped_reads):
        """Batched flank anchoring: both orientations of every long read are
        aligned against both 100bp flank probes in four passes of one
        launch on the cache's device (finder.py:1259-1295; the original
        adVNTR forks one process per read and runs Bio.pairwise2,
        vntr_finder.py:423-439)."""
        flank_size = 100
        left = self.reference_vntr.left_flanking_region[-flank_size:]
        right = self.reference_vntr.right_flanking_region[:flank_size]
        min_l = len(left) * (1 - self.config.max_error_rate)
        min_r = len(right) * (1 - self.config.max_error_rate)

        names, seqs, codes = [], [], []
        for name, seq in unmapped_reads:
            seq = seq.upper()
            rev = dna.revcomp(seq)
            for s in (seq, rev):
                names.append(name)
                seqs.append(s)
                codes.append(dna.encode(s))
        spanning: list = []
        length_dist: list = []
        if not codes:
            return spanning, length_dist
        res_l, res_r = anchor_probes_batch(
            codes, [dna.encode(left), dna.encode(right)], self.device)
        for name, s, (score_l, start_l, _), (score_r, start_r, _) in zip(
                names, seqs, res_l, res_r):
            if score_l < min_l or score_r < min_r:
                continue
            if start_r < start_l:
                continue
            spanning.append((name, s[start_l:start_r + flank_size]))
            length_dist.append(start_r - (start_l + flank_size))
        logging.info("length_distribution of unmapped spanning reads: %s",
                     length_dist)
        return spanning, length_dist

    def get_spanning_reads_of_aligned_pacbio_reads(self, bam):
        """Extract VNTR-spanning windows from aligned long reads by walking
        aligned reference positions (reference semantics:
        check_if_pacbio_mapped_read_spans_vntr, vntr_finder.py:373-420)."""
        hmm_flank = 100
        min_flanking_bp = 10
        vntr_start, vntr_end = self.vntr_start, self.vntr_end
        region_start = vntr_start - hmm_flank
        style = get_reference_genome_style(bam.references)
        chromosome = (self.reference_vntr.chromosome if style == "HG19"
                      else self.reference_vntr.chromosome[3:])
        spanning = []
        for read in bam.fetch(chromosome, vntr_start, vntr_end):
            positions = read.get_reference_positions()
            if not positions:
                continue
            if not (positions[0] <= vntr_start - min_flanking_bp
                    and vntr_end + min_flanking_bp < positions[-1]):
                continue
            read_region_start = read_region_end = None
            left_bp = right_bp = 0
            for read_pos, ref_pos in enumerate(
                    read.get_reference_positions(full_length=True)):
                if ref_pos is None:
                    continue
                if ref_pos > vntr_end + hmm_flank:
                    break
                if region_start <= ref_pos < vntr_end + hmm_flank:
                    if region_start <= ref_pos < vntr_start:
                        if read_region_start is None:
                            read_region_start = read_pos
                        left_bp += 1
                    elif vntr_start <= ref_pos < vntr_end:
                        pass
                    else:
                        if read_region_end is None:
                            read_region_end = read_pos
                        right_bp += 1
            if left_bp < min_flanking_bp or right_bp < min_flanking_bp:
                continue
            if read_region_start is not None and read_region_end is not None \
                    and read.seq:
                seq = read.seq[read_region_start:read_region_end + right_bp]
                spanning.append((read.query_name, seq))
        return spanning

    def get_dominant_copy_numbers_from_spanning_reads(
            self, spanning_reads, accuracy_filter: bool = False):
        """Viterbi-decode each spanning window against a max-copies model and
        genotype the observed RU counts (reference semantics:
        vntr_finder.py:534-585)."""
        if len(spanning_reads) < 1:
            logging.info("There is no spanning read")
            return None, 0
        max_length = 0
        for _, seq in spanning_reads:
            if len(seq) - 100 > max_length:
                max_length = len(seq) - 100
        max_copies = int(round(max_length /
                               float(len(self.reference_vntr.pattern))))
        max_copies = max(max_copies, 1)
        if accuracy_filter:
            self.minimum_left_flanking_size = \
                self.config.accuracy_filter_min_left_flanking_size
            self.minimum_right_flanking_size = \
                self.config.accuracy_filter_min_right_flanking_size
        model = self.get_model(read_length=0, copies=max_copies,
                               flank_size=100)
        scored, _ = self.score_reads(spanning_reads, [], read_length=0,
                                     model=model)
        observed = [r.repeats for r in scored if np.isfinite(r.logp)]
        logging.info("observed repeats: %s", observed)
        if accuracy_filter:
            observed = _filter_by_support(
                observed, self.config.accuracy_filter_sr_min_support)
        return find_genotype(observed, self.is_haploid,
                             self.config.genotype_error_rate)

    def get_haplotype_copy_numbers_from_spanning_reads(self, spanning_reads):
        """Cluster spanning reads into haplotypes, decode the consensus of
        each (reference semantics: vntr_finder.py:588-609)."""
        if len(spanning_reads) < 1:
            return None
        max_length = 0
        for _, seq in spanning_reads:
            if len(seq) - 100 > max_length:
                max_length = len(seq) - 100
        max_copies = int(round(max_length /
                               float(len(self.reference_vntr.pattern))))
        max_copies = min(max(max_copies, 1),
                         2 * len(self.reference_vntr.get_repeat_segments()))
        model = self.get_model(read_length=0, copies=max_copies,
                               flank_size=100)
        with host_step():
            haplotyper = PacBioHaplotyper([seq for _, seq in spanning_reads])
            haplotypes = haplotyper.get_error_corrected_haplotypes()
        if not haplotypes:
            return None
        scored, _ = self.score_reads(
            [], [(f"hap{i}", h) for i, h in enumerate(haplotypes)],
            read_length=0, model=model)
        return [r.repeats for r in scored]

    def find_ru_counts_with_naive_approach(self, spanning_reads):
        """RU count from the flank-to-flank distance of the error-corrected
        consensus (reference semantics: vntr_finder.py:611-624); host work
        throughout."""
        with host_step():
            haplotyper = PacBioHaplotyper([seq for _, seq in spanning_reads])
            haplotypes = haplotyper.get_error_corrected_haplotypes(1)
            if len(haplotypes) == 0:
                return None
            flanking_lengths: list = []
            dummy: list = []
            self._check_flanks_align(haplotypes[0].upper(), "consensus",
                                     dummy, flanking_lengths)
            self._check_flanks_align(dna.revcomp(haplotypes[0]).upper(),
                                     "consensus", dummy, flanking_lengths)
        if flanking_lengths:
            ru = round(flanking_lengths[0] / len(self.reference_vntr.pattern))
            return (ru, ru)
        return None

    def find_repeat_count_pacbio(self, unmapped_reads,
                                 accuracy_filter: bool = False,
                                 naive: bool = False,
                                 mapped_spanning=None) -> GenotypeResult:
        """PacBio genotyping from recruited unmapped reads plus the windows
        of aligned reads (reference: vntr_finder.py:639-665).  The caller
        walks the alignment (``get_spanning_reads_of_aligned_pacbio_reads``)
        and hands the windows in as ``mapped_spanning``, so that an error in
        that host walk is the caller's to report."""
        spanning, length_dist = \
            self.get_spanning_reads_of_unaligned_pacbio_reads(unmapped_reads)
        if mapped_spanning:
            spanning = list(mapped_spanning) + spanning
        max_prob = 0
        if naive:
            copy_numbers = self.find_ru_counts_with_naive_approach(spanning) \
                if spanning else None
        else:
            copy_numbers, max_prob = \
                self.get_dominant_copy_numbers_from_spanning_reads(
                    spanning, accuracy_filter)
        return GenotypeResult(copy_numbers, len(spanning), len(spanning), 0,
                              max_prob)


def _filter_by_support(counts: list[int], min_support: int) -> list[int]:
    from collections import Counter
    out = []
    for key, cnt in Counter(counts).most_common():
        if cnt >= min_support:
            out.extend([key] * cnt)
    return out
