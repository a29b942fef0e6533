"""A locus model's key, its numpy ``(art, sm)`` payload and its bank
files, on the host (no torch here).  A bank file ``*.pkl.gz`` holds the
decode payload: the artifact without its O(n^2) ``DENSE_FIELDS``, which
load on demand (``DenseSource``) from the companion ``*.dense.pkl.gz`` or
a rebuild.  ``load_reference_payload`` also reads the reference's bank
files, full or slim, without importing that package."""

from __future__ import annotations

import dataclasses
import gzip
import importlib
import logging
import os
import pickle

from advntr_tpu_torch.models.compiler import ModelArtifact, compile_graph
from advntr_tpu_torch.models.graph import build_read_matcher
from advntr_tpu_torch.models.profile import profile_for_repeats
from advntr_tpu_torch.models.struct_compiler import build_structured
from advntr_tpu_torch.utils.profiler import count, span

# The artifact's O(n^2) tables: a bank payload leaves them out, since the
# default decode reads only the O(n) fields (finder.py:115-125)
DENSE_FIELDS = ("log_T", "t_unit_starts", "t_unit_ends", "hop_choice",
                "closure_parent")


def copies_for_hmm(pattern: str, read_length: int) -> int:
    """The unit copies of a locus's read-matcher model at ``read_length``
    (reference: vntr_finder.py:98-99); with ``read_length`` bp flanks and
    the error rate, the model's key and its bank file's name."""
    return int(round(read_length / len(pattern) + 0.5))


def model_key(ref_vntr, read_length: int, error_rate: float) -> tuple:
    """(ref_vntr, copies, flank size, error rate): the key of a locus's
    read-matcher model for ``read_length`` bp reads, which the cache and
    its bank file's name take."""
    return (ref_vntr, copies_for_hmm(ref_vntr.pattern, read_length),
            read_length, error_rate)


def has_dense_tables(art) -> bool:
    """Whether the artifact carries its dense tables (a decode payload's
    artifact does not)."""
    return all(getattr(art, f) is not None for f in DENSE_FIELDS)


def read_matcher(ref_vntr, copies: int, flank_size: int,
                 error_rate: float, profile=None):
    """The locus's read-matcher graph of the key (copies, flank size, error
    rate): ``copies`` units of ``profile`` (trans, emis; by default that
    of the locus's reference repeat units) between its ``flank_size`` bp
    flanks."""
    if profile is None:
        profile = profile_for_repeats(list(ref_vntr.get_repeat_segments()),
                                      error_rate)
    return build_read_matcher(ref_vntr.left_flanking_region[-flank_size:],
                              ref_vntr.right_flanking_region[:flank_size],
                              *profile, copies, error_rate)


@span("advntr.model.build")
def build_locus_payload(ref_vntr, copies: int, flank_size: int,
                        error_rate: float):
    """Host-side model construction for one locus (finder.py:128-143):
    profile estimation, graph build, silent-state elimination, structured
    extraction.  Pure numpy output, so it can run in worker processes; the
    artifact is whole (``decode_payload`` is what a bank file holds)."""
    with span("advntr.model.build.profile"):
        profile = profile_for_repeats(list(ref_vntr.get_repeat_segments()),
                                      error_rate)
    with span("advntr.model.build.graph"):
        g = read_matcher(ref_vntr, copies, flank_size, error_rate, profile)
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


def read_or_build(bank_dir: str | None, ref_vntr, copies: int,
                  flank_size: int, error_rate: float, future=None):
    """(art, sm, the ``DenseSource`` of art's dense tables or None) of one
    locus: the result of ``future`` where a worker builds it, else its
    bank file under ``bank_dir``, else a build here.  A build keeps its
    whole artifact and banks its decode payload; its companion is written
    when a mode reads the dense tables.  A build here counts its
    artifact's states (``model.build_states``) and the bytes of its dense
    tables (``model.build_dense_bytes``), which the cache holds until the
    wave's ``evict``; a worker's build adds to neither, since its
    ``advntr.model.build`` span stays in the worker's process."""
    key = (copies, flank_size, error_rate)
    path = bank_payload_path(bank_dir, ref_vntr.id, *key) if bank_dir \
        else None
    built = None
    if future is not None:
        with span("advntr.model.pool_wait"):
            payload = built = future.result()
        count("model.pool_hit")
    elif path is not None and os.path.exists(path):
        with span("advntr.model.bank_read"):
            payload = load_reference_payload(path)
        count("model.bank_hit")
        count("model.bank_bytes_read", os.path.getsize(path))
    else:
        payload = built = build_locus_payload(ref_vntr, *key)
        count("model.built")
        count("model.build_states", len(payload[0].names))
        count("model.build_dense_bytes", sum(
            t.nbytes for t in dense_tables(payload[0]).values()))
    if built is not None and path is not None and not os.path.exists(path):
        with span("advntr.model.bank_write"):
            os.makedirs(bank_dir, exist_ok=True)
            n = write_payload(path, decode_payload(*payload))
        count("model.bank_bytes_written", n)
    # a full payload read from the bank carries its dense tables
    source = None
    if not has_dense_tables(payload[0]) or (built is not None and path):
        source = DenseSource((ref_vntr, *key),
                             path and dense_payload_path(path))
    return (*payload, source)


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
    key: tuple                 # (ref_vntr, copies, flank size, error rate)
    path: str | None           # the companion, where the cache has a bank

    def fill(self, art) -> ModelArtifact:
        """``art`` with its dense tables."""
        with span("advntr.model.dense"):
            if not has_dense_tables(art):
                if self.path is not None and os.path.exists(self.path):
                    tables = load_reference_payload(self.path)
                    count("model.dense_read")
                    return dataclasses.replace(art, **tables)
                full, _ = build_locus_payload(*self.key)
                count("model.dense_rebuild")
                art = dataclasses.replace(art, **dense_tables(full))
            if self.path is not None and not os.path.exists(self.path):
                try:
                    write_payload(self.path, dense_tables(art))
                    count("model.dense_write")
                except OSError as error:   # a bank the call cannot write
                    logging.warning("dense tables not banked: %s", error)
        return art
