"""Per-read genotyping analytics on the device.

Counterpart of advntr_tpu/engine/device_analytics.py.  ``read_stats``
runs the fused kernel pair (ops/viterbi_fused.py) for one locus and
returns only O(B) scalars; ``read_stats_grouped`` scores G same-shape
loci with one launch of each kernel.  ``read_stats_ckpt`` is the memory-safe
path for long lattices: the checkpointed traceback, then
``analytics_from_path``, the plain path-walking analytics that the
backward walk's in-kernel statistics are held against.  The
``read_stats_struct*`` functions are the same analytics over the
structured decoder of ops/viterbi_struct.py (``ADVNTR_TPU_KERNEL=struct``):
whole reads, the checkpointed traceback, and G loci in one sequence of
launches.  ``DenseModel`` and
``read_stats_dense`` are the dense fallback for an imported model whose
topology the structured extractor refuses: Viterbi over the (n, n)
eliminated table in plain PyTorch (the reference's is XLA, not Pallas),
then the same path analytics.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from advntr_tpu_torch.models.graph import (K_MATCH, R_PREFIX, R_REPEAT,
                                           R_SUFFIX)
from advntr_tpu_torch.ops import viterbi_ckpt
from advntr_tpu_torch.ops.viterbi import prepare_model_tensors, viterbi_batch
from advntr_tpu_torch.ops import viterbi_fused as vf
from advntr_tpu_torch.ops.viterbi_struct import viterbi_struct_batch
from advntr_tpu_torch.ops.struct_model import TorchStructModel
from advntr_tpu_torch.ops.viterbi_fused import MIN_BP_IN_REPEAT


def read_stats(model, seqs, lengths, return_path: bool = False,
               origin32: bool = False) -> dict:
    """Viterbi + traceback + analytics for one locus: a dict of (B,)
    tensors (counterpart of read_stats_pallas, device_analytics.py:222)."""
    return vf.viterbi_stats(model, seqs, lengths, return_path=return_path,
                            origin32=origin32)


def read_stats_grouped(models, seqs, lengths,
                       return_path: bool = False) -> dict:
    """G same-shape loci: models[g] scores seqs[g] (B, L) with lengths[g];
    a dict of (G, B) tensors (counterpart of read_stats_pallas_grouped,
    device_analytics.py:276)."""
    return vf.viterbi_stats_grouped(TorchStructModel.stack(models), seqs,
                                    lengths, return_path=return_path)


def read_stats_ckpt(model, seqs, lengths, return_path: bool = False,
                    segment: int = 512, origin32: bool = False) -> dict:
    """Viterbi + analytics through the checkpointed (recompute) traceback,
    for lattices too long for whole origin planes (counterpart of
    read_stats_struct_ckpt, device_analytics.py:208-219): the decoded path
    in artifact space, then the plain path analytics once over the
    (B, L) batch."""
    logp, _, path = viterbi_ckpt.viterbi_checkpointed(
        model, seqs, lengths, segment=segment, return_path=True,
        origin32=origin32)
    return analytics_from_path(model.art_meta, logp, path, seqs, lengths,
                               return_path=return_path)


def read_stats_struct(model, meta, seqs, lengths, suffix_last,
                      return_path: bool = False) -> dict:
    """Structured Viterbi + analytics for one locus
    (device_analytics.py:197-205): ``model`` a ``StructDeviceModel``,
    ``meta`` the artifact's (kind, region, exp_base, unit) vectors."""
    logp, _, path = viterbi_struct_batch(model, seqs, lengths, suffix_last,
                                         return_path=True)
    return analytics_from_path(meta, logp, path, seqs, lengths,
                               return_path=return_path)


def read_stats_struct_ckpt(model, meta, seqs, lengths, suffix_last,
                           return_path: bool = False,
                           segment: int = 512) -> dict:
    """``read_stats_struct`` through the checkpointed traceback, for
    lattices too long for whole value planes (device_analytics.py:
    208-219)."""
    logp, _, path = viterbi_ckpt.viterbi_struct_checkpointed(
        model, seqs, lengths, suffix_last, return_path=True,
        segment=segment)
    return analytics_from_path(meta, logp, path, seqs, lengths,
                               return_path=return_path)


def stack_meta(metas) -> tuple:
    """G loci's (kind, region, exp_base, unit) vectors as four (G, n)
    tensors, each padded to the longest with the fills of the reference's
    state padding (finder.py:313-316); no decoded path reaches a pad."""
    metas = [tuple(meta) for meta in metas]
    n = max(meta[0].shape[0] for meta in metas)
    fills = (3, 3, -1, -1)
    return tuple(
        torch.stack([torch.cat([meta[i], meta[i].new_full(
            (n - meta[i].shape[0],), fills[i])]) for meta in metas])
        for i in range(4))


def read_stats_struct_grouped(stacked, stacked_meta, seqs, lengths,
                              suffix_lasts, return_path: bool = False):
    """Structured Viterbi + analytics for G same-shape loci in one
    sequence of launches a column (device_analytics.py:260-273):
    ``stacked`` a ``StructDeviceModel.stack``, ``stacked_meta`` four
    (G, n) tensors (``stack_meta``); seqs (G, B, L), lengths (G, B),
    suffix_lasts (G,).  A dict of (G, B) tensors; the analytics run once
    over the G x B rows, each locus's states offset into its own slice of
    the flattened metadata."""
    G, B, L = seqs.shape
    logp, _, path = viterbi_struct_batch(stacked, seqs, lengths,
                                         suffix_lasts, return_path=True)
    n = stacked_meta[0].shape[1]
    off = torch.arange(G, device=path.device)[:, None, None] * n
    out = analytics_from_path(
        tuple(x.reshape(-1) for x in stacked_meta), logp.reshape(-1),
        (path + off).reshape(G * B, L), seqs.reshape(G * B, L),
        lengths.reshape(-1))
    out = {k: v.reshape(G, B) for k, v in out.items()}
    if return_path:
        out["path"] = path
    return out


# the dense fallback forms one (rows, n, n) float32 temporary a column;
# rows are scored in chunks that keep it under this many bytes
# (the whole batch at once would be 4 B n^2: 1.8 GB at B 512, n 927)
DENSE_CHUNK_BYTES = 1 << 29


@dataclasses.dataclass
class DenseModel:
    """The dense tables of a compiled artifact on a device
    (device_analytics.py:27-55): the eliminated transitions (n, n), the
    emissions (n, 4), start and end (n,), -inf cleaned to NEG32, and the
    (kind, region, exp_base, unit) vectors the analytics read."""
    log_T: torch.Tensor
    log_E: torch.Tensor
    log_start: torch.Tensor
    log_end: torch.Tensor
    kind: torch.Tensor
    region: torch.Tensor
    exp_base: torch.Tensor
    unit: torch.Tensor

    @classmethod
    def from_artifact(cls, art, device) -> "DenseModel":
        tables = prepare_model_tensors(art, device)
        meta = (torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)
                for x in (art.kind, art.region, art.exp_base, art.unit))
        return cls(*tables, *meta)

    @property
    def meta(self):
        return (self.kind, self.region, self.exp_base, self.unit)

    @property
    def n_states(self) -> int:
        return self.log_T.shape[0]


def read_stats_dense(model: DenseModel, seqs, lengths,
                     return_path: bool = False,
                     chunk_bytes: int = DENSE_CHUNK_BYTES) -> dict:
    """Dense Viterbi + analytics for one locus (device_analytics.py:57-74):
    ``viterbi_batch`` (the reference's tie rule: the first maximum wins
    the traceback's argmax) and ``analytics_from_path``, on the model's
    device, the rows taken in chunks of at most
    ``chunk_bytes // (4 n^2)``.  Each read's values are its own, so the
    chunking changes none of them."""
    n = model.n_states
    rows = max(1, chunk_bytes // (4 * n * n))
    tables = (model.log_T, model.log_E, model.log_start, model.log_end)
    parts = []
    for b0 in range(0, seqs.shape[0], rows):
        s, ln = seqs[b0:b0 + rows], lengths[b0:b0 + rows]
        logp, _, path = viterbi_batch(*tables, s, ln, return_path=True)
        parts.append(analytics_from_path(model.meta, logp, path, s, ln,
                                         return_path=return_path))
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def flank_rates(stats: dict, accuracy_filter: bool = False) -> np.ndarray:
    """min(left, right) flank matching rate per read, on the host
    (reference semantics hmm_utils.py:257-268): an absent flank counts as
    1.0, or as epsilon under the accuracy filter."""
    lb = np.asarray(stats["left_flank_bp"], dtype=np.float64)
    rb = np.asarray(stats["right_flank_bp"], dtype=np.float64)
    lm = np.asarray(stats["left_flank_matches"], dtype=np.float64)
    rm = np.asarray(stats["right_flank_matches"], dtype=np.float64)
    default = 0.00001 if accuracy_filter else 1.0
    with np.errstate(invalid="ignore", divide="ignore"):
        lr = np.where(lb > 0, lm / np.maximum(lb, 1), default)
        rr = np.where(rb > 0, rm / np.maximum(rb, 1), default)
    return np.minimum(lr, rr)


def analytics_from_path(meta, logp, path, seqs, lengths,
                        return_path: bool = False) -> dict:
    """Per-read statistics from a decoded artifact-space path (B, L) and
    the artifact's (kind, region, exp_base, unit) vectors: the plain walk
    of device_analytics.py:77-194."""
    kind, region, exp_base, unit = (x.long() for x in meta)
    path = path.long()
    seqs = seqs.long()
    lengths = lengths.long()
    B, L = seqs.shape
    tpos = torch.arange(L, device=seqs.device)[None, :]
    valid = tpos < lengths[:, None]
    p_kind, p_region, p_exp, p_unit = (kind[path], region[path],
                                       exp_base[path], unit[path])
    is_m = (p_kind == K_MATCH) & valid
    base_match = (p_exp == seqs) & is_m
    cnt = lambda mask: mask.sum(dim=1).to(torch.int32)

    r_i, r_j = p_region[:, :-1], p_region[:, 1:]
    u_i, u_j = p_unit[:, :-1], p_unit[:, 1:]
    base = torch.where(r_i == R_REPEAT, u_i, -1)
    starts_rep = u_j - base
    ends_rep = starts_rep - (r_i == R_SUFFIX).long()
    pre_from_suf = ((r_j == R_PREFIX) & (r_i == R_SUFFIX)).long()
    hop_us_t = torch.where(r_j == R_REPEAT, starts_rep, pre_from_suf)
    hop_ue_t = torch.where(
        r_j == R_REPEAT, ends_rep,
        ((r_j == R_PREFIX) & ((r_i == R_REPEAT) | (r_i == R_SUFFIX))).long())
    # start hop: direct entry to a unit-0 match is crossing-free
    j0_rep = p_region[:, 0] == R_REPEAT
    j0_u0m = j0_rep & (p_unit[:, 0] == 0) & (p_kind[:, 0] == K_MATCH)
    j0_pre = (p_region[:, 0] == R_PREFIX).long()
    s_us = torch.where(j0_rep & ~j0_u0m, p_unit[:, 0] + 1, j0_pre)
    s_ue = torch.where(j0_rep & ~j0_u0m, p_unit[:, 0], j0_pre)
    hop_us = torch.cat([s_us[:, None], hop_us_t.clamp(min=0)], dim=1)
    hop_ue = torch.cat([s_ue[:, None], hop_ue_t.clamp(min=0)], dim=1)
    hop_us = torch.where(valid, hop_us, 0)
    hop_ue = torch.where(valid, hop_ue, 0)
    # end hop at bp = length
    last = (lengths - 1)[:, None]
    li_region = torch.gather(p_region, 1, last)[:, 0]
    li_kind = torch.gather(p_kind, 1, last)[:, 0]
    end_ue = ((li_region == R_SUFFIX) |
              ((li_region == R_REPEAT) & (li_kind != K_MATCH))).long()

    cs = torch.where(lengths[:, None] - tpos >= MIN_BP_IN_REPEAT, hop_us, 0)
    ce = torch.where(tpos >= MIN_BP_IN_REPEAT, hop_ue, 0)
    end_guard_end = torch.where(lengths >= MIN_BP_IN_REPEAT, end_ue, 0)
    starts = cs.sum(dim=1)
    ends = ce.sum(dim=1) + end_guard_end

    BIG = vf.BIG
    hp = tpos.expand_as(cs)
    first_start = torch.where(cs > 0, hp, BIG).min(dim=1).values
    last_start = torch.where(cs > 0, hp, -BIG).max(dim=1).values
    first_end = torch.where(ce > 0, hp, BIG).min(dim=1).values
    last_end = torch.where(ce > 0, hp, -BIG).max(dim=1).values
    first_end = torch.where((end_guard_end > 0) & (first_end == BIG),
                            lengths, first_end)
    last_end = torch.where(end_guard_end > 0, lengths, last_end)
    have_all = ((first_start != BIG) & (last_start != -BIG) &
                (first_end != BIG) & (last_end != -BIG))
    delta = (have_all & (first_end < first_start) &
             (last_start > last_end)).long()
    out = {
        "logp": logp,
        "repeats": (torch.maximum(starts, ends) + delta).to(torch.int32),
        "n_matches": cnt(is_m),
        "repeat_bp": cnt((p_region == R_REPEAT) & valid),
        "left_flank_bp": cnt((p_region == R_SUFFIX) & valid),
        "right_flank_bp": cnt((p_region == R_PREFIX) & valid),
        "left_flank_matches": cnt(base_match & (p_region == R_SUFFIX)),
        "right_flank_matches": cnt(base_match & (p_region == R_PREFIX)),
    }
    if return_path:
        out["path"] = path
    return out
