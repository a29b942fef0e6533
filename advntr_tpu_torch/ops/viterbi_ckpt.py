"""Checkpointed (recompute) Viterbi traceback for long lattices.

Counterpart of advntr_tpu/ops/viterbi_ckpt.py:69-157.  Whole origin planes
hold one code per column, read and state: (L, B, 2P + 2nb).  At long-read
scale (L of several thousand columns, P of several thousand positions) they
outgrow the device, so the read is decoded in two passes over segments of
K columns:

1. forward, B1 over each segment without planes, keeping only the DP state
   in which each segment is entered; the best score and the end state come
   from the last segment's exit state;
2. backward over the segments in reverse: B1 again from the kept entry
   state, this time with the K columns' origin planes, then B2 over that
   range from the state the walk stood in above it, keeping its slice of
   the path.

The largest live tensors are one segment's planes, O(K B P), and the
ceil(L / K) entry states, O(L / K B P); nothing the size of (L, B, P) is
ever allocated.  Forward work doubles.

Two decoders are segmented so:

- ``viterbi_checkpointed`` (B1 and B2): B1 records every argmax's origin
  as it goes, so pass 2 walks origin planes, as the whole-read path does.
  Both passes run the same kernels (or, for CPU tensors, the same plain
  twins) as the whole-read path, a segment being a launch with an entry
  state and a first column;
- ``viterbi_struct_checkpointed`` (the structured decoder of
  ops/viterbi_struct.py, the reference's own segmentation,
  viterbi_ckpt.py:69-157): the entry state is the (M, I, I0, D, hub,
  best) carry, pass 2 keeps the segment's value planes and re-derives
  each argmax through the dense (S, S) in-edge table; the emissions of
  each column are gathered inside the column.

Either way score, end state and path are its whole-read path's bit for
bit.
"""

from __future__ import annotations

import torch

from advntr_tpu_torch.ops import viterbi_fused as vf
from advntr_tpu_torch.ops import viterbi_struct as vs
from advntr_tpu_torch.ops.struct_model import (StructModelStack,
                                               TorchStructModel)


def viterbi_checkpointed_grouped(s: StructModelStack, seqs, lengths,
                                 segment: int = 512,
                                 return_path: bool = True,
                                 origin32: bool = False):
    """Two-pass Viterbi for G loci, seqs (G, B, L) and lengths (G, B):
    best (G, B), bstate (G, B) and the struct-space path (G, B, L), which
    is None (pass 2 never runs) unless ``return_path``."""
    G, B, L = seqs.shape
    K = max(1, min(int(segment), L))
    bounds = [(c0, min(c0 + K, L)) for c0 in range(0, L, K)]

    # ---- pass 1: forward, keeping each segment's entry state -------------
    entries = []
    state = None
    best = bstate = None
    for c0, c1 in bounds:
        entries.append(state)
        best, bstate, _, _, state = vf.fused_forward_segment_grouped(
            s, seqs[..., c0:c1], lengths, origin32, state, c0, planes=False)
    if not return_path:
        return best, bstate, None

    # ---- pass 2: segments in reverse: planes again, then the walk --------
    path = torch.empty(G, B, L, dtype=torch.int32, device=seqs.device)
    cur = bstate
    for (c0, c1), entry in zip(reversed(bounds), reversed(entries)):
        _, _, oMI, oXH, _ = vf.fused_forward_segment_grouped(
            s, seqs[..., c0:c1], lengths, origin32, entry, c0, planes=True)
        path[..., c0:c1], cur = vf.backward_walk_segment_grouped(
            s, lengths, bstate, oMI, oXH, c0, cur)
        del oMI, oXH
    return best, bstate, path


def viterbi_checkpointed(m: TorchStructModel, seqs, lengths,
                         segment: int = 512, return_path: bool = True,
                         origin32: bool = False):
    """Two-pass Viterbi for one locus, seqs (B, L): (best (B,), end state
    (B,), path (B, L) or None), states in artifact space, the contract of
    ``viterbi_fused.viterbi_batch``."""
    vf._check_inputs(m, seqs, lengths)
    best, bstate, path_s = viterbi_checkpointed_grouped(
        m.as_stack(), seqs[None], lengths[None], segment, return_path,
        origin32)
    end_state = m.struct_to_art[bstate[0].long()]
    if not return_path:
        return best[0], end_state, None
    return best[0], end_state, m.struct_to_art[path_s[0].long()]


def viterbi_struct_checkpointed(m: vs.StructDeviceModel, seqs, lengths,
                                suffix_last, return_path: bool = True,
                                segment: int = 512):
    """Two-pass structured Viterbi: the contract of
    ``viterbi_struct.viterbi_struct_batch`` (one locus or a stacked
    group), with the planes of one segment of ``segment`` columns alive at
    a time instead of the whole read's."""
    m, seqs, lengths, grouped = vs.grouped_inputs(m, seqs, lengths,
                                                  suffix_last)
    G, B, L = seqs.shape
    cols = vs.columns(m, seqs, suffix_last if grouped else [suffix_last])
    carry = vs.initial_column(cols)
    K = max(1, min(int(segment), L - 1))
    bounds = [(t0, min(t0 + K, L)) for t0 in range(1, L, K)]

    # ---- pass 1: forward, keeping each segment's entry carry -------------
    entries = []
    for t0, t1 in bounds:
        entries.append(carry)
        carry = vs.run_columns(cols, lengths, carry, t0, t1)
    best = carry[5]
    if not return_path:
        return (best if grouped else best[0]), None, None

    # ---- pass 2: segments in reverse: planes again, then the walk --------
    end_s = vs.end_states(cols, carry)
    path_s = torch.empty(G, B, L, dtype=torch.long, device=seqs.device)
    cur = end_s
    if bounds:
        planes = torch.empty(K, G, B, m.log_end_struct.shape[1],
                             dtype=torch.float32, device=seqs.device)
    for (t0, t1), entry in zip(reversed(bounds), reversed(entries)):
        seg = planes[:t1 - t0]
        vs.run_columns(cols, lengths, entry, t0, t1, seg)
        cur = vs.walk_back(cols, lengths, seg, t0, t1, cur, path_s)
    path_s[..., 0] = cur
    end_state, path = vs.to_artifact(cols, lengths, end_s, path_s)
    if grouped:
        return best, end_state, path
    return best[0], end_state[0], path[0]
