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

Where the reference re-derives each argmax of pass 2 from value planes
through a dense (S, S) transition table, B1 records every argmax's origin
as it goes, so the port has no such table: pass 2 walks origin planes, as
the whole-read path does.  Both passes run the same kernels (or, for CPU
tensors, the same plain twins) as the whole-read path, a segment being a
launch with an entry state and a first column, so score, end state and
path are the whole-read path's bit for bit.
"""

from __future__ import annotations

import torch

from advntr_tpu_torch.ops import viterbi_fused as vf
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
