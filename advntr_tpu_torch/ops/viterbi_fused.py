"""Structured Viterbi with inline provenance and per-read analytics.

Counterpart of advntr_tpu/ops/pallas_viterbi.py:507-918.  Two kernels
carry it, both hand-written CUDA C++ (``csrc/``):

- ``fused_forward`` (B1): the Viterbi forward over the silent-eliminated
  structured profile HMM.  Every max carries its argmax origin, and the
  first candidate wins ties.  It returns the best score and end state per
  read and two origin planes, (L, B, 2P) for M|I with the base-match bit
  packed on the M half, and (L, B, 2nb) holding the I0 origins and the
  previous column's resolved hub origins.
- ``backward_stats`` (B2): walks each read back from its end state through
  the planes, accumulates the genotyping statistics on the way (reference
  hmm_utils.py:155-286 semantics) and, when asked, writes the struct-space
  path.  The kernel walks a window of columns a memory trip: it assumes
  the path runs down the diagonal (M_p at column t comes from M_p-1 at
  t-1), loads the window's origin codes side by side and keeps the columns
  the codes confirm.  ``backward_stats_windowed_reference`` is that scheme
  in plain PyTorch, for the tests and the smoke run.

Both kernels take G same-shape loci in one launch (``*_grouped``, on a
``StructModelStack``); the per-locus calls are the G = 1 case of the same
path.  Each has a plain PyTorch twin in this module (``*_reference``); the
grouped twin is the per-locus twin looped.  The wrapper runs the twin for
CPU tensors only; for CUDA tensors it launches the kernel or raises.  The
twins follow the reference's arithmetic step by step (the same float32
adds in the same order, strict ``>`` picks, shifts that wrap exactly like
the reference's lane rolls), so their results are the reference kernel's
results.

Origin codes live in struct space: M_p = p, I_p = P+p, I0_b = 2P+b, and
the hub sentinel 2P+nb+b stands for "the hub of block b one column back".
Planes store code + 1, so the first column's -1 lands on 0.
"""

from __future__ import annotations

import torch

from advntr_tpu_torch.models.graph import R_PREFIX, R_REPEAT, R_SUFFIX
from advntr_tpu_torch.ops import _kernels
from advntr_tpu_torch.ops.struct_model import (
    LN05, MBIT16, MBIT32, NEG, StructModelStack, TorchStructModel,
    origin_params)

BIG = 1 << 30
MIN_BP_IN_REPEAT = 3  # reference: hmm_utils.py:165
# whole origin planes are built for reads up to this many columns; longer
# ones take the checkpointed traceback (ops/viterbi_ckpt.py), as in the
# reference (finder.py:96)
MAX_COLUMNS = 2048

# columns of the (B, N_STATS) int32 statistics from the backward walk
(S_NMATCH, S_REPBP, S_LBP, S_RBP, S_LMATCH, S_RMATCH,
 S_STARTS, S_ENDS, S_FS, S_LS, S_FE, S_LE) = range(12)
N_STATS = 16

STAT_KEYS = ("repeats", "n_matches", "repeat_bp", "left_flank_bp",
             "right_flank_bp", "left_flank_matches", "right_flank_matches")


def _pick(v1, o1, v2, o2):
    """Tropical (max, argmax-origin) combine; the first argument wins ties."""
    take2 = v2 > v1
    return torch.where(take2, v2, v1), torch.where(take2, o2, o1)


def _max_first_idx(v):
    """(max, index of the first max) along axis 1, keepdim."""
    mx = v.max(dim=1, keepdim=True).values
    ii = torch.arange(v.shape[1], device=v.device).expand_as(v)
    idx = torch.where(v == mx, ii, v.shape[1]).min(dim=1, keepdim=True).values
    return mx, idx


def _check_inputs(m: TorchStructModel, seqs, lengths):
    if seqs.dim() != 2 or lengths.shape != (seqs.shape[0],):
        raise ValueError(f"seqs must be (B, L) and lengths (B,); got "
                         f"{tuple(seqs.shape)} and {tuple(lengths.shape)}")
    if seqs.device != m.device or lengths.device != m.device:
        raise ValueError(f"inputs on {seqs.device}/{lengths.device}, model "
                         f"on {m.device}")


def initial_forward_state(m: TorchStructModel, B: int, device=None):
    """The DP state before a read's first column, as B1 carries it from
    one column to the next: (floats (B, 3P + 2nb) holding M|I, D, I0 and
    hub, ints (B, P + nb) holding the origins Do and hubpo)."""
    dev = m.device if device is None else device
    return (torch.full((B, 3 * m.P + 2 * m.nb), float(NEG),
                       dtype=torch.float32, device=dev),
            torch.zeros(B, m.P + m.nb, dtype=torch.int32, device=dev))


def forward_state_best(m: TorchStructModel, state):
    """(best (B,) f32, bstate (B,) int32) of reads standing in ``state``:
    the first maximum over the end weights of M|I and I0."""
    P, nb = m.P, m.nb
    fs = state[0]
    LE = torch.cat([m.row("le_M"), m.row("le_I")])
    fin = torch.cat([fs[:, :2 * P] + LE,
                     fs[:, 3 * P:3 * P + nb] + m.row("le_I0")], dim=1)
    best, bstate = _max_first_idx(fin)
    return best[:, 0], bstate[:, 0].to(torch.int32)


def fused_forward_reference(m: TorchStructModel, seqs, lengths,
                            origin32: bool = False):
    """Plain twin of B1 (pallas_viterbi.py:305-504, one column per step).

    seqs (B, L) integer bases, clipped to 0..3; lengths (B,).  Returns
    (best (B,) f32, bstate (B,) int32, oMI (L, B, 2P), oXH (L, B, 2nb)).
    The whole read is the one-segment case of
    ``fused_forward_segment_reference``."""
    state, oMI, oXH = fused_forward_segment_reference(m, seqs, lengths,
                                                      origin32)
    best, bstate = forward_state_best(m, state)
    return best, bstate, oMI, oXH


def fused_forward_segment_reference(m: TorchStructModel, seqs, lengths,
                                    origin32: bool = False, state=None,
                                    t0: int = 0, planes: bool = True):
    """The columns t0 .. t0 + L - 1 of B1's twin: seqs (B, L) holds those
    columns' bases, ``lengths`` the whole reads' lengths, ``state`` the DP
    state in which the reads stand after column t0 - 1 (None before column
    0).  Returns (state after the last column, oMI (L, B, 2P), oXH
    (L, B, 2nb)); the planes are None and never built unless ``planes``.

    The state is the column loop's own: the float values of M|I, D, I0 and
    hub, and the origins Do and hubpo.  The origins belong to it because a
    hub sentinel in column t is resolved through the hub origins that
    column t writes from the state it entered with."""
    B, L = seqs.shape
    P, nb, C = m.P, m.nb, m.C
    dev = seqs.device
    odt, mbit = origin_params(P, nb, origin32)
    i32 = torch.int32
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    neg, ln05, r_unit = f32(NEG), f32(LN05), f32(m.r_unit)
    seqs = seqs.long().clamp(0, 3)
    lengths = lengths.to(i32)
    row = m.row

    idxM = torch.arange(P, dtype=i32, device=dev)
    idxI = idxM + P
    blk = m.blk_idx.long()
    blkid = m.blk_idx + 2 * P                       # I0 code of p's block
    hubsent_p = blkid + nb                          # hub sentinel of p's block
    idxI0 = torch.arange(nb, dtype=i32, device=dev) + 2 * P
    hubsent_b = idxI0 + nb
    ORIG_A = torch.cat([idxM - 1, idxM])
    ORIG_B = torch.cat([idxI - 1, idxI])
    W_A = torch.cat([row("a_mm"), row("mi")])
    W_B = torch.cat([row("a_im"), row("ii")])
    W_C = torch.cat([row("a_dm"), row("di")])
    W_D = torch.cat([row("md"), row("idw")])
    START = torch.cat([row("M_start"), row("I_start")])
    eMT, eIT, eI0T = m.eM.T, m.eI.T, m.eI0.T
    exp_base = m.exp_base.long()
    unit_last = m.unit_last.long()
    ccol = torch.arange(C, device=dev)
    negP = neg.expand(B, P)

    if state is None:
        state = initial_forward_state(m, B, dev)
    fs, is_ = state
    MI, D, I0, hub = (x.clone() for x in
                      fs.split([2 * P, P, nb, nb], dim=1))
    Do, hubpo = (x.clone() for x in is_.split([P, nb], dim=1))
    oMI = oXH = None
    if planes:
        oMI = torch.empty(L, B, 2 * P, dtype=odt, device=dev)
        oXH = torch.empty(L, B, 2 * nb, dtype=odt, device=dev)

    for t in range(L):
        base = seqs[:, t]
        eMI = torch.cat([eMT[base], eIT[base]], dim=1)
        eI0 = eI0T[base]
        act = (t0 + t < lengths)[:, None]

        # ---- emitting layer: sources from the previous column ----
        v5, o5 = _pick(hub[:, blk] + row("ent_m"), hubsent_p.expand(B, P),
                       I0[:, blk] + row("i0_m"), blkid.expand(B, P))
        rollMI = torch.roll(MI, 1, dims=1)
        candA = torch.cat([rollMI[:, :P], MI[:, :P]], dim=1) + W_A
        candB = torch.cat([rollMI[:, P:], MI[:, P:]], dim=1) + W_B
        candC = torch.cat([torch.roll(D, 1, dims=1), D], dim=1) + W_C
        origC = torch.cat([torch.roll(Do, 1, dims=1), Do], dim=1)
        v, o = _pick(candA, ORIG_A.expand(B, -1), candB, ORIG_B.expand(B, -1))
        v, o = _pick(v, o, candC, origC)
        v, o = _pick(v, o, torch.cat([v5, negP], dim=1),
                     torch.cat([o5, o5], dim=1))
        MIn, OMIn = eMI + v, o
        v0, o0 = _pick(I0 + row("i0_i"), idxI0.expand(B, nb),
                       hub + row("hub_i0"), hubsent_b.expand(B, nb))
        I0n, OI0n = eI0 + v0, o0
        if t0 + t == 0:
            MIn = START + eMI
            I0n = row("I0_start") + eI0
            OMIn = torch.full_like(OMIn, -1)
            OI0n = torch.full_like(OI0n, -1)
        MIn = torch.where(act, MIn, MI)           # length freeze
        I0n = torch.where(act, I0n, I0)

        # ---- silent layer: delete chain, unit chain, hubs ----
        bcand = torch.roll(MIn, 1, dims=1) + W_D
        bv, bo = _pick(bcand[:, :P], (idxM - 1).expand(B, P),
                       bcand[:, P:], (idxI - 1).expand(B, P))
        Din, Dino = _pick(bv, bo, I0n[:, blk] + row("i0_d"),
                          blkid.expand(B, P))
        for r in range(m.Wd.shape[0]):
            k = 1 << r
            if k >= P:
                break
            rv = torch.roll(Din, k, dims=1) + m.Wd[r]
            ro = torch.roll(Dino, k, dims=1)
            take = rv > Din
            Din = torch.where(take, rv, Din)
            Dino = torch.where(take, ro, Dino)
        qv, qo = _pick(MIn[:, :P] + row("xm"), idxM.expand(B, P),
                       MIn[:, P:] + row("xi"), idxI.expand(B, P))
        qv, qo = _pick(qv, qo, Din + row("xd"), Dino)
        q, qorig = qv[:, unit_last], qo[:, unit_last]
        if m.suffix_last >= 0:
            sufq = qv[:, m.suffix_last:m.suffix_last + 1]
            sufqo = qo[:, m.suffix_last:m.suffix_last + 1]
        else:                                     # empty extraction column
            sufq = torch.zeros(B, 1, device=dev)
            sufqo = torch.zeros(B, 1, dtype=i32, device=dev)
        us = torch.where(ccol == 0, sufq, torch.roll(q, 1, dims=1) + ln05)
        uso = torch.where(ccol == 0, sufqo, torch.roll(qorig, 1, dims=1))
        for r in range(m.Wu.shape[0]):
            k = 1 << r
            if k >= C:
                break
            us, uso = _pick(us, uso, torch.roll(us, k, dims=1) + m.Wu[r],
                            torch.roll(uso, k, dims=1))
        uev, ueo = _pick(q, qorig, us + r_unit, uso)
        pstart, ci = _max_first_idx(uev + ln05)
        pstarto = torch.gather(ueo, 1, ci)
        n_pre = nb - 1 - C
        hubn = torch.cat([neg.expand(B, 1), us, pstart.expand(B, n_pre)], 1)
        hubon = torch.cat([torch.full((B, 1), -1, dtype=i32, device=dev),
                           uso, pstarto.expand(B, n_pre)], dim=1)
        Dn, Don = _pick(Din, Dino, hubn[:, blk] + row("hub_d"),
                        hubsent_p.expand(B, P))

        # ---- plane writes and state commit ----
        if planes:
            match = (base[:, None] == exp_base).to(i32) * mbit
            oMI[t] = (OMIn + 1 + torch.cat([match, torch.zeros_like(match)],
                                           dim=1)).to(odt)
            oXH[t] = (torch.cat([OI0n, hubpo], dim=1) + 1).to(odt)
        MI, I0 = MIn, I0n
        D = torch.where(act, Dn, D)
        Do = torch.where(act, Don, Do)
        hub = torch.where(act, hubn, hub)
        hubpo = torch.where(act, hubon, hubpo)

    return (torch.cat([MI, D, I0, hub], dim=1),
            torch.cat([Do, hubpo], dim=1)), oMI, oXH


def _take_or(table, idx, fill):
    """table[idx] where 0 <= idx < len(table), else ``fill`` (what the
    reference's masked row-sum yields for an index outside the row)."""
    ok = (idx >= 0) & (idx < table.shape[0])
    return torch.where(ok, table[idx.clamp(0, table.shape[0] - 1)], fill)


def backward_stats_reference(m: TorchStructModel, lengths, bstate, oMI, oXH):
    """Plain twin of B2 (pallas_viterbi.py:580-733), one gather per read
    per column.  Returns (path (B, L) int32 struct indices, stats
    (B, N_STATS) int32).  The whole read is the one-segment case of
    ``backward_walk_segment_reference``."""
    path, stats, _ = backward_walk_segment_reference(m, lengths, bstate,
                                                     oMI, oXH)
    return path, stats


def backward_walk_segment_reference(m: TorchStructModel, lengths, bstate,
                                    oMI, oXH, t0: int = 0, entry=None):
    """The walk of B2's twin over the columns t0 .. t0 + L - 1, whose
    planes are oMI, oXH (L, B, ...): ``lengths`` and ``bstate`` are the
    whole reads', ``entry`` (B,) the state in which each read stands at
    column t0 + L - 1 (what the walk over the columns above returned; None
    where the range holds every read's last column).  A read whose last
    column lies before the range does nothing in it; one whose last column
    lies in it starts from ``bstate``.  Returns (path (B, L) of these
    columns, stats, the state each read stands in above column t0, that
    is at column t0 - 1).  The statistics count these columns alone: they
    are a read's statistics only where the range is the whole read."""
    L, B, P2 = oMI.shape
    P, nb = P2 // 2, oXH.shape[2] // 2
    mbit = MBIT32 if oMI.dtype == torch.int32 else MBIT16
    dev = oMI.device
    lengths = lengths.long()
    rows = torch.arange(B, device=dev)
    z = torch.zeros(B, dtype=torch.long, device=dev)
    cur = (bstate if entry is None else entry).long()
    rnext, unext = z.clone(), z.clone()
    nm, repbp, lbp, rbp, lmt, rmt, starts, ends = (z.clone() for _ in range(8))
    fs, ls = z + BIG, z - BIG
    fe, le = z + BIG, z - BIG
    path = torch.empty(B, L, dtype=torch.int32, device=dev)

    def lookup(plane, idx):
        ok = (idx >= 0) & (idx < plane.shape[1])
        return torch.where(
            ok, plane[rows, idx.clamp(0, plane.shape[1] - 1)].long(), 0)

    for t in range(t0 + L - 1, t0 - 1, -1):
        pMI, pXH = oMI[t - t0], oXH[t - t0]
        path[:, t - t0] = cur.to(torch.int32)
        sel = torch.where(cur < 2 * P, lookup(pMI, cur),
                          lookup(pXH, cur - 2 * P))
        m_bit = sel >= mbit
        prev = (sel & (mbit - 1)) - 1
        selH = lookup(pXH, prev - 2 * P) - 1
        prev = torch.where(prev >= 2 * P + nb, selH, prev)
        region = _take_or(m.region, cur, 0).long()
        unit = _take_or(m.unit, cur, -1).long()

        valid = t < lengths
        is_m = (cur < P) & valid
        in_suf, in_rep, in_pre = (region == R_SUFFIX, region == R_REPEAT,
                                  region == R_PREFIX)
        nm += is_m
        repbp += in_rep & valid
        lbp += in_suf & valid
        rbp += in_pre & valid
        bm = is_m & m_bit
        lmt += bm & in_suf
        rmt += bm & in_pre

        # end hop (bp = length, applied at column length-1)
        egg = (t == lengths - 1) & (lengths >= MIN_BP_IN_REPEAT) & \
            ((in_rep & (cur >= P)) | in_suf)
        ends += egg
        fe = torch.minimum(fe, torch.where(egg, lengths, BIG))
        le = torch.maximum(le, torch.where(egg, lengths, -BIG))

        # hop h = t+1 (path[t] -> path[t+1])
        h = t + 1
        base = torch.where(in_rep, unit, -1)
        sr = unext - base
        er = sr - in_suf.long()
        nrep, npre = rnext == R_REPEAT, rnext == R_PREFIX
        hop_us = torch.where(nrep, sr, (npre & in_suf).long()).clamp(min=0)
        hop_ue = torch.where(nrep, er,
                             (npre & (in_rep | in_suf)).long()).clamp(min=0)
        hop_ok = h < lengths
        cs = torch.where(hop_ok & (lengths - h >= MIN_BP_IN_REPEAT), hop_us, 0)
        ce = torch.where(hop_ok & (h >= MIN_BP_IN_REPEAT), hop_ue, 0)
        starts += cs
        ends += ce
        fs = torch.minimum(fs, torch.where(cs > 0, h, BIG))
        ls = torch.maximum(ls, torch.where(cs > 0, h, -BIG))
        fe = torch.minimum(fe, torch.where(ce > 0, h, BIG))
        le = torch.maximum(le, torch.where(ce > 0, h, -BIG))

        # start hop (hop 0, at column 0): only the starts side contributes
        if t == 0:
            j0u0m = in_rep & (unit == 0) & (cur < P)
            s_us = torch.where(in_rep & ~j0u0m, unit + 1, in_pre.long())
            cs0 = torch.where(lengths >= MIN_BP_IN_REPEAT, s_us, 0)
            starts += cs0
            fs = torch.minimum(fs, torch.where(cs0 > 0, 0, BIG))
            ls = torch.maximum(ls, torch.where(cs0 > 0, 0, -BIG))

        rnext, unext = region, unit
        cur = torch.where((t <= lengths - 1) & (t >= 1), prev, cur)

    stats = torch.stack([nm, repbp, lbp, rbp, lmt, rmt, starts, ends,
                         fs, ls, fe, le] + [z] * (N_STATS - 12), dim=1)
    return path, stats.to(torch.int32), cur.to(torch.int32)


def backward_stats_windowed_reference(m: TorchStructModel, lengths, bstate,
                                      oMI, oXH, window: int = 32,
                                      return_path: bool = True):
    """The window scheme of the B2 kernel in plain PyTorch: the results of
    ``backward_stats_reference``, reached a window of columns at a time.

    From state ``cur`` at column ``t``, lane i of a window assumes a state
    at column ``t - i`` (while the column exists): ``cur - i`` where
    ``cur`` is a match state, the diagonal of a read that follows the
    model, and ``cur`` itself where it is an insert state, the self-loop
    in which a read that does not fit the model (a wrong-strand candidate)
    spends its columns.  Each lane looks its origin up exactly as the
    column-by-column walk does, and holds a true column of the path if
    every lane before it found the next lane's assumed state.  The true lanes add their
    columns' statistics; the first lane that disagrees gives the state the
    next window starts from.  A window holds at least one true column, so
    the result never depends on the guess.  Returns (path (B, L) or None,
    stats (B, N_STATS))."""
    path, stats, _ = _windowed_walk(m, lengths, bstate, oMI, oXH, window,
                                    return_path)
    return path, stats


def _windowed_walk(m, lengths, bstate, oMI, oXH, window, return_path):
    """backward_stats_windowed_reference, with the windows each read took
    as a third result."""
    return windowed_walk_segment(m, lengths, bstate, oMI, oXH, window,
                                 return_path)[:3]


def windowed_walk_segment(m, lengths, bstate, oMI, oXH, window,
                          return_path, t0: int = 0, entry=None):
    """The window scheme over the columns t0 .. t0 + L - 1, with the
    arguments of ``backward_walk_segment_reference``: a window ends at the
    range's first column, as it ends at column 0 of a whole read.  Returns
    (path or None, stats, windows each read took in the range, state
    above column t0)."""
    L, B, P2 = oMI.shape
    P, nb = P2 // 2, oXH.shape[2] // 2
    mbit = MBIT32 if oMI.dtype == torch.int32 else MBIT16
    dev = oMI.device
    W = int(window)
    if W < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    lengths = lengths.long()
    n = lengths[:, None]
    lane = torch.arange(W, device=dev)[None, :]
    rows = torch.arange(B, device=dev)[:, None]
    z = torch.zeros(B, dtype=torch.long, device=dev)
    cur = (bstate if entry is None else entry).long()
    # columns at and past a read's end hold its end state and count nothing
    t = lengths.clamp(max=t0 + L) - 1
    rnext, unext = z.clone(), z.clone()
    nm, repbp, lbp, rbp, lmt, rmt, starts, ends = (z.clone() for _ in range(8))
    fs, ls = z + BIG, z - BIG
    fe, le = z + BIG, z - BIG
    n_windows = z.clone()
    path = None
    if return_path:
        path = bstate.to(torch.int32)[:, None].repeat(1, L)

    def lookup(plane, col, idx):
        ok = (idx >= 0) & (idx < plane.shape[2])
        return torch.where(
            ok, plane[col - t0, rows,
                      idx.clamp(0, plane.shape[2] - 1)].long(), 0)

    def low(x, mask):
        return torch.where(mask, x, BIG).min(dim=1).values

    def high(x, mask):
        return torch.where(mask, x, -BIG).max(dim=1).values

    while bool((t >= t0).any()):
        live = (t >= t0)[:, None]
        col = t[:, None] - lane
        step = (cur < P).long()[:, None]
        s = cur[:, None] - lane * step
        in_model = ((cur >= 0) & (cur < m.region.shape[0]))[:, None]
        active = live & (col >= t0) & ((lane == 0) | (in_model & (s >= 0)))
        colc = col.clamp(min=t0)
        sel = torch.where(s < 2 * P, lookup(oMI, colc, s),
                          lookup(oXH, colc, s - 2 * P))
        m_bit = sel >= mbit
        prev = (sel & (mbit - 1)) - 1
        selH = lookup(oXH, colc, prev - 2 * P) - 1
        prev = torch.where(prev >= 2 * P + nb, selH, prev)
        # lane i confirms lane i+1 where the walk moves on from its column
        # to the state that lane assumed
        moves = (col <= n - 1) & (col >= 1)
        ok = active[:, 1:] & moves[:, :-1] & (prev[:, :-1] == s[:, 1:])
        true = active[:, :1] & torch.cat(
            [torch.ones_like(live), ok.cumprod(dim=1).bool()], dim=1)

        region = _take_or(m.region, s, 0).long()
        unit = _take_or(m.unit, s, -1).long()
        rn = torch.cat([rnext[:, None], region[:, :-1]], dim=1)
        un = torch.cat([unext[:, None], unit[:, :-1]], dim=1)
        cnt = lambda mask: (mask & true).sum(dim=1)

        valid = col < n
        is_m = (s < P) & valid
        in_suf, in_rep, in_pre = (region == R_SUFFIX, region == R_REPEAT,
                                  region == R_PREFIX)
        nm += cnt(is_m)
        repbp += cnt(in_rep & valid)
        lbp += cnt(in_suf & valid)
        rbp += cnt(in_pre & valid)
        bm = is_m & m_bit
        lmt += cnt(bm & in_suf)
        rmt += cnt(bm & in_pre)

        # end hop (bp = length, applied at column length-1)
        egg = true & (col == n - 1) & (n >= MIN_BP_IN_REPEAT) & \
            ((in_rep & (s >= P)) | in_suf)
        ends += egg.sum(dim=1)
        fe = torch.minimum(fe, low(n.expand_as(col), egg))
        le = torch.maximum(le, high(n.expand_as(col), egg))

        # hop h = col+1 (path[col] -> path[col+1])
        h = col + 1
        base = torch.where(in_rep, unit, -1)
        sr = un - base
        er = sr - in_suf.long()
        nrep, npre = rn == R_REPEAT, rn == R_PREFIX
        hop_us = torch.where(nrep, sr, (npre & in_suf).long()).clamp(min=0)
        hop_ue = torch.where(nrep, er,
                             (npre & (in_rep | in_suf)).long()).clamp(min=0)
        hop_ok = true & (h < n)
        cs = torch.where(hop_ok & (n - h >= MIN_BP_IN_REPEAT), hop_us, 0)
        ce = torch.where(hop_ok & (h >= MIN_BP_IN_REPEAT), hop_ue, 0)
        starts += cs.sum(dim=1)
        ends += ce.sum(dim=1)
        fs = torch.minimum(fs, low(h, cs > 0))
        ls = torch.maximum(ls, high(h, cs > 0))
        fe = torch.minimum(fe, low(h, ce > 0))
        le = torch.maximum(le, high(h, ce > 0))

        # start hop (hop 0, at column 0): only the starts side contributes
        j0u0m = in_rep & (unit == 0) & (s < P)
        s_us = torch.where(in_rep & ~j0u0m, unit + 1, in_pre.long())
        cs0 = torch.where(true & (col == 0) & (n >= MIN_BP_IN_REPEAT),
                          s_us, 0)
        starts += cs0.sum(dim=1)
        fs = torch.minimum(fs, low(torch.zeros_like(col), cs0 > 0))
        ls = torch.maximum(ls, high(torch.zeros_like(col), cs0 > 0))

        if return_path:
            path[rows.expand_as(col)[true], col[true] - t0] = \
                s[true].to(torch.int32)
        # the last true lane hands the walk on
        n_true = true.sum(dim=1)
        j = (n_true - 1).clamp(min=0)[:, None]
        step = live[:, 0]
        last = lambda x: torch.gather(x, 1, j)[:, 0]
        # (a walk that has reached column 0 stays in that column's state)
        cur = torch.where(step, torch.where(last(moves), last(prev),
                                            last(s)), cur)
        rnext = torch.where(step, last(region), rnext)
        unext = torch.where(step, last(unit), unext)
        t = t - n_true
        n_windows += step

    stats = torch.stack([nm, repbp, lbp, rbp, lmt, rmt, starts, ends,
                         fs, ls, fe, le] + [z] * (N_STATS - 12), dim=1)
    return path, stats.to(torch.int32), n_windows, cur.to(torch.int32)


def windows_from_path(path, lengths, P: int, n_struct: int,
                      window: int = 32):
    """Windows the window scheme takes per read, (B,), counted from the
    struct-space paths (B, L) alone: a run of columns down the diagonal of
    match states, or in one insert state, takes one window per ``window``
    columns, and every other column starts a new run."""
    B, L = path.shape
    path = path.long()
    n = lengths.long().clamp(min=0, max=L)[:, None]
    col = torch.arange(L, device=path.device)[None, :]
    # column c goes on the run of column c+1 (the walk runs downwards)
    upper, lower = path[:, 1:], path[:, :-1]
    joins = torch.where(upper < P, (upper >= 1) & (lower == upper - 1),
                        (upper < n_struct) & (lower == upper))
    joins = torch.cat([joins, torch.zeros_like(joins[:, :1])], dim=1)
    inside = col < n
    starts_run = inside & ~(joins & (col + 1 < n))
    # number the runs from each read's last column down
    run = starts_run.flip(1).cumsum(dim=1).flip(1) - 1
    flat = (torch.arange(B, device=path.device)[:, None] * L + run)[inside]
    sizes = torch.bincount(flat, minlength=B * L).reshape(B, L)
    return ((sizes + window - 1) // window).sum(dim=1)


def _check_group_inputs(s: StructModelStack, seqs, lengths):
    if seqs.dim() != 3 or seqs.shape[0] != s.G or \
            lengths.shape != seqs.shape[:2]:
        raise ValueError(f"seqs must be (G={s.G}, B, L) and lengths (G, B); "
                         f"got {tuple(seqs.shape)} and {tuple(lengths.shape)}")
    if seqs.device != s.device or lengths.device != s.device:
        raise ValueError(f"inputs on {seqs.device}/{lengths.device}, models "
                         f"on {s.device}")


def _loop_twin(twin, s: StructModelStack, *per_locus):
    """The grouped twin: the per-locus twin on each locus, stacked."""
    outs = [twin(m, *(x[g] for x in per_locus))
            for g, m in enumerate(s.models)]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def fused_forward_grouped(s: StructModelStack, seqs, lengths,
                          origin32: bool = False):
    """B1 for G loci, seqs (G, B, L) and lengths (G, B): one launch of the
    CUDA kernel for CUDA tensors, the looped twin for CPU ones.  Returns
    best (G, B), bstate (G, B), oMI (G, L, B, 2P), oXH (G, L, B, 2nb)."""
    _check_group_inputs(s, seqs, lengths)
    if seqs.is_cuda:
        return _kernels.forward(s, seqs, lengths, origin32)
    if seqs.device.type == "cpu":
        return fused_forward_grouped_reference(s, seqs, lengths, origin32)
    raise ValueError(f"no fused_forward for device {seqs.device}")


def fused_forward_grouped_reference(s: StructModelStack, seqs, lengths,
                                    origin32: bool = False):
    return _loop_twin(
        lambda m, q, n: fused_forward_reference(m, q, n, origin32),
        s, seqs, lengths)


def fused_forward_segment_grouped(s: StructModelStack, seqs, lengths,
                                  origin32: bool = False, state=None,
                                  t0: int = 0, planes: bool = True):
    """B1 over the columns t0 .. t0 + L - 1 of G loci: seqs (G, B, L) holds
    those columns, ``state`` (floats (G, B, 3P + 2nb), ints (G, B, P + nb))
    is where the reads stand after column t0 - 1, None before column 0.
    One launch of the CUDA kernel for CUDA tensors, the looped twin for
    CPU ones.  Returns (best (G, B), bstate (G, B), oMI, oXH, state after
    the last column); best and bstate are those of reads that end in this
    state, and the planes are None unless ``planes``."""
    _check_group_inputs(s, seqs, lengths)
    if seqs.is_cuda:
        return _kernels.forward_segment(s, seqs, lengths, origin32, state,
                                        t0, planes)
    if seqs.device.type != "cpu":
        raise ValueError(f"no fused_forward for device {seqs.device}")
    ends, planes_out, exits = [], [], []
    for g, m in enumerate(s.models):
        entry = None if state is None else (state[0][g], state[1][g])
        exit_, oMI, oXH = fused_forward_segment_reference(
            m, seqs[g], lengths[g], origin32, entry, t0, planes)
        ends.append(forward_state_best(m, exit_))
        planes_out.append((oMI, oXH))
        exits.append(exit_)
    stack = lambda rows: tuple(torch.stack(parts) for parts in zip(*rows))
    oMI, oXH = stack(planes_out) if planes else (None, None)
    return stack(ends) + (oMI, oXH, stack(exits))


def backward_walk_segment_grouped(s: StructModelStack, lengths, bstate,
                                  oMI, oXH, t0: int = 0, entry=None):
    """B2 over the columns t0 .. t0 + L - 1 of G loci on those columns'
    planes (G, L, B, ...), from ``entry`` (G, B), the state each read
    stands in at the range's last column (None: ``bstate``).  One launch
    of the CUDA kernel for CUDA tensors, the looped twin for CPU ones.
    Returns (path (G, B, L) of these columns, the state (G, B) above
    column t0)."""
    if entry is None:
        entry = bstate
    if oMI.is_cuda:
        return _kernels.backward_segment(s, lengths, bstate, oMI, oXH, t0,
                                         entry)
    if oMI.device.type != "cpu":
        raise ValueError(f"no backward walk for device {oMI.device}")
    outs = [backward_walk_segment_reference(
        m, lengths[g], bstate[g], oMI[g], oXH[g], t0, entry[g])
        for g, m in enumerate(s.models)]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[2] for o in outs]))


def backward_stats_grouped(s: StructModelStack, lengths, bstate, oMI, oXH,
                           return_path: bool = True):
    """B2 for G loci on planes (G, L, B, ...): one launch of the CUDA
    kernel for CUDA tensors, the looped twin for CPU ones.  Returns path
    (G, B, L), or None unless ``return_path``, and stats (G, B, N_STATS)."""
    if oMI.is_cuda:
        return _kernels.backward(s, lengths, bstate, oMI, oXH, return_path)
    if oMI.device.type == "cpu":
        return backward_stats_grouped_reference(s, lengths, bstate, oMI, oXH,
                                                return_path)
    raise ValueError(f"no backward_stats for device {oMI.device}")


def backward_stats_grouped_reference(s: StructModelStack, lengths, bstate,
                                     oMI, oXH, return_path: bool = True):
    path, stats = _loop_twin(backward_stats_reference, s, lengths, bstate,
                             oMI, oXH)
    return (path if return_path else None), stats


def fused_forward(m: TorchStructModel, seqs, lengths, origin32: bool = False):
    """B1 for one locus: the G = 1 case of ``fused_forward_grouped``."""
    _check_inputs(m, seqs, lengths)
    return tuple(x[0] for x in fused_forward_grouped(
        m.as_stack(), seqs[None], lengths[None], origin32))


def backward_stats(m: TorchStructModel, lengths, bstate, oMI, oXH,
                   return_path: bool = True):
    """B2 for one locus: the G = 1 case of ``backward_stats_grouped``."""
    path, stats = backward_stats_grouped(
        m.as_stack(), lengths[None], bstate[None], oMI[None], oXH[None],
        return_path)
    return (path[0] if return_path else None), stats[0]


def finish_stats(best, stats, path=None):
    """The analytics dict from the walk's (..., N_STATS) output: the
    repeats formula tail of analytics_from_path on O(B) scalars
    (pallas_viterbi.py:876-897)."""
    starts, ends = stats[..., S_STARTS], stats[..., S_ENDS]
    fs, ls, fe, le = (stats[..., S_FS], stats[..., S_LS], stats[..., S_FE],
                      stats[..., S_LE])
    have_all = (fs != BIG) & (ls != -BIG) & (fe != BIG) & (le != -BIG)
    delta = (have_all & (fe < fs) & (ls > le)).to(torch.int32)
    out = {
        "logp": best,
        "repeats": torch.maximum(starts, ends) + delta,
        "n_matches": stats[..., S_NMATCH],
        "repeat_bp": stats[..., S_REPBP],
        "left_flank_bp": stats[..., S_LBP],
        "right_flank_bp": stats[..., S_RBP],
        "left_flank_matches": stats[..., S_LMATCH],
        "right_flank_matches": stats[..., S_RMATCH],
    }
    if path is not None:
        out["path"] = path
    return out


def _pipeline(s: StructModelStack, seqs, lengths, origin32, return_path,
              forward=fused_forward_grouped,
              backward=backward_stats_grouped):
    """Forward and walk for G loci: best (G, B), bstate (G, B), stats
    (G, B, N_STATS) and the struct-space path (G, B, L), which is None and
    never written unless ``return_path``.  The walk does not move in a
    length-1 read, so its path is its end state in every column, as the
    reference has it (pallas_viterbi.py:836-837)."""
    if seqs.shape[-1] > MAX_COLUMNS:
        raise NotImplementedError(
            f"whole origin planes stop at {MAX_COLUMNS} columns; reads of "
            f"{seqs.shape[-1]} take the checkpointed traceback "
            "(ops/viterbi_ckpt.py)")
    best, bstate, oMI, oXH = forward(s, seqs, lengths, origin32)
    path, stats = backward(s, lengths, bstate, oMI, oXH, return_path)
    return best, bstate, path, stats


def _art_path(s: StructModelStack, path_s):
    """Struct-space paths (G, B, L) in each locus's artifact space."""
    return torch.stack([m.struct_to_art[path_s[g].long()]
                        for g, m in enumerate(s.models)])


def viterbi_stats_grouped(s: StructModelStack, seqs, lengths,
                          return_path: bool = False, origin32: bool = False,
                          forward=fused_forward_grouped,
                          backward=backward_stats_grouped):
    """Viterbi + traceback + per-read analytics for G loci: a dict of
    (G, B) tensors, with the artifact-space paths (G, B, L) when
    ``return_path``."""
    best, _, path_s, stats = _pipeline(s, seqs, lengths, origin32,
                                       return_path, forward, backward)
    return finish_stats(best, stats,
                        _art_path(s, path_s) if return_path else None)


def viterbi_stats(m: TorchStructModel, seqs, lengths,
                  return_path: bool = False, origin32: bool = False):
    """Viterbi + traceback + per-read analytics for one locus: a dict of
    (B,) tensors, with the artifact-space path (B, L) when
    ``return_path``."""
    _check_inputs(m, seqs, lengths)
    out = viterbi_stats_grouped(m.as_stack(), seqs[None], lengths[None],
                                return_path, origin32)
    return {k: v[0] for k, v in out.items()}


def viterbi_stats_reference(m: TorchStructModel, seqs, lengths,
                            return_path: bool = False,
                            origin32: bool = False):
    """viterbi_stats through the plain twins, on any device: what the
    kernels are held against on the card."""
    out = viterbi_stats_grouped(
        m.as_stack(), seqs[None], lengths[None], return_path, origin32,
        forward=fused_forward_grouped_reference,
        backward=backward_stats_grouped_reference)
    return {k: v[0] for k, v in out.items()}


def viterbi_batch(m: TorchStructModel, seqs, lengths,
                  return_path: bool = True, origin32: bool = False):
    """(best (B,), end_state (B,), path (B, L) or None), states in
    artifact space: the contract of viterbi_struct_batch."""
    _check_inputs(m, seqs, lengths)
    best, bstate, path_s, _ = _pipeline(
        m.as_stack(), seqs[None], lengths[None], origin32, return_path)
    end_state = m.struct_to_art[bstate[0].long()]
    if not return_path:
        return best[0], end_state, None
    return best[0], end_state, m.struct_to_art[path_s[0].long()]
