"""Structured Viterbi in plain PyTorch: O(n) work a column.

Counterpart of advntr_tpu/ops/viterbi_struct.py, the reference's ``struct``
kernel (its CPU default, and the decoder it holds its Pallas pair to).
The reference computes it in XLA, not Pallas, so it has no hand-written
kernel here either: it is one expression on both devices, on the device of
its inputs.  The forward pass is the reference's column by column:

1. the emitting update: shifts and elementwise maxes over the position
   axis;
2. the silent layer: the within-block delete chains as a tropical affine
   scan unrolled into log-doubling rounds of precomputed shift-decay
   windows ``Wd``, the unit-start chain as a second scan over the C units
   (``Wu``), the hubs as small reductions.

The traceback re-derives each argmax over the stored value planes through
the dense in-edge table ``log_T_struct_t``, the first maximum winning as in
``jnp.argmax``: a different algorithm from B1/B2's origin planes, which is
why the port's kernels are held to it.

Every tensor carries an optional leading group axis: G same-shape loci
(``StructDeviceModel.stack``) decode in one sequence of launches a column,
as the reference's vmap does.  Every value is a max over single float32
additions of the reference's operands, so the results are the reference's
bit for bit.  ``jnp.take``'s default mode is reproduced where an index
comes from the model or the reads: a negative index counts from the end
(``suffix_last`` is -1 for a model without a suffix) and one past either
end gives NaN.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

NEG32 = np.float32(-1e30)
LN05 = float(np.log(0.5))
# the float32 values the reference adds (a Python float is rounded to
# float32 before a float32 add, as a weak-typed JAX scalar is)
_NEG = float(NEG32)
_LN05 = float(np.float32(LN05))
_NAN = float("nan")

# fields holding indices: int64 on the port's side, for indexing
INDEX_FIELDS = ("blk_idx", "unit_last", "struct_to_art")


def _clean(x) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    return np.where(np.isfinite(x), x, np.float64(NEG32)).astype(np.float32)


@dataclasses.dataclass
class StructDeviceModel:
    """Tables of the structured decoder and its dense traceback, on one
    device; the fields and their order are the reference's
    (viterbi_struct.py:40-74).  Geometry is implied by the shapes:
    P = blk_idx.shape[-1], C = unit_last.shape[-1], nb = i0_i.shape[-1].
    A stack of G models (``stack``) has a leading axis of G on every
    field, ``r_unit`` included."""
    blk_idx: torch.Tensor
    eM: torch.Tensor
    eI: torch.Tensor
    eI0: torch.Tensor
    a_mm: torch.Tensor
    a_im: torch.Tensor
    a_dm: torch.Tensor
    ent_m: torch.Tensor
    i0_m: torch.Tensor
    mi: torch.Tensor
    ii: torch.Tensor
    di: torch.Tensor
    md: torch.Tensor
    idw: torch.Tensor
    dd: torch.Tensor
    i0_d: torch.Tensor
    hub_d: torch.Tensor
    i0_i: torch.Tensor
    hub_i0: torch.Tensor
    xm: torch.Tensor
    xi: torch.Tensor
    xd: torch.Tensor
    r_unit: torch.Tensor          # 0-d
    unit_last: torch.Tensor
    M_start: torch.Tensor
    I_start: torch.Tensor
    I0_start: torch.Tensor
    struct_to_art: torch.Tensor
    log_end_struct: torch.Tensor
    log_T_struct_t: torch.Tensor  # (S, S): row s holds the in-edge
                                  # weights of s, both axes structured
    Wd: torch.Tensor              # (rounds_p, P) delete-chain windows
    Wu: torch.Tensor              # (rounds_c, C) unit-chain windows

    @classmethod
    def from_struct(cls, sm, art, device) -> "StructDeviceModel":
        """Pack a padded host StructModel and its unpadded artifact, with
        the reference's numpy build (viterbi_struct.py:76-127): every float
        table cleaned in float64 and cast to float32 once."""
        log_T = np.asarray(art.log_T, dtype=np.float64)
        log_T = np.where(np.isfinite(log_T), log_T, np.float64(NEG32))
        s2a = np.asarray(sm.struct_to_art)
        log_T_struct_t = log_T[np.ix_(s2a, s2a)].T
        # shift-decay windows: the scan y_p = max(y_{p-1} + d_p, b_p)
        # unrolls into rounds v = max(v, shift(v, 2^r) + W_r) with W_r[j]
        # the sum of d over (j - 2^r, j] (NEG across chain resets)
        P, C = sm.P, sm.C
        dd = np.asarray(sm.dd, dtype=np.float64)
        dd = np.where(np.isfinite(dd), dd, np.float64(NEG32))
        rounds_p = max(1, int(np.ceil(np.log2(max(P, 2)))))
        Wd = np.zeros((rounds_p, P))
        Wd[0] = dd
        for r in range(1, rounds_p):
            k = 1 << (r - 1)
            shifted = np.concatenate(
                [np.full(k, np.float64(NEG32)), Wd[r - 1][:-k]])
            Wd[r] = np.maximum(Wd[r - 1] + shifted, np.float64(-1e32))
        rho = float(np.where(np.isfinite(sm.r_unit),
                             sm.r_unit, NEG32)) + LN05
        rounds_c = max(1, int(np.ceil(np.log2(max(C, 2)))))
        Wu = np.full((rounds_c, C), np.float64(NEG32))
        for r in range(rounds_c):
            k = 1 << r
            Wu[r, k:] = max(rho * k, float(NEG32))
        tables = {name: _clean(getattr(sm, name)) for name in (
            "eM", "eI", "eI0", "a_mm", "a_im", "a_dm", "ent_m", "i0_m",
            "mi", "ii", "di", "md", "idw", "dd", "i0_d", "hub_d", "i0_i",
            "hub_i0", "xm", "xi", "xd", "M_start", "I_start", "I0_start",
            "log_end_struct")}
        tables.update(
            blk_idx=sm.blk_idx, unit_last=sm.unit_last, struct_to_art=s2a,
            r_unit=_clean(np.array(sm.r_unit)),
            log_T_struct_t=log_T_struct_t.astype(np.float32),
            Wd=Wd.astype(np.float32), Wu=Wu.astype(np.float32))
        return cls.from_arrays(
            [tables[f.name] for f in dataclasses.fields(cls)], device)

    @classmethod
    def from_arrays(cls, flat, device) -> "StructDeviceModel":
        """The model from its fields in order, as numpy arrays (the
        reference's ``StructDeviceModel.flat()`` carried over as numpy)."""
        out = {}
        for f, x in zip(dataclasses.fields(cls), flat, strict=True):
            x = np.asarray(x)
            x = x.astype(np.int64) if f.name in INDEX_FIELDS \
                else x.astype(np.float32)
            out[f.name] = torch.as_tensor(x, device=device)
        return cls(**out)

    @staticmethod
    def stack(models) -> "StructDeviceModel":
        """G same-shape models as one model with a leading axis of G on
        every field; a single model stacks as views."""
        models = list(models)
        names = [f.name for f in dataclasses.fields(StructDeviceModel)]
        shapes = {tuple(getattr(m, n).shape for n in names) for m in models}
        if len(shapes) != 1:
            raise ValueError("cannot stack struct models of different shapes")
        if len({m.device for m in models}) != 1:
            raise ValueError("cannot stack models on different devices")
        if len(models) == 1:
            return StructDeviceModel(**{n: getattr(models[0], n)[None]
                                        for n in names})
        return StructDeviceModel(**{n: torch.stack([getattr(m, n)
                                                    for m in models])
                                    for n in names})

    @property
    def device(self) -> torch.device:
        return self.eM.device

    @property
    def grouped(self) -> bool:
        return self.blk_idx.dim() == 2

    def to(self, device) -> "StructDeviceModel":
        """These tables on ``device`` (itself where they are there)."""
        device = torch.device(device)
        if self.device == device:
            return self
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


def _index(idx: torch.Tensor, n: int):
    """``jnp.take``'s default mode on an axis of n: a negative index
    counts from the end, one outside [-n, n) gives NaN.  Returns the index
    clamped into range and the mask of its NaN entries (None when every
    entry is in range: one host check a call, not a column)."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    bad = (idx < 0) | (idx >= n)
    return idx.clamp(0, n - 1), (bad if bool(bad.any()) else None)


def _take(x, ix):
    """x (G, B, n) gathered on its last axis at a per-locus index (G, k)
    of ``_index``: (G, B, k)."""
    idx, bad = ix
    G, B = x.shape[:2]
    out = torch.gather(x, 2, idx[:, None, :].expand(G, B, idx.shape[1]))
    if bad is not None:
        out = out.masked_fill(bad[:, None, :], _NAN)
    return out


def _take_table(t, ix):
    """A per-locus table (G, n) at an index (G, k) of ``_index``: (G, 1, k),
    ready to add to (G, B, k) values."""
    idx, bad = ix
    out = torch.gather(t, 1, idx)
    if bad is not None:
        out = out.masked_fill(bad, _NAN)
    return out[:, None, :]


def _shift(x, k: int = 1):
    """Right shift along the last axis by k, filling with -1e30."""
    return F.pad(x[..., :-k], (k, 0), value=_NEG)


def _shift_decay_scan(W, b):
    """The tropical scan y_p = max_{k<=p}(b_k + window(k, p)) over the
    last axis of b (G, B, n), by the rounds of W (G, rounds, n)."""
    v = b
    n = b.shape[-1]
    for r in range(W.shape[1]):
        k = 1 << r
        if k >= n:
            break
        v = torch.maximum(v, _shift(v, k) + W[:, None, r, :])
    return v


@dataclasses.dataclass
class Columns:
    """What every column of one call reads besides the carry: the stacked
    model, its indices as ``_index`` gives them, the exit weights at the
    block ends, the emission tables with a NaN row for codes outside
    0..3, and the reads' codes (G, B, L) as rows of those tables."""
    m: StructDeviceModel
    g: torch.Tensor
    blk: tuple                    # block of each position, into I0 (nb)
    hub_blk: tuple                # the same, into the hub row (C + 2)
    ul: tuple
    sl: tuple
    x_ul: tuple
    x_sl: tuple
    eM: torch.Tensor              # (G, 5, P)
    eI: torch.Tensor
    eI0: torch.Tensor             # (G, 5, nb)
    codes: torch.Tensor

    def emissions(self, t: int):
        """Column t's (eM, eI, eI0) values, each (G, B, width)."""
        c = self.codes[:, :, t]
        g = self.g[:, None]
        return self.eM[g, c], self.eI[g, c], self.eI0[g, c]


def columns(m: StructDeviceModel, seqs, suffix_last) -> Columns:
    """The per-call tables of a stacked model ``m`` for codes seqs
    (G, B, L) and suffix_last (G,)."""
    G, P = m.blk_idx.shape
    nb, C = m.i0_i.shape[1], m.unit_last.shape[1]
    dev = m.device
    blk = _index(m.blk_idx, nb)
    hub_blk = blk if nb == C + 2 else _index(m.blk_idx, C + 2)
    ul = _index(m.unit_last, P)
    sl = _index(torch.as_tensor(suffix_last, device=dev).reshape(G, 1), P)
    x_ul = tuple(_take_table(t, ul) for t in (m.xm, m.xi, m.xd))
    x_sl = tuple(_take_table(t, sl) for t in (m.xm, m.xi, m.xd))
    codes = seqs.long()
    codes = torch.where(codes < 0, codes + 4, codes)
    codes = torch.where((codes < 0) | (codes > 3), 4, codes)

    def rows(e):
        nan = torch.full(e.shape[:1] + (1, e.shape[1]), _NAN,
                         dtype=e.dtype, device=dev)
        return torch.cat([e.transpose(1, 2), nan], dim=1)

    return Columns(m=m, g=torch.arange(G, device=dev), blk=blk,
                   hub_blk=hub_blk, ul=ul,
                   sl=sl, x_ul=x_ul, x_sl=x_sl, eM=rows(m.eM),
                   eI=rows(m.eI), eI0=rows(m.eI0), codes=codes)


def _row(t):
    """A per-locus (G, n) table as (G, 1, n)."""
    return t[:, None, :]


def silent_layer(cols: Columns, Mn, In, I0n):
    """D chains and hub values of one column of emitting values
    (viterbi_struct.py:162-194); every tensor (G, B, width)."""
    m = cols.m
    I0_by_pos = _take(I0n, cols.blk)
    bb = torch.maximum(
        torch.maximum(_shift(Mn) + _row(m.md), _shift(In) + _row(m.idw)),
        I0_by_pos + _row(m.i0_d))
    Dinner = _shift_decay_scan(m.Wd, bb)
    xm, xi, xd = cols.x_ul
    q = torch.maximum(
        torch.maximum(_take(Mn, cols.ul) + xm, _take(In, cols.ul) + xi),
        _take(Dinner, cols.ul) + xd)
    xm, xi, xd = cols.x_sl
    sufq = torch.maximum(
        torch.maximum(_take(Mn, cols.sl) + xm, _take(In, cols.sl) + xi),
        _take(Dinner, cols.sl) + xd)
    # unit_start chain: us_c = max(s_c, us_{c-1} + r_unit + ln(1/2))
    s = torch.cat([sufq, q[..., :-1] + _LN05], dim=-1)
    us = _shift_decay_scan(m.Wu, s)
    ue = torch.maximum(q, us + m.r_unit[:, None, None])
    pstart = torch.amax(ue + _LN05, dim=-1, keepdim=True)
    hub = torch.cat([torch.full_like(pstart, _NEG), us, pstart], dim=-1)
    Dn = torch.maximum(Dinner, _take(hub, cols.hub_blk) + _row(m.hub_d))
    return Dn, hub


def _finals(m, M, I, I0):
    return torch.amax(torch.cat([M, I, I0], dim=-1)
                      + _row(m.log_end_struct), dim=-1)


def initial_column(cols: Columns):
    """The carry after column 0: (M, I, I0, D, hub, best)."""
    m = cols.m
    eM0, eI0_, eI00 = cols.emissions(0)
    M0 = _row(m.M_start) + eM0
    Iv0 = _row(m.I_start) + eI0_
    I00 = _row(m.I0_start) + eI00
    D0, hub0 = silent_layer(cols, M0, Iv0, I00)
    return (M0, Iv0, I00, D0, hub0, _finals(m, M0, Iv0, I00))


def forward_step(cols: Columns, lengths, carry, t: int):
    """Column t >= 1 (viterbi_struct.py:208-238): the new carry; reads
    whose length is t or less keep theirs."""
    m = cols.m
    M, I, I0, D, hub, best = carry
    eM_t, eI_t, eI0_t = cols.emissions(t)
    hub_by_pos = _take(hub, cols.hub_blk)
    I0_by_pos = _take(I0, cols.blk)
    Mn = eM_t + torch.maximum(
        torch.maximum(_shift(M) + _row(m.a_mm), _shift(I) + _row(m.a_im)),
        torch.maximum(_shift(D) + _row(m.a_dm),
                      torch.maximum(hub_by_pos + _row(m.ent_m),
                                    I0_by_pos + _row(m.i0_m))))
    In = eI_t + torch.maximum(
        torch.maximum(M + _row(m.mi), I + _row(m.ii)), D + _row(m.di))
    I0n = eI0_t + torch.maximum(I0 + _row(m.i0_i), hub + _row(m.hub_i0))
    act = (t < lengths)[..., None]
    Mn = torch.where(act, Mn, M)
    In = torch.where(act, In, I)
    I0n = torch.where(act, I0n, I0)
    Dn, hubn = silent_layer(cols, Mn, In, I0n)
    Dn = torch.where(act, Dn, D)
    hubn = torch.where(act, hubn, hub)
    best = torch.where(t == lengths - 1, _finals(m, Mn, In, I0n), best)
    return (Mn, In, I0n, Dn, hubn, best)


def run_columns(cols: Columns, lengths, carry, t0: int, t1: int,
                planes=None):
    """Columns t0 .. t1 - 1 (t0 >= 1) from ``carry``; with ``planes``
    (t1 - t0, G, B, 2P + nb), planes[i] receives the value plane
    (M | I | I0) that column t0 + i starts from."""
    P = cols.m.blk_idx.shape[1]
    for t in range(t0, t1):
        if planes is not None:
            M, I, I0 = carry[:3]
            plane = planes[t - t0]
            plane[..., :P] = M
            plane[..., P:2 * P] = I
            plane[..., 2 * P:] = I0
        carry = forward_step(cols, lengths, carry, t)
    return carry


def end_states(cols: Columns, carry):
    """(G, B) structured index of each read's best end state: the first
    maximum of its last column plus the end weights."""
    M, I, I0 = carry[:3]
    return torch.argmax(torch.cat([M, I, I0], dim=-1)
                        + _row(cols.m.log_end_struct), dim=-1)


def walk_back(cols: Columns, lengths, planes, t0: int, t1: int, cur,
              path_s):
    """The traceback over columns t1 - 1 .. t0 (t0 >= 1) on the planes of
    ``run_columns(..., t0, t1, planes)``: path_s[..., t] gets the state of
    column t, and the state of column t0 - 1 is returned.  Each step
    re-derives the argmax through ``log_T_struct_t`` (first maximum)."""
    g = cols.g[:, None]
    for t in range(t1 - 1, t0 - 1, -1):
        path_s[..., t] = cur
        prev = torch.argmax(planes[t - t0]
                            + cols.m.log_T_struct_t[g, cur], dim=-1)
        cur = torch.where(t <= lengths - 1, prev, cur)
    return cur


def to_artifact(cols: Columns, lengths, end_s, path_s):
    """(end state, path) in artifact space; a read of length 1 stands in
    its end state throughout."""
    G, B, L = path_s.shape
    path_s = torch.where((lengths == 1)[..., None], end_s[..., None], path_s)
    s2a = cols.m.struct_to_art
    path = torch.gather(s2a, 1, path_s.reshape(G, B * L)).reshape(G, B, L)
    return torch.gather(s2a, 1, end_s), path


def grouped_inputs(m: StructDeviceModel, seqs, lengths, suffix_last):
    """(stacked model, seqs (G, B, L), lengths (G, B) int64, whether the
    caller passed a group): a single locus is a group of one."""
    if seqs.dim() == 3:
        if not m.grouped:
            raise ValueError("grouped seqs need a stacked model")
        return m, seqs, lengths.long(), True
    if m.grouped:
        raise ValueError("a stacked model needs seqs (G, B, L)")
    return (StructDeviceModel.stack([m]), seqs[None], lengths[None].long(),
            False)


def viterbi_struct_batch(m: StructDeviceModel, seqs, lengths, suffix_last,
                         return_path: bool = True):
    """Structured forward and dense-assisted traceback
    (viterbi_struct.py:241-287): (logp, end_state, path), states in
    artifact space, or (logp, None, None) without ``return_path``.
    seqs (B, L) and lengths (B,) with one model and an int suffix_last,
    or seqs (G, B, L), lengths (G, B) and suffix_last (G,) with a stacked
    one, every output then with a leading G."""
    m, seqs, lengths, grouped = grouped_inputs(m, seqs, lengths,
                                               suffix_last)
    G, B, L = seqs.shape
    sl = suffix_last if grouped else [suffix_last]
    cols = columns(m, seqs, sl)
    carry = initial_column(cols)
    planes = None
    if return_path and L > 1:
        S = m.log_end_struct.shape[1]
        planes = torch.empty(L - 1, G, B, S, dtype=torch.float32,
                             device=seqs.device)
    carry = run_columns(cols, lengths, carry, 1, L, planes)
    best = carry[5]
    if not return_path:
        return (best if grouped else best[0]), None, None
    end_s = end_states(cols, carry)
    path_s = torch.empty(G, B, L, dtype=torch.long, device=seqs.device)
    path_s[..., 0] = walk_back(cols, lengths, planes, 1, L, end_s, path_s)
    end_state, path = to_artifact(cols, lengths, end_s, path_s)
    if grouped:
        return best, end_state, path
    return best[0], end_state[0], path[0]
