"""Structured-model compiler: banded parameter extraction for the O(n)
per-step Viterbi kernel.

The read-matcher HMM is three profile chains (left-flank suffix matcher,
C repeat copies, right-flank prefix matcher) joined by a handful of silent
hub states.  The dense eliminated matrix is ~50% filled only because silent
deletion chains connect everything with astronomically negative weights;
the *structure* is banded: every state's in-edges are (p-1 -> p) moves plus
a block-entry hub.  This module lays the model out on a global match-
position axis with per-position transition vectors, and the silent layer
becomes tropical affine scans (see ops/viterbi_struct.py).

Parameters are extracted from the already-validated HmmGraph by state name,
so the structured kernel provably scores the same model as the dense path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

NEG = -np.inf


@dataclasses.dataclass
class StructModel:
    # geometry
    W_s: int          # suffix match columns
    W: int            # repeat-unit match columns
    C: int            # copies
    W_p: int          # prefix match columns
    P: int            # W_s + C*W + W_p
    nb: int           # C + 2 blocks

    blk_idx: np.ndarray     # (P,) block index per position
    # emissions
    eM: np.ndarray          # (P, 4)
    eI: np.ndarray          # (P, 4)
    eI0: np.ndarray         # (nb, 4)
    # transitions into M_p (from position p-1 of the same block)
    a_mm: np.ndarray
    a_im: np.ndarray
    a_dm: np.ndarray
    ent_m: np.ndarray       # hub -> M_p (block starts only)
    i0_m: np.ndarray        # I0 -> M_p (block starts only)
    # transitions into I_p
    mi: np.ndarray
    ii: np.ndarray
    di: np.ndarray
    # transitions into D_p (same column, from p-1)
    md: np.ndarray
    idw: np.ndarray
    dd: np.ndarray          # -inf at block starts (chain reset)
    i0_d: np.ndarray        # I0 -> D_p (block starts only)
    hub_d: np.ndarray       # hub -> D_p cumulative (us->D1->...->D_p)
    # I0 dynamics per block
    i0_i: np.ndarray        # (nb,) I0 self-loop
    hub_i0: np.ndarray      # (nb,) hub -> I0
    # block exits (into suffix_end / unit_end), finite on last columns only
    xm: np.ndarray
    xi: np.ndarray
    xd: np.ndarray
    # hub chain constants
    r_unit: float           # us -> ue via full unit deletion
    ln05: float
    unit_last: np.ndarray   # (C,) position of each unit's last column
    suffix_last: int        # position of the suffix's last column (-1 if none)
    # initial column (start) values per slot
    M_start: np.ndarray     # (P,)
    I_start: np.ndarray     # (P,)
    I0_start: np.ndarray    # (nb,)
    # mapping: artifact flat emitting index -> column of concat([M, I, I0])
    perm: np.ndarray        # (n_art,) int32
    struct_to_art: np.ndarray  # (2P+nb,) int32 inverse mapping
    # art.log_end laid out on the structured axis (concat([M, I, I0]) order)
    log_end_struct: np.ndarray  # (2P+nb,)


def build_structured(graph, art) -> StructModel:
    g = graph
    name_idx = {s.name: i for i, s in enumerate(g.states)}

    def w(a: str, b: str) -> float:
        p = g.edges.get((name_idx[a], name_idx[b]), 0.0)
        return float(np.log(p)) if p > 0 else NEG

    def emis(name: str) -> np.ndarray:
        st = g.states[name_idx[name]]
        out = np.full(4, NEG)
        for bi, base in enumerate("ACGT"):
            p = st.emission.get(base, 0.0)
            out[bi] = np.log(p) if p > 0 else NEG
        return out

    # geometry from state names
    W_s = max((int(n.split("_")[0][1:]) for n in name_idx
               if n.startswith("M") and n.endswith("_suffix")), default=0)
    W_p = max((int(n.split("_")[0][1:]) for n in name_idx
               if n.startswith("M") and n.endswith("_prefix")), default=0)
    unit_ids = sorted({int(n.split("_")[1]) for n in name_idx
                       if n.startswith("M") and n.split("_")[1].isdigit()})
    C = len(unit_ids)
    W = max(int(n.split("_")[0][1:]) for n in name_idx
            if n.startswith("M") and n.split("_")[-1] == "0")
    P = W_s + C * W + W_p
    nb = C + 2

    blocks = []          # (suffix_label, W_blk, hub_name(block entry), end_name)
    blocks.append(("suffix", W_s, "suffix_start_suffix", "suffix_end_suffix"))
    for c in range(C):
        blocks.append((str(c), W, f"unit_start_{c}", f"unit_end_{c}"))
    blocks.append(("prefix", W_p, "prefix_start_prefix", "prefix_end_prefix"))

    shape = (P,)
    eM = np.full((P, 4), NEG)
    eI = np.full((P, 4), NEG)
    eI0 = np.full((nb, 4), NEG)
    arrs = {k: np.full(shape, NEG) for k in
            ("a_mm", "a_im", "a_dm", "ent_m", "i0_m", "mi", "ii", "di",
             "md", "idw", "dd", "i0_d", "hub_d", "xm", "xi", "xd")}
    i0_i = np.full(nb, NEG)
    hub_i0 = np.full(nb, NEG)
    blk_idx = np.zeros(P, dtype=np.int32)

    pos = 0
    unit_last = []
    suffix_last = -1
    for bi, (label, W_blk, hub, end_name) in enumerate(blocks):
        for j in range(1, W_blk + 1):
            p = pos + j - 1
            blk_idx[p] = bi
            M, I, D = f"M{j}_{label}", f"I{j}_{label}", f"D{j}_{label}"
            Mp = f"M{j - 1}_{label}" if j > 1 else None
            Ip = f"I{j - 1}_{label}"
            Dp = f"D{j - 1}_{label}" if j > 1 else None
            I0 = f"I0_{label}"
            eM[p] = emis(M)
            eI[p] = emis(I)
            if j > 1:
                arrs["a_mm"][p] = w(Mp, M)
                arrs["a_im"][p] = w(Ip, M)
                arrs["a_dm"][p] = w(Dp, M)
                arrs["md"][p] = w(Mp, D)
                arrs["idw"][p] = w(Ip, D)
                arrs["dd"][p] = w(Dp, D)
            else:
                arrs["ent_m"][p] = w(hub, M)
                arrs["i0_m"][p] = w(I0, M)
                arrs["i0_d"][p] = w(I0, D)
            arrs["mi"][p] = w(M, I)
            arrs["ii"][p] = w(I, I)
            arrs["di"][p] = w(D, I)
            if j == W_blk:
                arrs["xm"][p] = w(M, end_name)
                arrs["xi"][p] = w(I, end_name)
                arrs["xd"][p] = w(D, end_name)
        # hub->D cumulative within the block
        hd = w(hub, f"D1_{label}")
        arrs["hub_d"][pos] = hd
        for j in range(2, W_blk + 1):
            hd = hd + arrs["dd"][pos + j - 1]
            arrs["hub_d"][pos + j - 1] = hd
        eI0[bi] = emis(f"I0_{label}")
        i0_i[bi] = w(f"I0_{label}", f"I0_{label}")
        hub_i0[bi] = w(hub, f"I0_{label}")
        if label == "suffix":
            suffix_last = pos + W_blk - 1
        elif label.isdigit():
            unit_last.append(pos + W_blk - 1)
        pos += W_blk

    # us -> ue full-deletion constant (unit 0 is representative; profiles are
    # shared across copies)
    if C > 0:
        r_unit = arrs["hub_d"][unit_last[0]] + arrs["xd"][unit_last[0]]
    else:
        r_unit = NEG

    # start values + artifact permutation
    art_idx = {n: i for i, n in enumerate(art.names)}
    M_start = np.full(P, NEG)
    I_start = np.full(P, NEG)
    I0_start = np.full(nb, NEG)
    perm = np.zeros(len(art.names), dtype=np.int32)
    pos = 0
    for bi, (label, W_blk, hub, end_name) in enumerate(blocks):
        for j in range(1, W_blk + 1):
            p = pos + j - 1
            M_start[p] = art.log_start[art_idx[f"M{j}_{label}"]]
            I_start[p] = art.log_start[art_idx[f"I{j}_{label}"]]
            perm[art_idx[f"M{j}_{label}"]] = p
            perm[art_idx[f"I{j}_{label}"]] = P + p
        I0_start[bi] = art.log_start[art_idx[f"I0_{label}"]]
        perm[art_idx[f"I0_{label}"]] = 2 * P + bi
        pos += W_blk

    n_struct = 2 * P + nb
    assert len(art.names) == n_struct, (len(art.names), n_struct)
    struct_to_art = np.zeros(n_struct, dtype=np.int32)
    struct_to_art[perm] = np.arange(len(art.names), dtype=np.int32)
    log_end_struct = np.asarray(art.log_end)[struct_to_art]

    return StructModel(
        W_s=W_s, W=W, C=C, W_p=W_p, P=P, nb=nb, blk_idx=blk_idx,
        eM=eM, eI=eI, eI0=eI0,
        a_mm=arrs["a_mm"], a_im=arrs["a_im"], a_dm=arrs["a_dm"],
        ent_m=arrs["ent_m"], i0_m=arrs["i0_m"],
        mi=arrs["mi"], ii=arrs["ii"], di=arrs["di"],
        md=arrs["md"], idw=arrs["idw"], dd=arrs["dd"],
        i0_d=arrs["i0_d"], hub_d=arrs["hub_d"],
        i0_i=i0_i, hub_i0=hub_i0,
        xm=arrs["xm"], xi=arrs["xi"], xd=arrs["xd"],
        r_unit=float(r_unit), ln05=float(np.log(0.5)),
        unit_last=np.array(unit_last, dtype=np.int32),
        suffix_last=suffix_last,
        M_start=M_start, I_start=I_start, I0_start=I0_start, perm=perm,
        struct_to_art=struct_to_art, log_end_struct=log_end_struct)


def pad_structured(sm: StructModel, art, P_pad: int, C_pad: int) -> StructModel:
    """Pad a structured model to bucket dimensions so one compiled kernel
    serves every locus in the bucket.

    Padding positions are unreachable (-inf parameters) appended after the
    prefix; padded fake units point their unit_last at a padded position so
    their block-exit weight is -inf.  Requires P_pad > P when C_pad > C.
    """
    P, C, nb = sm.P, sm.C, sm.nb
    if P_pad == P and C_pad == C:
        return sm
    assert P_pad >= P and C_pad >= C
    if C_pad > C:
        assert P_pad > P, "need at least one dummy position for fake units"
    nb_pad = C_pad + 2

    def padP(x):
        out = np.full(P_pad, NEG)
        out[:P] = x
        return out

    def padNb(x):
        # block order: [suffix, unit_0..C-1, (fake units), prefix]
        out = np.full(nb_pad, NEG)
        out[: 1 + C] = x[: 1 + C]
        out[nb_pad - 1] = x[nb - 1]
        return out

    def padP4(x):
        out = np.full((P_pad, 4), NEG)
        out[:P] = x
        return out

    def padNb4(x):
        out = np.full((nb_pad, 4), NEG)
        out[: 1 + C] = x[: 1 + C]
        out[nb_pad - 1] = x[nb - 1]
        return out

    blk_idx = np.full(P_pad, nb_pad - 1, dtype=np.int32)
    old_blk = sm.blk_idx.copy()
    old_blk[old_blk == nb - 1] = nb_pad - 1  # prefix block index shifts
    blk_idx[:P] = old_blk

    unit_last = np.full(C_pad, P_pad - 1, dtype=np.int32)
    unit_last[:C] = sm.unit_last

    # remap structured slots: M region keeps positions, I region shifts to
    # P_pad, I0 region to 2*P_pad with the block remap
    n_art = len(art.names)
    perm = np.zeros(n_art, dtype=np.int32)
    for a in range(n_art):
        s = sm.perm[a]
        if s < P:
            perm[a] = s
        elif s < 2 * P:
            perm[a] = P_pad + (s - P)
        else:
            b = s - 2 * P
            b_new = b if b < 1 + C else nb_pad - 1
            perm[a] = 2 * P_pad + b_new
    n_struct = 2 * P_pad + nb_pad
    struct_to_art = np.zeros(n_struct, dtype=np.int32)
    struct_to_art[perm] = np.arange(n_art, dtype=np.int32)
    log_end_struct = np.full(n_struct, NEG)
    log_end_struct[perm] = np.asarray(art.log_end)

    return dataclasses.replace(
        sm, P=P_pad, C=C_pad, nb=nb_pad, blk_idx=blk_idx,
        eM=padP4(sm.eM), eI=padP4(sm.eI), eI0=padNb4(sm.eI0),
        a_mm=padP(sm.a_mm), a_im=padP(sm.a_im), a_dm=padP(sm.a_dm),
        ent_m=padP(sm.ent_m), i0_m=padP(sm.i0_m),
        mi=padP(sm.mi), ii=padP(sm.ii), di=padP(sm.di),
        md=padP(sm.md), idw=padP(sm.idw), dd=padP(sm.dd),
        i0_d=padP(sm.i0_d), hub_d=padP(sm.hub_d),
        i0_i=padNb(sm.i0_i), hub_i0=padNb(sm.hub_i0),
        xm=padP(sm.xm), xi=padP(sm.xi), xd=padP(sm.xd),
        unit_last=unit_last,
        M_start=padP(sm.M_start), I_start=padP(sm.I_start),
        I0_start=padNb(sm.I0_start), perm=perm,
        struct_to_art=struct_to_art, log_end_struct=log_end_struct)
