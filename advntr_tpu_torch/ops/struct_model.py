"""Plain device tables for the structured Viterbi kernels.

Counterpart of ``PallasStructModel.from_struct``
(advntr_tpu/ops/pallas_viterbi.py:135-274).  It packs the same padded host
``StructModel`` (models/struct_compiler.py) that the reference packs, but as
plain per-position and per-block tables: a GPU reads ``eM[p, base]`` and
``hub[blk_idx[p]]`` with one indexed load, so the TPU's MXU folds (the
ones-row expansion matrices, the emission/match-bit matrix, the one-hot
extraction matrix) and the int16 ``(region << 12) | unit`` pack are gone.

Every float table is built in float64, with -inf cleaned to NEG, and cast
to float32 once, in the same order as the reference, so that both compute
the same float32 sums.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NEG = np.float32(-1e30)
LN05 = float(np.log(0.5))

# origin planes hold +1-offset struct-space codes with a match bit packed on
# the M half: int16 while every stored value fits (codes < 2^13), else int32
MBIT16 = 1 << 13
MBIT32 = 1 << 20

# rows of the (len(POS_ROWS), P) float table, one value per match position
POS_ROWS = ("a_mm", "a_im", "a_dm", "ent_m", "i0_m", "mi", "ii", "di",
            "md", "idw", "i0_d", "hub_d", "xm", "xi", "xd",
            "M_start", "I_start", "le_M", "le_I")
POS = {name: i for i, name in enumerate(POS_ROWS)}
# rows of the (len(BLK_ROWS), nb) float table, one value per block
BLK_ROWS = ("i0_i", "hub_i0", "I0_start", "le_I0")
BLK = {name: i for i, name in enumerate(BLK_ROWS)}


def origin_params(P: int, nb: int, force32: bool = False):
    """(torch dtype, match-bit value) of a (P, nb) model's origin planes
    (the rule of pallas_viterbi.py:98-102)."""
    if force32 or 2 * P + 2 * nb + 2 >= MBIT16:
        return torch.int32, MBIT32
    return torch.int16, MBIT16


def _clean(x) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    return np.where(np.isfinite(x), x, np.float64(NEG))


def delete_windows(dd) -> np.ndarray:
    """Log-doubling window weights of the delete chain: row r holds the sum
    of dd over (j - 2^r, j], NEG where a window crosses a block start.
    Rounds stop once 2^r reaches the longest block."""
    dd = _clean(dd)
    finite = dd > np.float64(NEG) / 2
    span = run = 0
    for f in finite:
        run = run + 1 if f else 0
        span = max(span, run)
    n_rounds = max(1, int(np.ceil(np.log2(max(span + 1, 2)))))
    Wd = np.full((n_rounds, dd.shape[0]), np.float64(NEG))
    Wd[0] = dd
    for r in range(1, n_rounds):
        k = 1 << (r - 1)
        shifted = np.concatenate([np.full(k, np.float64(NEG)),
                                  Wd[r - 1][:-k]])
        Wd[r] = Wd[r - 1] + shifted
    return Wd


def unit_windows(r_unit: float, C: int) -> np.ndarray:
    """Window weights of the unit-start chain: constant decay
    rho = r_unit + ln(1/2) per hop, NEG where a window runs past unit 0."""
    rho = (_clean(np.array(r_unit)) + LN05).item()
    n_rounds = max(1, int(np.ceil(np.log2(max(C, 2)))))
    Wu = np.full((n_rounds, C), np.float64(NEG))
    for r in range(n_rounds):
        k = 1 << r
        Wu[r, k:] = rho * k if rho > np.float64(NEG) / 4 else np.float64(NEG)
    return Wu


@dataclasses.dataclass
class TorchStructModel:
    """Tables of one padded locus model, on one device."""
    P: int
    nb: int
    C: int
    suffix_last: int              # -1 when the model has no suffix block
    r_unit: float                 # float32 value, as a Python float
    pos: torch.Tensor             # (len(POS_ROWS), P) f32
    blk: torch.Tensor             # (len(BLK_ROWS), nb) f32
    eM: torch.Tensor              # (P, 4) f32
    eI: torch.Tensor              # (P, 4) f32
    eI0: torch.Tensor             # (nb, 4) f32
    Wd: torch.Tensor              # (n_rounds_p, P) f32
    Wu: torch.Tensor              # (n_rounds_c, C) f32
    blk_idx: torch.Tensor         # (P,) int32
    exp_base: torch.Tensor        # (P,) int32 expected base of M_p
    unit_last: torch.Tensor       # (C,) int32
    region: torch.Tensor          # (2P+nb,) int32 per struct index
    unit: torch.Tensor            # (2P+nb,) int32 per struct index
    struct_to_art: torch.Tensor   # (2P+nb,) int64
    # (kind, region, exp_base, unit), each (n_states,) int32 per artifact
    # state: what the plain path analytics read
    art_meta: tuple
    # this model as a group of one, kept by ``as_stack``
    _stack: "StructModelStack | None" = dataclasses.field(
        default=None, repr=False, compare=False)

    @classmethod
    def from_payload(cls, art, sm, device) -> "TorchStructModel":
        """Pack a padded host StructModel ``sm`` and its ModelArtifact."""
        P, C, nb = sm.P, sm.C, sm.nb
        le = _clean(sm.log_end_struct)
        last = np.zeros(P, dtype=bool)
        last[np.asarray(sm.unit_last)] = True
        if sm.suffix_last >= 0:
            last[sm.suffix_last] = True
        vec = {name: _clean(getattr(sm, name)) for name in POS_ROWS[:15]}
        for name in ("xm", "xi", "xd"):
            vec[name] = np.where(last, vec[name], np.float64(NEG))
        vec["M_start"] = _clean(sm.M_start)
        vec["I_start"] = _clean(sm.I_start)
        vec["le_M"], vec["le_I"] = le[:P], le[P:2 * P]
        pos = np.stack([vec[name] for name in POS_ROWS])
        blk = np.stack([_clean(sm.i0_i), _clean(sm.hub_i0),
                        _clean(sm.I0_start), le[2 * P:]])
        s2a = np.asarray(sm.struct_to_art)
        f32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32),
                                        device=device)
        i32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.int32),
                                        device=device)
        r_unit = float(np.float32(_clean(np.array(sm.r_unit)).item()))
        return cls(
            P=P, nb=nb, C=C, suffix_last=int(sm.suffix_last),
            r_unit=r_unit,
            pos=f32(pos), blk=f32(blk), eM=f32(_clean(sm.eM)),
            eI=f32(_clean(sm.eI)), eI0=f32(_clean(sm.eI0)),
            Wd=f32(delete_windows(sm.dd)), Wu=f32(unit_windows(sm.r_unit, C)),
            blk_idx=i32(sm.blk_idx),
            exp_base=i32(np.asarray(art.exp_base)[s2a[:P]]),
            unit_last=i32(sm.unit_last),
            region=i32(np.asarray(art.region)[s2a]),
            unit=i32(np.asarray(art.unit)[s2a]),
            struct_to_art=torch.as_tensor(s2a.astype(np.int64),
                                          device=device),
            art_meta=tuple(i32(x) for x in (art.kind, art.region,
                                            art.exp_base, art.unit)))

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def row(self, name: str) -> torch.Tensor:
        """One named per-position (P,) or per-block (nb,) table."""
        if name in POS:
            return self.pos[POS[name]]
        return self.blk[BLK[name]]

    def shape_key(self) -> tuple:
        """Models with equal keys share kernel shapes and stack in a group."""
        return (self.P, self.nb, self.C, self.struct_to_art.shape[0],
                self.Wd.shape[0], self.Wu.shape[0])

    def as_stack(self) -> "StructModelStack":
        """This model as a group of one, made at the first call and kept:
        its tables are views, and the two (1,) scalar tensors reach the
        device once and not at every call."""
        if self._stack is None:
            self._stack = TorchStructModel.stack([self])
        return self._stack

    @staticmethod
    def stack(models) -> "StructModelStack":
        """G same-shape models as one set of (G, ...) tables: what one
        grouped kernel launch reads.  A single model stacks as views."""
        models = list(models)
        keys = {m.shape_key() for m in models}
        if len(keys) != 1:
            raise ValueError(f"cannot stack models of shapes {sorted(keys)}")
        if len({m.device for m in models}) != 1:
            raise ValueError("cannot stack models on different devices")
        m0 = models[0]
        if len(models) == 1:
            tables = {name: getattr(m0, name)[None] for name in STACKED}
        else:
            tables = {name: torch.stack([getattr(m, name) for m in models])
                      for name in STACKED}
        return StructModelStack(
            P=m0.P, nb=m0.nb, C=m0.C, models=models,
            suffix_last=torch.tensor([m.suffix_last for m in models],
                                     dtype=torch.int32, device=m0.device),
            r_unit=torch.tensor([m.r_unit for m in models],
                                dtype=torch.float32, device=m0.device),
            **tables)


# the tensors of a TorchStructModel that a grouped launch reads
STACKED = ("pos", "blk", "eM", "eI", "eI0", "Wd", "Wu", "blk_idx",
           "exp_base", "unit_last", "region", "unit")


@dataclasses.dataclass
class StructModelStack:
    """The tables of G same-shape locus models with a leading group axis,
    contiguous, on one device; ``models`` are the stacked models."""
    P: int
    nb: int
    C: int
    models: list
    pos: torch.Tensor             # (G, len(POS_ROWS), P) f32
    blk: torch.Tensor             # (G, len(BLK_ROWS), nb) f32
    eM: torch.Tensor              # (G, P, 4) f32
    eI: torch.Tensor              # (G, P, 4) f32
    eI0: torch.Tensor             # (G, nb, 4) f32
    Wd: torch.Tensor              # (G, n_rounds_p, P) f32
    Wu: torch.Tensor              # (G, n_rounds_c, C) f32
    blk_idx: torch.Tensor         # (G, P) int32
    exp_base: torch.Tensor        # (G, P) int32
    unit_last: torch.Tensor       # (G, C) int32
    region: torch.Tensor          # (G, 2P+nb) int32
    unit: torch.Tensor            # (G, 2P+nb) int32
    suffix_last: torch.Tensor     # (G,) int32, the models' scalars
    r_unit: torch.Tensor          # (G,) f32

    @property
    def G(self) -> int:
        return len(self.models)

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def to(self, device) -> "StructModelStack":
        """These tables on ``device``: one device-to-device copy a table,
        none where they are there already.  ``models`` stay where they
        are, so the CPU twins take a stack only on its models' device."""
        device = torch.device(device)
        if self.device == device:
            return self
        moved = {name: getattr(self, name).to(device)
                 for name in STACKED + ("suffix_last", "r_unit")}
        return dataclasses.replace(self, **moved)
