"""The reference run over a sample of the loci the timed calls finished,
and its comparison with what those calls produced.

Numbers compared (their limits are in each cell's ``workloads/<cell>.json``):

- ``recruit_diff``: checked loci whose candidate reads differ: the mapped
  reads taken over the locus, or the unmapped reads recruited (each a set);
- ``window_diff``: long-read loci whose spanning windows differ;
- ``logp_gap``: the widest gap between a scored row's log probability and
  the reference's, relative to ``max(1, |reference|)``;
- ``read_diff``: reads whose verdict differs (selected, spanning, and the
  unit count of a selected read);
- ``call_diff``: checked loci whose printed call differs.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import align, genotype, hmm, recruit
from portbench.reference.viterbi import Decoder


def locus_dict(lc) -> dict:
    return {"vid": lc.vid, "pattern": lc.pattern, "left": lc.left,
            "right": lc.right, "segments": [lc.pattern] * lc.ref_copies,
            "start": lc.start}


class Reference:
    """The reference for one sample of one panel, on a device and in a
    dtype (float64; the control runs it lower)."""

    def __init__(self, config: dict, loci, reads: list, device,
                 dtype=torch.float64, placed: dict | None = None):
        self.config = config
        self.loci = {lc.vid: locus_dict(lc) for lc in loci}
        self.reads = dict(reads)
        self.device = device
        self.dtype = dtype
        self.short = config["platform"] == "illumina"
        self._recruited = None
        placed = placed or {}
        self._pool = [r for r in reads if r[0] not in placed]
        by_pos = sorted((p, n) for n, p in placed.items())
        self._pos = np.array([p for p, _ in by_pos], dtype=np.int64)
        self._pos_names = [n for _, n in by_pos]

    def mapped(self, vid: int) -> list[str]:
        """adVNTR's mapped candidates of a locus: the aligned reads that
        start within a read's length before the tract and inside it, or
        end inside it, at least nine tenths of the read length long."""
        lc = self.loci[vid]
        L = self.config["panel"]["read_length"]
        vs = lc["start"]
        ve = vs + len("".join(lc["segments"]))
        lo = np.searchsorted(self._pos, vs - L - 1000, "left")
        hi = np.searchsorted(self._pos, ve, "left")
        out = []
        for k in range(lo, hi):
            name, pos = self._pos_names[k], int(self._pos[k])
            n = len(self.reads[name])
            if n < int(L * 0.9):
                continue
            if vs - L < pos < ve or vs < pos + n < ve:
                out.append(name)
        return out

    def recruited(self) -> dict:
        if self._recruited is None:
            self._recruited = recruit.recruit(list(self.loci.values()),
                                              self._pool, self.short)
        return self._recruited

    def _decode(self, graph, codes):
        c = hmm.compile_graph(*graph)
        logp, paths = Decoder(c, self.device, self.dtype).decode(codes)
        stats = [genotype.path_stats(c.meta, p, x) if np.isfinite(lp) else
                 None for p, x, lp in zip(paths, codes, logp)]
        return logp, stats

    def short_locus(self, vid: int) -> dict:
        lc = self.loci[vid]
        err = self.config["max_error_rate"]
        L = self.config["panel"]["read_length"]
        mapped = self.mapped(vid)
        names = self.recruited()[vid]
        reads = [(n, self.reads[n].upper()) for n in mapped + names]
        rows, codes = [], []
        for ri, (_, seq) in enumerate(reads):
            x = genotype.encode(seq)
            rows.append((ri, 0))
            codes.append(x)
            if ri < len(mapped):       # an aligned read: as aligned
                continue
            rc = x[::-1].copy()
            rc[rc < 4] = 3 - rc[rc < 4]
            rows.append((ri, 1))
            codes.append(rc)
        out = {"recruited": names, "mapped": mapped, "names": mapped + names,
               "rows": rows}
        if not codes:
            out.update(logp=np.zeros(0), call="None", verdicts=[])
            return out
        logp, stats = self._decode(hmm.locus_graph(lc, L, err), codes)
        empty = dict.fromkeys(("repeats", "n_matches", "repeat_bp",
                               "left_flank_bp", "right_flank_bp",
                               "left_flank_matches",
                               "right_flank_matches"), 0)
        stats = [s or empty for s in stats]
        mins = tuple(max(5, h) for h in genotype.homology_runs(
            lc["pattern"], lc["left"], lc["right"]))
        call, verdicts = genotype.short_read_call(reads, rows, stats, logp,
                                                  mins)
        out.update(logp=logp, call=call, verdicts=verdicts)
        return out

    def long_locus(self, vid: int) -> dict:
        lc = self.loci[vid]
        err = self.config["max_error_rate"]
        names = self.recruited()[vid]
        reads = [(n, self.reads[n]) for n in names]
        windows = align.spanning_windows(reads, lc["left"], lc["right"], err,
                                         self.device)
        out = {"recruited": names, "windows": windows}
        if not windows:
            out.update(logp=np.zeros(0), repeats=[], call="None")
            return out
        longest = max(0, max(len(w) - 100 for _, w in windows))
        copies = max(1, int(round(longest / float(len(lc["pattern"])))))
        graph = hmm.locus_graph(lc, 0, err, copies=copies, flank=100)
        logp, stats = self._decode(graph, [genotype.encode(w)
                                           for _, w in windows])
        repeats = [s["repeats"] if s else 0 for s in stats]
        out.update(logp=logp, repeats=repeats,
                   call=genotype.long_read_call(repeats, logp))
        return out


def _gap(a: np.ndarray, b: np.ndarray) -> float:
    if a.shape != b.shape:
        return float("inf")
    if not a.size:
        return 0.0
    fa, fb = np.isfinite(a), np.isfinite(b)
    if (fa != fb).any():
        return float("inf")
    d = np.abs(a[fa] - b[fb]) / np.maximum(1.0, np.abs(b[fb]))
    return float(d.max()) if d.size else 0.0


def compare(platform: str, port: dict, ref: dict) -> dict:
    """The numbers of one checked (call, locus): ``port`` is what the timed
    call produced (captured), ``ref`` the reference's."""
    same = sorted(port["recruited"]) == sorted(ref["recruited"]) and \
        sorted(port.get("mapped", [])) == sorted(ref.get("mapped", []))
    out = {"recruit_diff": int(not same),
           "call_diff": int(port["call"] != ref["call"]),
           "logp_gap": 0.0, "read_diff": 0, "window_diff": 0}
    if platform == "illumina":
        if port.get("rows") is None:
            # the call scored no row for this locus
            out["logp_gap"] = 0.0 if not ref["rows"] else float("inf")
            out["read_diff"] = len(ref["verdicts"])
            return out
        key = {(port["names"][ri], o): k
               for k, (ri, o) in enumerate(port["rows"])}
        order = [key.get((ref["names"][ri], o)) for ri, o in ref["rows"]]
        if None in order or len(order) != len(port["rows"]):
            out["logp_gap"] = float("inf")
        else:
            out["logp_gap"] = _gap(np.asarray(port["logp"])[order],
                                   np.asarray(ref["logp"]))
        pv = {v[0]: v[1:] for v in port["verdicts"]}
        out["read_diff"] = sum(1 for v in ref["verdicts"]
                               if pv.get(v[0]) != v[1:])
        out["read_diff"] += sum(1 for n in pv
                                if n not in {v[0] for v in ref["verdicts"]})
        return out
    out["window_diff"] = int(port["windows"] != ref["windows"])
    if out["window_diff"]:
        out["logp_gap"] = float("inf")
        out["read_diff"] = max(len(port["windows"]), len(ref["windows"]))
        return out
    out["logp_gap"] = _gap(np.asarray(port["logp"], dtype=np.float64),
                           np.asarray(ref["logp"]))
    out["read_diff"] = int(sum(1 for a, b in zip(port["repeats"],
                                                 ref["repeats"]) if a != b))
    return out


def combine(rows: list[dict]) -> dict:
    """The numbers of a run: counts summed, the gap its widest."""
    keys = ("recruit_diff", "window_diff", "logp_gap", "read_diff",
            "call_diff")
    out = {k: 0 for k in keys}
    out["logp_gap"] = 0.0
    for r in rows:
        for k in keys:
            out[k] = max(out[k], r[k]) if k == "logp_gap" else out[k] + r[k]
    return out
