"""The harness's own spans around the calls into each layer of the port,
and its captures of what the timed calls produced.

Nothing here edits the program: each named function is replaced, for the
run, by a wrapper that records (start, end) on the host clock, and in a
traced stretch also opens a ``torch.profiler.record_function`` range of
the layer's name, so that the device trace can tell which layer launched
each kernel.  The wrapper returns what the function returned, untouched,
so the program synchronises where it always does.  A function that the
port no longer has is skipped; the metrics that read its layer then have
nothing to read.
"""

from __future__ import annotations

import importlib
import sys
import time
from collections import defaultdict

# layer -> (module, attribute path) of the port's functions that enter it.
# ``engine`` marks the host steps inside a decode span (the statistics'
# gates and the call), which the decode layer leaves to the engine.
LAYERS = {
    "recruit": [("advntr_tpu_torch.engine.analyzer",
                 "GenomeAnalyzer.recruit_unmapped_reads"),
                ("advntr_tpu_torch.engine.analyzer", "filter_reads")],
    "model": [("advntr_tpu_torch.engine.finder", "LocusModelCache.get")],
    "decode": [("advntr_tpu_torch.engine.analyzer",
                "GenomeAnalyzer._dispatch_group"),
               ("advntr_tpu_torch.engine.analyzer",
                "GenomeAnalyzer._collect_group"),
               ("advntr_tpu_torch.engine.finder", "VNTRFinder.score_reads")],
    "engine": [("advntr_tpu_torch.engine.finder",
                "VNTRFinder.counts_from_stats"),
               ("advntr_tpu_torch.engine.finder",
                "VNTRFinder.genotype_from_counts")],
    "align": [("advntr_tpu_torch.engine.finder", "anchor_probes_batch")],
}


def _resolve(module: str, path: str):
    obj = importlib.import_module(module)
    *owners, attr = path.split(".")
    for name in owners:
        obj = getattr(obj, name)
    return obj, attr


class Recorder:
    """Spans by layer, and the hooks the harness hangs on the port.  Each
    function of the port is wrapped once, whatever observes it: the
    wrapper calls its ``before(args)`` hooks, calls the function (inside
    its layer's span, where it has a layer), then its ``after(args,
    result)`` hooks, and returns the function's result unchanged."""

    def __init__(self):
        self.spans: dict[str, list] = defaultdict(list)
        self.annotate = False        # also open profiler ranges
        self._hooks: dict = {}
        self._undo: list = []

    def clear(self) -> None:
        self.spans.clear()

    def hook(self, module: str, path: str, layer: str | None = None,
             before=None, after=None) -> None:
        """Observe a function of the port; takes effect at ``install``."""
        h = self._hooks.setdefault((module, path),
                                   {"layer": None, "before": [],
                                    "after": []})
        if layer is not None:
            h["layer"] = layer
        if before is not None:
            h["before"].append(before)
        if after is not None:
            h["after"].append(after)

    def _wrapper(self, orig, layer, before, after):
        rec = self

        def wrapper(*args, **kwargs):
            for fn in before:
                fn(args)
            t0 = time.perf_counter()
            if layer is not None and rec.annotate:
                import torch
                with torch.profiler.record_function(layer):
                    out = orig(*args, **kwargs)
            else:
                out = orig(*args, **kwargs)
            if layer is not None:
                rec.spans[layer].append((t0, time.perf_counter()))
            for fn in after:
                fn(args, out)
            return out

        wrapper.__wrapped__ = orig
        return wrapper

    def install(self) -> list[str]:
        """Wrap every layer's functions and every hooked one; returns
        those the port does not have."""
        for layer, targets in LAYERS.items():
            for module, path in targets:
                self.hook(module, path, layer=layer)
        missing = []
        for (module, path), h in self._hooks.items():
            try:
                owner, attr = _resolve(module, path)
                orig = getattr(owner, attr)
            except (ImportError, AttributeError):
                missing.append(f"{module}:{path}")
                continue
            setattr(owner, attr, self._wrapper(orig, h["layer"],
                                               h["before"], h["after"]))
            self._undo.append((owner, attr, orig))
        for m in missing:
            print(f"portbench: no {m} in the port; what observes it is "
                  "left out", file=sys.stderr)
        return missing

    def uninstall(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()


def merged(intervals, lo: float, hi: float) -> list:
    """The union of (start, end) intervals clipped to [lo, hi], as sorted
    disjoint intervals."""
    out: list = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap_seconds(a: list, b: list) -> float:
    """Length of the intersection of two lists from ``merged``."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    return sum(e - s for s, e in merged(intervals, lo, hi))
