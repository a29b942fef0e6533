"""The device's idle time by the program's own spans: over the traced
stretch of a ``torch.profiler`` trace (CPU and CUDA activity), each moment
the device is idle goes to the innermost ``advntr.*`` range open on the
host then, or to ``""`` where none is.  The ranges are the port's spans,
which open them when its profiler annotates
(``advntr_tpu_torch.utils.profiler.enable(annotate=True)``); a trace
without them puts all of the idle time under ``""``.  Busy time and the
stretch are as ``trace.reduce_trace`` reads them."""

from __future__ import annotations

import json

from portbench.trace import DEVICE_CATS, STRETCH

PREFIX = "advntr."
ROOT = "advntr.call"


def idle_by_span(path: str) -> dict | None:
    """{span name: idle seconds} over the stretch; None where the trace
    has no stretch or no device activity in it."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    return reduce_events(events)


def reduce_events(events) -> dict | None:
    stretch = [e for e in events if e.get("name") == STRETCH
               and e.get("ph") == "X"]
    if not stretch:
        return None
    w0 = stretch[0]["ts"]
    w1 = w0 + stretch[0]["dur"]
    busy, ranges = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS and w0 <= e["ts"] < w1:
            busy.append((e["ts"], min(w1, e["ts"] + e["dur"])))
        elif cat == "user_annotation" and e.get("dur", 0) > 0 and \
                e.get("name", "").startswith(PREFIX):
            ranges.append((e["ts"], e["ts"] + e["dur"], e["name"]))
    if not busy:
        return None
    gaps, prev = [], w0
    for s, e in sorted(busy) + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    # sweep the ranges' starts and ends: the innermost open range is the
    # one that started last (the longer first where two start together)
    marks = sorted([(a, 1, -(b - a), i) for i, (a, b, _) in
                    enumerate(ranges)] +
                   [(b, 0, 0, i) for i, (_, b, _) in enumerate(ranges)])
    out: dict = {}
    open_: list = []
    k = 0
    for g0, g1 in gaps:
        t = g0
        while True:
            while k < len(marks) and marks[k][0] <= t:
                _, starts, _, i = marks[k]
                if starts:
                    open_.append(i)
                else:
                    open_.remove(i)
                k += 1
            nxt = min(g1, marks[k][0]) if k < len(marks) else g1
            name = ranges[open_[-1]][2] if open_ else ""
            out[name] = out.get(name, 0.0) + (nxt - t) * 1e-6
            if nxt >= g1:
                break
            t = nxt
    return out


def shallow_share(by_span: dict) -> float:
    """The share of the idle time under no span deeper than the call's
    root (under ``advntr.call`` itself, or under no span), in %."""
    total = sum(by_span.values())
    if total <= 0:
        return 0.0
    return (by_span.get(ROOT, 0.0) + by_span.get("", 0.0)) / total * 100
