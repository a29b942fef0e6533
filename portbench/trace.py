"""Reduction of one ``torch.profiler`` trace (CPU and CUDA activity) of a
traced stretch of the window: the device's busy time, the kernels each of
the harness's layers launched, the operations that took the most device
time, and the longest idle gaps labelled with the layer that was open on
the host."""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STRETCH = "portbench.traced"


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _total(merged) -> float:
    return sum(e - s for s, e in merged)


def reduce_trace(path: str, layers) -> dict | None:
    """Times in seconds; None where the trace holds no device activity."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    stretch = [e for e in events if e.get("name") == STRETCH
               and e.get("ph") == "X"]
    if not stretch:
        return None
    w0 = stretch[0]["ts"]
    w1 = w0 + stretch[0]["dur"]
    device, launch_ts, spans = [], {}, {name: [] for name in layers}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = e["ts"]
        elif cat == "user_annotation" and e.get("name") in spans:
            spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    device = [e for e in device if w0 <= e["ts"] < w1]
    if not device:
        return None
    busy = _merge([(e["ts"], min(w1, e["ts"] + e["dur"])) for e in device])
    by_layer = {name: [] for name in layers}
    ops: dict[str, float] = {}
    for e in device:
        ops[e["name"]] = ops.get(e["name"], 0.0) + e["dur"]
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        if ts is None:
            continue
        for name, ivs in spans.items():
            if any(s <= ts <= t for s, t in ivs):
                by_layer[name].append((e["ts"], e["ts"] + e["dur"]))
    gaps = []
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    labelled = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (s + e) / 2
        open_ = [(t - a, name) for name, ivs in spans.items()
                 for a, t in ivs if a <= mid <= t]
        label = min(open_)[1] if open_ else "engine"
        labelled.append([label, (e - s) * 1e-6])
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": _total(busy) * 1e-6,
        "layer_device_s": {name: _total(_merge(ivs)) * 1e-6
                           for name, ivs in by_layer.items()},
        "device_ops": [[name, dur * 1e-6] for name, dur in
                       sorted(ops.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": labelled,
    }
