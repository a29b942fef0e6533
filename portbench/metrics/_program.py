"""The program's own spans and counters over the window, for the readers of
``program_span`` and ``program_counter`` metrics: the totals that the port
keeps of each ``genotype`` call (``advntr_tpu_torch.utils.profiler``), summed
over the calls that started inside the window.  Spans are keyed by name to
[spans, seconds, self seconds]."""

from __future__ import annotations


def totals(ctx) -> dict | None:
    """{"spans": ..., "counters": ...} of the window's calls; None where
    the window finished no locus, or the port keeps no such totals."""
    if not ctx.get("loci"):
        return None
    try:
        from advntr_tpu_torch.utils import profiler
        calls = profiler.finished_calls()
    except (ImportError, AttributeError):
        return None
    spans: dict = {}
    counters: dict = {}
    for call in calls:
        if not ctx["t0"] <= call.t0 < ctx["t_end"]:
            continue
        for name, row in call.spans.items():
            acc = spans.setdefault(name, [0, 0.0, 0.0])
            for i, v in enumerate(row):
                acc[i] += v
        for name, n in call.counters.items():
            counters[name] = counters.get(name, 0) + n
    if not spans:
        return None
    return {"spans": spans, "counters": counters}


def span_ms_per_locus(ctx, name: str):
    """Seconds in the spans of ``name`` per finished locus, in ms."""
    t = totals(ctx)
    if t is None or name not in t["spans"]:
        return None
    return t["spans"][name][1] / ctx["loci"] * 1e3
