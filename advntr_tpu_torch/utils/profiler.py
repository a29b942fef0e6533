"""Stage timing: the reference logs wall time per stage via a decorator
(advntr/profiler.py:5-13).  Here the same decorator also aggregates stage
totals for the run summary, and an optional torch.profiler trace can wrap
a whole run."""

from __future__ import annotations

import contextlib
import functools
import logging
import time
from collections import defaultdict

STAGE_TOTALS: dict[str, float] = defaultdict(float)
STAGE_COUNTS: dict[str, int] = defaultdict(int)


def time_usage(func):
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        beg = time.time()
        result = func(*args, **kwargs)
        elapsed = time.time() - beg
        STAGE_TOTALS[func.__name__] += elapsed
        STAGE_COUNTS[func.__name__] += 1
        logging.debug("%s executed in %.4fs", func.__name__, elapsed)
        return result
    return wrapper


def stage_summary() -> str:
    lines = ["stage timing:"]
    for name, total in sorted(STAGE_TOTALS.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {name}: {total:.3f}s over {STAGE_COUNTS[name]} calls")
    return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """Optionally capture a torch.profiler trace around a block; the
    Chrome trace lands in ``log_dir``.  When a CUDA device is in use the
    block ends on ``torch.cuda.synchronize()``, so the trace holds every
    kernel the block launched."""
    if not log_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile
    on_cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU]
    if on_cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if on_cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
