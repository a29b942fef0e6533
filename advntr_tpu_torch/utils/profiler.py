"""Spans and counters inside the port's layers.

``span(name, **attrs)`` times a block, as a context manager or as a
decorator, on ``time.perf_counter()`` (the clock the benchmark's own spans
read), and nests: a span opened inside another is its child.
``count(name, n)`` adds to a counter of the innermost open span's call.

Always on: each ``genotype`` call, the root span ``advntr.call``, keeps its
``Totals``: per span name the number of spans, their seconds and their
self seconds (each span's time less its children's), and each counter.
``stage_summary`` formats them, the operator's summary that the CLI logs
at INFO at the end of every call; the totals of the last ``HISTORY`` calls
stay readable through ``finished_calls``.  Spans outside any call add to
the ambient totals (``ambient``).  A span costs two clock reads and a dict
update.

Only after ``enable(records=True)`` is each span also kept as a ``Record``
(its name, start and end, its id, its parent's id, its call's id, the
locus's ``vid`` where it or a parent has one, its attributes), read with
``records()``; with ``annotate=True`` each span also opens a
``torch.profiler.record_function`` range of its name, so that the spans
lie in a profiler trace beside the kernels they launched.  Off, a span
makes no torch call and keeps no record.  Each process keeps its own: the
spans of a model-building worker stay in the worker.
"""

from __future__ import annotations

import collections
import functools
import itertools
import time

PREFIX = "advntr."
CALL = "advntr.call"
HISTORY = 64

Record = collections.namedtuple(
    "Record", "name t0 t1 id parent call vid attrs")


class Totals:
    """One call's totals (``call`` None: the spans outside any call).
    ``spans`` maps a name to [spans, seconds, self seconds]."""

    __slots__ = ("call", "t0", "t1", "spans", "counters")

    def __init__(self, call=None):
        self.call, self.t0, self.t1 = call, None, None
        self.spans: dict[str, list] = {}
        self.counters: dict[str, int] = {}


_clock = time.perf_counter
_call_ids = itertools.count(1)
_span_ids = itertools.count(1)
_stack: list = []
_ambient = Totals()
_finished: collections.deque = collections.deque(maxlen=HISTORY)
_records: list | None = None
_range = None        # torch.profiler.record_function while annotating


class span:
    """A timed block named ``advntr.<layer>...``; ``vid=`` names the locus
    (children inherit it), other keyword attributes go into its record."""

    __slots__ = ("name", "attrs", "id", "parent", "totals", "vid", "child",
                 "t0", "_open_range")

    def __init__(self, name: str, **attrs):
        if not name.startswith(PREFIX):
            raise ValueError(f"span names start with {PREFIX!r}: {name!r}")
        self.name = name
        self.attrs = attrs

    def __call__(self, fn):
        name, attrs = self.name, self.attrs

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name, **attrs):
                return fn(*args, **kwargs)
        return wrapper

    def __enter__(self):
        parent = _stack[-1] if _stack else None
        self.parent = parent
        self.child = 0.0
        if self.name == CALL:
            self.totals = Totals(next(_call_ids))
        else:
            self.totals = parent.totals if parent is not None else _ambient
        self.vid = self.attrs.get("vid", parent.vid if parent else None)
        self.id = next(_span_ids) if _records is not None else None
        self._open_range = None
        if _range is not None:
            self._open_range = _range(self.name)
            self._open_range.__enter__()
        _stack.append(self)
        self.t0 = _clock()
        if self.name == CALL:
            self.totals.t0 = self.t0
        return self

    def __exit__(self, *exc) -> bool:
        t1 = _clock()
        if _stack and _stack[-1] is self:
            _stack.pop()
        elif self in _stack:
            _stack.remove(self)
        dur = t1 - self.t0
        row = self.totals.spans.get(self.name)
        if row is None:
            row = self.totals.spans[self.name] = [0, 0.0, 0.0]
        row[0] += 1
        row[1] += dur
        row[2] += dur - self.child
        if self.parent is not None:
            self.parent.child += dur
        if self._open_range is not None:
            self._open_range.__exit__(None, None, None)
        if _records is not None:
            _records.append(Record(
                self.name, self.t0, t1, self.id,
                self.parent.id if self.parent is not None else None,
                self.totals.call, self.vid, self.attrs))
        if self.name == CALL:
            self.totals.t1 = t1
            _finished.append(self.totals)
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to a counter of the innermost open span's call."""
    t = _stack[-1].totals if _stack else _ambient
    t.counters[name] = t.counters.get(name, 0) + n


def enable(records: bool = True, annotate: bool = False) -> None:
    """Keep each span's record from now on (the records so far are
    dropped); with ``annotate``, open a profiler range of each span."""
    global _records, _range
    _records = [] if records else None
    if annotate:
        from torch.profiler import record_function
        _range = record_function
    else:
        _range = None


def disable() -> None:
    """Back to the always-on totals alone."""
    global _records, _range
    _records, _range = None, None


def records() -> list:
    """The records kept since ``enable``, in the order the spans ended."""
    return list(_records or ())


def finished_calls() -> list:
    """The totals of the last ``HISTORY`` finished calls, oldest first."""
    return list(_finished)


def ambient() -> Totals:
    return _ambient


def reset() -> None:
    """Forget the finished calls, the ambient totals and the records."""
    global _ambient
    _finished.clear()
    _ambient = Totals()
    if _records is not None:
        _records.clear()


def stage_summary(totals: Totals | None = None) -> str:
    """The operator's summary of one call (by default the last finished
    one): each span's count, seconds and self seconds, longest first, then
    the counters."""
    t = totals if totals is not None else \
        (_finished[-1] if _finished else _ambient)
    if t.call is None:
        head = "stage timing (outside a call):"
    elif t.t1 is None:
        head = f"stage timing (call {t.call}, open):"
    else:
        head = f"stage timing (call {t.call}, {t.t1 - t.t0:.3f}s):"
    lines = [head]
    for name, (n, total, own) in sorted(t.spans.items(),
                                        key=lambda kv: -kv[1][1]):
        lines.append(f"  {name}: {total:.3f}s over {n} spans, "
                     f"self {own:.3f}s")
    for name, value in sorted(t.counters.items()):
        lines.append(f"  {name}: {value}")
    return "\n".join(lines)
