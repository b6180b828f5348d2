"""Spans and counters of the port, on the profiler's clock.

A span marks a layer of the work (``span("tpurt.records")``): while a
``torch.profiler`` profile records, it enters ``record_function(name)``, so
it lands in the same trace as the card's kernels, on the same clock, and
nests in the span that was open on its thread when it began.  With no
profiler recording it costs one attribute read and enters nothing.  Span
names start with ``tpurt.``; ``README.md`` lists them and what each covers.

Counters (``count``) add up only while a profiler records, so their totals
cover the traced calls; ``snapshot`` reads them (and waits for the card,
once, where a counter is kept in a device tensor) and ``reset`` zeroes them.

The one host-clock record is ``prepare_seconds``: the seconds of the two
phases of the last ``render.prepare``, written always, since ``prepare``
runs once, before any profiler.
"""
from __future__ import annotations

import functools
import threading

import torch
from torch.autograd import profiler as _profiler

#: every counter: stream lengths of the segment sum (``segsum_rows``), and
#: the entries among them whose index lies in [0, n_rows)
COUNTERS = ("segsum.entries", "segsum.live")

_counts: dict = {}
_lock = threading.Lock()

#: host seconds of the last ``render.prepare``: "build" (the C++ cluster or
#: grid build) and "tree" (the upper level, the slot order, the upload)
prepare_seconds: dict = {}


def recording() -> bool:
    """Whether a profiler records now."""
    return _profiler._is_profiler_enabled


class span:
    """``with span(name):`` or ``@span(name)``: a ``record_function`` span
    while a profiler records, nothing otherwise."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        rf, self._rf = self._rf, None
        if rf is not None:
            rf.__exit__(*exc)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapped


def count(name: str, n) -> None:
    """Add `n` (an int, or a tensor kept on its device) to counter `name`
    while a profiler records."""
    if not _profiler._is_profiler_enabled:
        return
    if name not in COUNTERS:
        raise KeyError(f"no counter named {name!r}; the counters are {COUNTERS}")
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def snapshot() -> dict:
    """Every counter's total since the last reset, as ints."""
    with _lock:
        return {name: int(_counts.get(name, 0)) for name in COUNTERS}


def reset() -> None:
    with _lock:
        _counts.clear()
