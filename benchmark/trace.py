"""Reading a ``torch.profiler`` trace of the traced window: device
activity, host spans and which host code launched each kernel.

A kernel is attributed to a host interval (a span the benchmark put around
a call, or the autograd engine's evaluation of a backward function) when
the runtime call that launched it ran inside that interval on the same
thread.  Device time is summed over kernels and copies on the first card.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ENGINE_PREFIX = "autograd::engine::evaluate_function"
WINDOW_SPAN = "bench.window"


class Intervals:
    """A union of [start, end) intervals, for containment tests."""

    def __init__(self, pairs):
        merged = []
        for s, e in sorted(pairs):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]

    def contains(self, t) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


class Trace:
    def __init__(self, events: list):
        launch = {}
        spans = collections.defaultdict(list)
        engine = collections.defaultdict(list)
        host = collections.defaultdict(list)
        self.device = []
        device_ids = set()
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            args = ev.get("args", {})
            if cat in DEVICE_CATS:
                dev = args.get("device", 0)
                device_ids.add(dev)
                self.device.append((ev["ts"], ev["ts"] + ev.get("dur", 0), ev["name"],
                                    args.get("correlation"), dev))
            elif cat in ("cuda_runtime", "cuda_driver"):
                if "correlation" in args:
                    launch[args["correlation"]] = (ev["ts"], ev.get("tid"))
            elif cat == "user_annotation":
                spans[ev["name"]].append((ev["ts"], ev["ts"] + ev.get("dur", 0), ev.get("tid")))
                host[ev.get("tid")].append((ev["ts"], ev["ts"] + ev.get("dur", 0), ev["name"]))
            elif cat == "cpu_op":
                host[ev.get("tid")].append((ev["ts"], ev["ts"] + ev.get("dur", 0), ev["name"]))
                if ev["name"].startswith(ENGINE_PREFIX):
                    engine[ev.get("tid")].append((ev["ts"], ev["ts"] + ev.get("dur", 0)))
        first = min(device_ids) if device_ids else 0
        self.device = [d for d in self.device if d[4] == first]
        self.launch = launch
        self.spans = dict(spans)
        self.engine = {tid: Intervals(p) for tid, p in engine.items()}
        self.host = {tid: sorted(v) for tid, v in host.items()}
        win = self.spans.get(WINDOW_SPAN, [])
        self.window = (min(s for s, _, _ in win), max(e for _, e, _ in win)) if win else None
        self.main_tid = win[0][2] if win else None

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.remove(path)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    # -- what readers ask ------------------------------------------------------

    def _in_window(self):
        lo, hi = self.window
        return [d for d in self.device if d[1] > lo and d[0] < hi]

    def kernel_seconds(self, match) -> tuple:
        """(seconds, launches) of device work in the window whose name
        satisfies `match`."""
        ds = [d for d in self._in_window() if match(d[2])]
        return sum(e - s for s, e, *_ in ds) * 1e-6, len(ds)

    def launched_in(self, intervals_of_tid) -> tuple:
        """(seconds, launches) of device work in the window launched inside
        the host intervals `intervals_of_tid` ({tid: Intervals})."""
        total, n = 0.0, 0
        for s, e, _, corr, _ in self._in_window():
            where = self.launch.get(corr)
            if where is None:
                continue
            iv = intervals_of_tid.get(where[1])
            if iv is not None and iv.contains(where[0]):
                total += e - s
                n += 1
        return total * 1e-6, n

    def span_intervals(self, name) -> dict:
        by_tid = collections.defaultdict(list)
        for s, e, tid in self.spans.get(name, []):
            by_tid[tid].append((s, e))
        return {tid: Intervals(p) for tid, p in by_tid.items()}

    def span_seconds(self, name) -> float:
        lo, hi = self.window
        return sum(e - s for s, e, _ in self.spans.get(name, []) if s >= lo and e <= hi) * 1e-6

    def busy_window(self) -> tuple:
        """(busy seconds, window seconds): the union of device work clipped
        to the window, and the window's length."""
        lo, hi = self.window
        iv = Intervals([(max(s, lo), min(e, hi)) for s, e, *_ in self._in_window()])
        busy = sum(e - s for s, e in zip(iv.starts, iv.ends))
        return busy * 1e-6, (hi - lo) * 1e-6

    def breakdown(self, top=10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by what the host's main thread was inside at each gap."""
        ops = collections.Counter()
        for s, e, name, *_ in self._in_window():
            ops[name[:160]] += (e - s) * 1e-6
        lo, hi = self.window
        iv = Intervals([(max(s, lo), min(e, hi)) for s, e, *_ in self._in_window()])
        gaps = []
        prev = lo
        for s, e in zip(iv.starts, iv.ends):
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if hi > prev:
            gaps.append((prev, hi))
        host = self.host.get(self.main_tid, [])
        starts = [h[0] for h in host]
        idle = collections.Counter()
        for s, e in gaps:
            idle[self._host_at(host, starts, (s + e) / 2)] += (e - s) * 1e-6
        return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
                "idle_gaps": [[k, v] for k, v in idle.most_common(top)]}

    @staticmethod
    def _host_at(host, starts, t) -> str:
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 200, -1), -1):
            s, e, name = host[j]
            if s <= t <= e and name != WINDOW_SPAN:
                return name[:160]
        return "host, outside any op"
