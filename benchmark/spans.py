"""The program's own spans (``tpurt_torch.trace``: names starting with
``tpurt.``) in a parsed trace (``trace.Trace``), for the readers in
``metrics/`` that read them: interval arithmetic on the profiler's clock
(microseconds), clipped to the traced window.

A trace of a program that has no such span gives empty lists, and the
readers then return None.
"""
from __future__ import annotations

PREFIX = "tpurt."


def union(pairs) -> list:
    """Sorted, disjoint [start, end] pairs covering `pairs`."""
    merged = []
    for s, e in sorted(pairs):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        elif e > s:
            merged.append([s, e])
    return merged


def length(pairs) -> float:
    return sum(e - s for s, e in pairs)


def intersect(a, b) -> list:
    """The intersection of two unions (``union``'s output)."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append([s, e])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def clip(pairs, window) -> list:
    lo, hi = window
    return union((max(s, lo), min(e, hi)) for s, e in pairs if e > lo and s < hi)


def busy(trace) -> list:
    """The union of the card's kernels and copies in the window."""
    return clip(((s, e) for s, e, *_ in trace.device), trace.window)


def on_main(trace, match) -> list:
    """The union of the spans on the window's thread whose name satisfies
    `match`, clipped to the window."""
    return clip(((s, e) for name, spans in trace.spans.items() if match(name)
                 for s, e, tid in spans if tid == trace.main_tid), trace.window)


def program_spans(trace) -> list:
    """Every ``tpurt.*`` span on the window's thread."""
    return on_main(trace, lambda name: name.startswith(PREFIX))


def named(trace, name) -> list:
    return on_main(trace, lambda n: n == name)


def engine_pairs(trace, tid) -> list:
    """The autograd engine's evaluations of backward functions on `tid`."""
    iv = trace.engine.get(tid)
    return [] if iv is None else [[s, e] for s, e in zip(iv.starts, iv.ends)]
