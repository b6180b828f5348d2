"""The reader of ``shade_fused_pct.frame``: the share of shaded pixels that
K11 shaded, from the program's counters, and None from a program that keeps
no such counters (the parent of K11) or has no ``tpurt_torch.trace``."""
import sys

import pytest
import torch

from benchmark.tests.test_bench_trace_readers import _ctx, _reader, _span
from tpurt_torch import trace as program_trace

NAME = "shade_fused_pct.frame"


def _frames():
    return [_span("bench.window", 0, 1000), _span("tpurt.shade", 100, 300)]


@pytest.fixture
def counting(monkeypatch):
    program_trace.reset()
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    yield program_trace.count
    program_trace.reset()


@pytest.mark.parametrize("pixels,fused,want", [(800, 800, 100.0), (800, 200, 25.0),
                                               (800, 0, 0.0), (0, 0, None)])
def test_reads_fused_over_shaded_pixels(counting, pixels, fused, want):
    counting("shade.pixels", pixels)
    counting("shade.fused", fused)
    assert _reader(NAME).read(_ctx(_frames(), "frame")) == want
    assert _reader(NAME).read(_ctx(_frames(), "step")) is None


def test_a_program_without_the_counters_reads_none(counting, monkeypatch):
    counting("segsum.entries", 5)
    monkeypatch.setattr(program_trace, "COUNTERS", ("segsum.entries", "segsum.live"))
    assert _reader(NAME).read(_ctx(_frames(), "frame")) is None
    monkeypatch.setitem(sys.modules, "tpurt_torch.trace", None)
    monkeypatch.delattr(sys.modules["tpurt_torch"], "trace", raising=False)
    assert _reader(NAME).read(_ctx(_frames(), "frame")) is None
