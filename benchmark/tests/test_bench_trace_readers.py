"""The readers of the program's own spans and counters (``tpurt_torch.trace``)
on hand-made trace events: a step whose backward waits on the window's
thread while the autograd engine launches from another, a frame's shading,
and a trace of a program without the spans, where every reader reads None."""
import sys

import pytest
import torch

from benchmark import harness, spans
from benchmark.tests.tiny import ROOT
from benchmark.trace import Trace
from tpurt_torch import trace as program_trace

MAIN, ENGINE = 1, 2
NEW = ("backward_host_ms.step", "backward_idle_ms.step", "segsum_sort_ms.step",
       "segsum_live_pct.step", "step_launches.step", "shade_launches.frame",
       "unspanned_idle_pct.step", "unspanned_idle_pct.frame", "prepare_build_s")


def _reader(name):
    return harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                               f"test_reader_{name.replace('.', '_')}")


def _span(name, ts, end, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": end - ts,
            "tid": tid}


def _op(name, ts, end, tid):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": end - ts, "tid": tid}


def _kernel(ts, end, launch_ts, tid, corr, name="k"):
    """A kernel on card 0 and the runtime call that launched it."""
    return [{"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": end - ts,
             "args": {"device": 0, "correlation": corr}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch_ts,
             "dur": 1, "tid": tid, "args": {"correlation": corr}}]


def _step_events(with_program_spans=True):
    """Two steps in a window [0, 1000) µs.  Step 1: [10, 400); its render
    [20, 150) launches two kernels from the window's thread, its backward
    [200, 390) waits while the engine's thread evaluates [210, 380): the
    sort [250, 262) launches one kernel, K8 another, and a plain node one
    more; the update [392, 398).  Step 2: [500, 900), backward [700, 890),
    one kernel from the engine.  A kernel launched by the engine outside any
    step (at 950) counts for no step."""
    ev = [_span("bench.window", 0, 1000)]
    if with_program_spans:
        ev += [_span("tpurt.step", 10, 400), _span("tpurt.render", 20, 150),
               _span("tpurt.backward", 200, 390), _span("tpurt.update", 392, 398),
               _span("tpurt.segsum.sort", 250, 262, ENGINE),
               _span("tpurt.segsum.kernel", 262, 270, ENGINE),
               _span("tpurt.step", 500, 900), _span("tpurt.backward", 700, 890)]
    ev += [_op("autograd::engine::evaluate_function: MulBackward0", 210, 380, ENGINE),
           _op("autograd::engine::evaluate_function: MulBackward0", 710, 880, ENGINE),
           _op("autograd::engine::evaluate_function: MulBackward0", 940, 960, ENGINE)]
    ev += _kernel(30, 60, 25, MAIN, 1) + _kernel(60, 100, 40, MAIN, 2)
    ev += _kernel(255, 275, 255, ENGINE, 3, "sort") + _kernel(280, 300, 265, ENGINE, 4)
    ev += _kernel(320, 340, 300, ENGINE, 5)
    ev += _kernel(720, 800, 715, ENGINE, 6) + _kernel(955, 970, 950, ENGINE, 7)
    return ev


def _ctx(events, mode, calls=2):
    return harness.Context(cell="test", mode=mode, config={}, nominal_rays=1, setup_s=1.0,
                           window_s=1.0, call_s=[0.5] * calls, trace=Trace(events),
                           traced_calls=calls)


def test_the_interval_helpers():
    assert spans.union([(5, 7), (0, 2), (1, 3), (9, 9)]) == [[0, 3], [5, 7]]
    assert spans.intersect([[0, 3], [5, 9]], [[2, 6], [8, 20]]) == [[2, 3], [5, 6], [8, 9]]
    assert spans.clip([(-5, 2), (4, 12)], (0, 10)) == [[0, 2], [4, 10]]
    assert spans.length([[0, 2], [4, 10]]) == 8


def test_backward_host_and_idle_ms():
    ctx = _ctx(_step_events(), "step")
    # host: (190 + 190) µs over two steps
    assert _reader("backward_host_ms.step").read(ctx) == pytest.approx(0.19)
    # busy inside the backwards: [255, 275), [280, 300) and [320, 340) in
    # the first, [720, 800) in the second: idle 190 - 60 + 190 - 80 µs
    assert _reader("backward_idle_ms.step").read(ctx) == pytest.approx(0.240 / 2)


def test_segsum_sort_ms_reads_the_engine_thread():
    # the sort's span is on the engine's thread, and only its kernel counts
    assert _reader("segsum_sort_ms.step").read(_ctx(_step_events(), "step")) == \
        pytest.approx(0.020 / 2)


def test_step_launches_count_the_engine_inside_a_step():
    # 2 from the window's thread, 3 + 1 from the engine inside the steps; the
    # engine's launch at 950 is outside both
    assert _reader("step_launches.step").read(_ctx(_step_events(), "step")) == 3.0


@pytest.mark.parametrize("mode", ["step", "frame"])
def test_unspanned_idle_pct(mode):
    events = [dict(e, name="tpurt.render") if e.get("name") == "tpurt.step" else e
              for e in _step_events()] if mode == "frame" else _step_events()
    # covered: the spans on the window's thread, [10, 400) and [500, 900),
    # and the kernel at 955: 790 + 15 µs of 1000
    assert _reader(f"unspanned_idle_pct.{mode}").read(_ctx(events, mode)) == \
        pytest.approx(100.0 * (1000 - 805) / 1000)


def test_shade_launches_per_frame():
    ev = [_span("bench.window", 0, 1000), _span("tpurt.shade", 100, 300),
          _span("tpurt.shade", 600, 800)]
    ev += _kernel(110, 120, 105, MAIN, 1) + _kernel(130, 150, 110, MAIN, 2)
    ev += _kernel(620, 640, 610, MAIN, 3) + _kernel(400, 410, 400, MAIN, 4)
    assert _reader("shade_launches.frame").read(_ctx(ev, "frame")) == 1.5


def test_segsum_live_pct_reads_the_counters(monkeypatch):
    program_trace.reset()
    try:
        monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
        program_trace.count("segsum.entries", 400)
        program_trace.count("segsum.live", torch.tensor(100))
        program_trace.count("segsum.live", 200)
        assert _reader("segsum_live_pct.step").read(_ctx(_step_events(), "step")) == 75.0
    finally:
        program_trace.reset()


def test_prepare_build_s_reads_the_gauge(monkeypatch):
    monkeypatch.setitem(program_trace.prepare_seconds, "build", 7.5)
    monkeypatch.setitem(program_trace.prepare_seconds, "tree", 2.25)
    assert _reader("prepare_build_s").read(_ctx(_step_events(), "step")) == 9.75


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_spans_reads_none(name, monkeypatch):
    """The parent of the spans: no ``tpurt.*`` span in the trace and no
    ``tpurt_torch.trace`` to import."""
    monkeypatch.setitem(sys.modules, "tpurt_torch.trace", None)
    monkeypatch.delattr(sys.modules["tpurt_torch"], "trace", raising=False)
    mode = "frame" if name.endswith(".frame") else "step"
    assert _reader(name).read(_ctx(_step_events(with_program_spans=False), mode)) is None
