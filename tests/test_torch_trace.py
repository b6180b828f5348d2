"""The port's spans and counters (tpurt_torch/trace.py) on the CPU: with no
profiler recording no span enters ``record_function`` and no counter
counts; under ``torch.profiler`` a clustered render and a train step leave
the spans in the profiler's own Chrome trace, nested by layer, and the
segment sum's counters equal its streams' lengths; ``prepare`` always sets
its gauge."""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpurt_torch
from tpurt_torch import trace
from tpurt_torch.dist.train import make_train_step
from tpurt_torch.kernels import segsum as TS
from tpurt_torch.scene import configs

LR = 0.005
#: span -> the span it runs in (on the one thread of a CPU run)
PARENT = {"tpurt.step": None, "tpurt.render": "tpurt.step", "tpurt.pack": "tpurt.render",
          "tpurt.records": "tpurt.render", "tpurt.shade": "tpurt.render",
          "tpurt.backward": "tpurt.step", "tpurt.segsum.sort": "tpurt.backward",
          "tpurt.segsum.kernel": "tpurt.backward", "tpurt.update": "tpurt.step"}


@pytest.fixture(scope="module")
def case():
    """A tiny config 5 (textured, two lights: three segment sums a step), its
    plan, its step and target, and the prepare gauge right after prepare."""
    scene, cfg = configs.config5_multimesh(12, 16, n_blobs=1, subdiv=1, device="cpu")
    trace.prepare_seconds.clear()
    plan = tpurt_torch.prepare(scene, cfg)
    gauge = dict(trace.prepare_seconds)
    step = make_train_step(cfg, plan=plan)
    target = tpurt_torch.render(scene, cfg, plan=plan) * 0.9
    return scene, cfg, plan, step, target, gauge


@pytest.fixture(scope="module")
def profiled(case, tmp_path_factory):
    """One train step under a CPU profiler: its Chrome trace's span events,
    the counters after it, and the streams segsum_rows handed the kernel's
    wrapper (length, in-range entries)."""
    scene, cfg, plan, step, target, _ = case
    streams = []
    wrapped = TS.sorted_segsum

    def spy(idx_sorted, upd, n_rows, order=None):
        streams.append((idx_sorted.numel(),
                        int(((idx_sorted >= 0) & (idx_sorted < n_rows)).sum())))
        return wrapped(idx_sorted, upd, n_rows, order)

    trace.reset()
    TS.sorted_segsum = spy
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(scene, target, LR)
        counts = trace.snapshot()
    finally:
        TS.sorted_segsum = wrapped
        trace.reset()
    path = tmp_path_factory.mktemp("trace") / "step.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith("tpurt.")]
    return spans, counts, streams


def test_no_profiler_enters_no_record_function(case, monkeypatch):
    scene, cfg, plan, step, target, _ = case
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    tpurt_torch.render(scene, cfg, plan=plan)
    step(scene, target, LR)
    assert entered == []
    assert trace.snapshot() == {name: 0 for name in trace.COUNTERS}


def _inside(inner, outer):
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


@pytest.mark.parametrize("name", sorted(PARENT))
def test_span_in_the_profilers_trace_nested_by_layer(profiled, name):
    spans, _, _ = profiled
    mine = [s for s in spans if s["name"] == name]
    assert mine, f"no {name} span in the trace"
    parent = PARENT[name]
    if parent is not None:
        outer = [s for s in spans if s["name"] == parent]
        assert all(any(_inside(s, o) for o in outer) for s in mine), (name, parent)


def test_a_step_holds_three_segment_sums(profiled):
    spans, _, streams = profiled
    assert len(streams) == 3   # the vertex, material and texel tables at depth 0
    for name in ("tpurt.segsum.sort", "tpurt.segsum.kernel"):
        assert sum(s["name"] == name for s in spans) == len(streams)


def test_counters_equal_the_streams_lengths(profiled):
    _, counts, streams = profiled
    assert counts == {"segsum.entries": sum(n for n, _ in streams),
                      "segsum.live": sum(live for _, live in streams)}
    assert 0 < counts["segsum.live"] < counts["segsum.entries"]   # background lanes drop


def test_prepare_sets_its_gauge(case):
    _, _, plan, _, _, gauge = case
    assert plan.kind == "clusters"
    assert set(gauge) == {"build", "tree"} and all(v > 0.0 for v in gauge.values())


def test_a_span_as_decorator_and_context_manager():
    @trace.span("tpurt.test")
    def twice(x):
        return 2 * x

    assert twice(3) == 6 and twice.__name__ == "twice"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert twice(4) == 8
        with pytest.raises(ValueError), trace.span("tpurt.test.raises"):
            raise ValueError("closes the span on the way out")
        trace.count("segsum.entries", 5)
        with pytest.raises(KeyError):
            trace.count("no.such.counter", 1)
    names = [e.key for e in prof.key_averages()]
    assert "tpurt.test" in names and "tpurt.test.raises" in names
    assert trace.snapshot()["segsum.entries"] == 5
    trace.reset()
    assert trace.snapshot()["segsum.entries"] == 0
