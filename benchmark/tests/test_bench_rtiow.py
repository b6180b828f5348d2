"""The cell rtiow_frame (the final scene of "Ray Tracing in One Weekend" on the
phase-1 plan) on the CPU at a tiny size, and its two readers on hand-made
trace events: K1's device ms a frame (``megakernel_ms.frame``) and K1's
share of its roofline (``k1_roofline.frame``), which reads None where the
program's counters disagree with the configuration or are missing."""
import json
import sys

import pytest
import torch

from benchmark import check, faults, harness
from benchmark.reference import tracer
from benchmark.tests.test_bench_trace_readers import MAIN, _kernel, _span
from benchmark.tests.tiny import ROOT, tiny_root
from benchmark.trace import Trace
from tpurt_torch import trace as program_trace

SEED = 2**31 + 777
CELL = "rtiow_frame"
#: the tiny size: big enough that the orbit's next pose moves pixels
TINY = "45x80"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tiny_root(tmp_path_factory.mktemp("bench"))
    path = r / "benchmark" / "configs" / "rtiow_final_spheres.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), resolution=TINY)))
    return r


def _run(root, program=None, trace=False):
    return harness.run(root, CELL, SEED, 0.3, trace, device="cpu", program=program,
                       log=lambda *a, **k: None)


def test_sound_traced_run_is_correct(root):
    out = _run(root, trace=True)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    # the pack's host span reads on the CPU; the device readers find no kernel
    assert "pack_host_ms.frame" in out["metrics"]
    assert not {"megakernel_ms.frame", "k1_roofline.frame"} & set(out["metrics"])


@pytest.mark.parametrize("fault", ["stale", "block"])
def test_a_broken_frame_is_not_correct(root, fault):
    out = _run(root, program=getattr(faults, fault)())
    assert not out["correct"], out["checks"]


def test_the_control_is_not_correct(root):
    bench = harness.Bench(root)
    cfg = bench.json("configs", "rtiow_final_spheres.json")
    limits = bench.json("workloads", f"{CELL}.json")["limits"]
    arrays = bench.scene_arrays(cfg)
    h, w = (int(x) for x in cfg["resolution"].split("x"))
    with torch.no_grad():
        ref = tracer.render(harness.ref_scene(arrays, "cpu"), h, w, cfg["max_depth"], True)
        low = tracer.render(harness.ref_scene(arrays, "cpu", torch.bfloat16), h, w,
                            cfg["max_depth"], True)
    numbers = check.frame_numbers(low, ref)
    assert any(numbers[n] > limits[n] for n in numbers), numbers


def _reader(name):
    return harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                               f"test_rtiow_reader_{name.replace('.', '_')}")


CONFIG = {"triangles": 0, "spheres": 487, "lights": 2, "shadows": True, "max_depth": 2}
N_PIX = 1000
#: path counts of a frame of N_PIX pixels: 1,000 primary rays, 200 reflected
COUNTS = {"rays": [1000, 200, 10], "shaded_tri": [0, 0, 0], "shaded_sph": [900, 150, 5],
          "blocked": [300, 40, 2]}


def _frames():
    """Two frames in a window [0, 1000) µs, each a ``tpurt.megakernel`` span
    that launches K1 (40 µs), and a pack kernel outside the span."""
    ev = [_span("bench.window", 0, 1000), _span("tpurt.megakernel", 100, 200),
          _span("tpurt.megakernel", 600, 700)]
    ev += _kernel(120, 160, 110, MAIN, 1, "void tpurt::megakernel_fwd(tpurt::Scene)")
    ev += _kernel(620, 660, 610, MAIN, 2, "void tpurt::megakernel_fwd(tpurt::Scene)")
    ev += _kernel(50, 90, 40, MAIN, 3, "pack")
    return ev


def _ctx(events, counts=COUNTS):
    return harness.Context(cell=CELL, mode="frame", config=CONFIG, nominal_rays=1, setup_s=1.0,
                           window_s=1.0, call_s=[0.5, 0.5], trace=Trace(events),
                           traced_calls=2, ref_counts=counts, n_pix=N_PIX)


@pytest.fixture
def counted(monkeypatch):
    """The program's counters as two traced K1 launches leave them."""
    program_trace.reset()
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)

    def count(prims, pixels=N_PIX, launches=2):
        for _ in range(launches):
            program_trace.count("megakernel.prims", prims)
            program_trace.count("megakernel.pixels", pixels)

    yield count
    program_trace.reset()


def test_megakernel_ms_reads_k1_in_its_span():
    # 40 µs of K1 in each frame's span; the pack kernel is outside it
    assert _reader("megakernel_ms.frame").read(_ctx(_frames())) == pytest.approx(0.040)


def test_k1_roofline_is_the_forward_work_over_k1s_time(counted):
    counted(1 + 487)
    reader = _reader("k1_roofline.frame")
    per_ray = 487 * 19 + 10
    ops = (1210 * per_ray + ((1055 * 2 - 342) * per_ray + 342 * (19 + 10))
           + 1055 * (37 + 13) + 1055 * 2 * 57)
    want = 100.0 * (ops / 67e12) / 40e-6
    assert reader.read(_ctx(_frames())) == pytest.approx(want)
    assert 0.0 < want < 100.0


@pytest.mark.parametrize("prims,pixels", [(487, N_PIX), (1 + 480, N_PIX), (1 + 487, N_PIX // 2)])
def test_k1_roofline_reads_none_where_the_counters_disagree(counted, prims, pixels):
    """A launch without the pad, one that dropped a sphere, and frames that
    sent half their pixels through K1."""
    counted(prims, pixels)
    assert _reader("k1_roofline.frame").read(_ctx(_frames())) is None


def test_k1_roofline_reads_none_without_the_counters(monkeypatch):
    """The parent of the counters: ``tpurt_torch.trace`` counts no
    ``megakernel.*``, or is missing."""
    program_trace.reset()
    reader = _reader("k1_roofline.frame")
    monkeypatch.setattr(program_trace, "COUNTERS", ("segsum.entries", "segsum.live"))
    assert reader.read(_ctx(_frames())) is None
    monkeypatch.setitem(sys.modules, "tpurt_torch.trace", None)
    monkeypatch.delattr(sys.modules["tpurt_torch"], "trace", raising=False)
    assert reader.read(_ctx(_frames())) is None
    assert _reader("megakernel_ms.frame").read(_ctx(_frames()[:1])) is None
