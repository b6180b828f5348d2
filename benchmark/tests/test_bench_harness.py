"""The harness on the CPU at tiny sizes: it finds cells, configurations,
traffic and metrics by name, a sound run comes out correct, and a run
whose timed path is broken underneath comes out not correct."""
import json
import subprocess
import sys
import types

import pytest
import torch

from benchmark import check, faults, harness
from benchmark.reference import tracer
from benchmark.tests.tiny import ROOT, tiny_root

SEED = 2**31 + 12345


def _run(root, cell, program=None, trace=False, seconds=0.3):
    return harness.run(root, cell, SEED, seconds, trace, device="cpu", program=program,
                       log=lambda *a, **k: None)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["c5_step", "c5_frame", "c3_step", "c5_step.mesh4"])
def test_sound_run_is_correct(root, cell):
    out = _run(root, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) >= {"setup_s"}


def test_traced_run_reads_spans(root):
    out = _run(root, "c5_frame", trace=True)
    assert out["correct"]
    assert "pack_host_ms.frame" in out["metrics"]  # a host span: read on the CPU too
    assert {"busy_s", "window_s"} <= set(out["device"])


def test_finds_a_throwaway_cell_config_and_metric(tmp_path):
    r = tiny_root(tmp_path)
    b = r / "benchmark"
    cfg = json.loads((b / "configs" / "config5_multimesh.json").read_text())
    cfg.update(n_blobs=1, subdiv=1, resolution="24x32")
    (b / "configs" / "tiny_blob.json").write_text(json.dumps(cfg))
    (b / "traffic" / "slow_orbit.json").write_text(json.dumps(
        {"kind": "orbit", "deg_per_frame": 0.1, "deg_offset_per_rev": 0.01, "frames_kept": 1}))
    (b / "workloads" / "tiny_frame.json").write_text(json.dumps(
        {"limits": json.loads((b / "workloads" / "c5_frame.json").read_text())["limits"]}))
    (b / "metrics" / "frames_done.py").write_text(
        "def read(ctx):\n    return float(len(ctx.call_s))\n")
    spec = json.loads((r / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_blob", "source": "test", "file": "x", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "tiny_frame", "config": "tiny_blob",
                              "traffic": "slow_orbit", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "frames_done", "unit": "frames", "better": "higher",
                               "bound": 0.1, "source": "host_clock",
                               "workloads": ["tiny_frame"]})
    (r / "BENCHMARK.json").write_text(json.dumps(spec))
    out = _run(r, "tiny_frame")
    assert out["correct"]
    assert out["metrics"]["frames_done"]["value"] == out["attempted"]
    assert "frame_Mrays_s" not in out["metrics"]  # listed for c5_frame alone


@pytest.mark.parametrize("cell,fault", [("c5_frame", "stale"), ("c5_frame", "block"),
                                        ("c5_step", "unchanged"), ("c5_step", "half"),
                                        ("c3_step", "unchanged"), ("c3_step", "half"),
                                        ("c5_step.mesh4", "no_exchange")])
def test_a_broken_timed_path_is_not_correct(root, cell, fault):
    # a cell on several chips builds its program in each rank, by name
    program = f"benchmark.faults:{fault}" if "mesh" in cell else getattr(faults, fault)()
    out = _run(root, cell, program=program)
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1


@pytest.mark.parametrize("cell", ["c5_frame", "c5_step", "c3_step"])
def test_the_control_is_not_correct(root, cell):
    """The reference computed in bfloat16, in the program's place, fails the
    cell's limits (the chip's readings at full size are in PERF.md)."""
    bench = harness.Bench(root)
    c = bench.cell(cell)
    cfg = bench.json("configs", f"{c['config']}.json")
    traffic = bench.json("traffic", f"{c['traffic']}.json")
    limits = bench.json("workloads", f"{cell}.json")["limits"]
    arrays = bench.scene_arrays(cfg)
    h, w = (int(x) for x in cfg["resolution"].split("x"))
    rc = {"h": h, "w": w, "max_depth": cfg["max_depth"], "shadows": cfg["shadows"]}
    if traffic["kind"] == "orbit":
        with torch.no_grad():
            ref = tracer.render(harness.ref_scene(arrays, "cpu"), h, w, cfg["max_depth"], True)
            low = tracer.render(harness.ref_scene(arrays, "cpu", torch.bfloat16), h, w,
                                cfg["max_depth"], True)
        numbers = check.frame_numbers(low, ref)
    else:
        start = harness.generate.inverse_starts(traffic, SEED, arrays, 1)[0]
        ref = check.reference_steps(harness.ref_scene(arrays, "cpu"),
                                    harness.ref_scene(arrays, "cpu", start=start), rc,
                                    traffic["lr"])
        low = check.reference_steps(harness.ref_scene(arrays, "cpu", torch.bfloat16),
                                    harness.ref_scene(arrays, "cpu", torch.bfloat16, start=start),
                                    rc, traffic["lr"])
        numbers = check.step_numbers(low, ref)[0]
    assert any(numbers[n] > limits[n] for n in numbers), numbers


def test_forbidden_module_stops_the_run(root, monkeypatch):
    monkeypatch.setitem(sys.modules, "tpurt", types.ModuleType("tpurt"))
    with pytest.raises(SystemExit):
        _run(root, "c3_step")


def test_command_without_the_program_prints_no_result(tmp_path):
    r = tiny_root(tmp_path)
    proc = subprocess.run([sys.executable, str(r / "benchmark" / "run.py"), "--workload",
                           "c3_step", "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                          cwd=r, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert not proc.stdout.strip()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["c5_frame", "c5_step"])
def test_command_on_the_card(card, cell):
    proc = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                           cell, "--seed", str(SEED), "--seconds", "2", "--trace", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["busy_s"] > 0
