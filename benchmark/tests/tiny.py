"""A throwaway copy of the benchmark at tiny sizes, for CPU tests."""
import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SIZES = {"config5_multimesh": {"n_blobs": 2, "subdiv": 2, "resolution": "90x160"},
         "config3_spheres": {"resolution": "36x48"}}


#: at 90 × 160 pixels the camera leaves' SGD steps at the cells' learning
#: rate of 0.5 swing the third step's change by tens of %: the tiny copy
#: steps at a hundredth of it
TINY_LR = 0.005


def tiny_root(tmp: Path) -> Path:
    """`tmp` holding BENCHMARK.json and benchmark/ with every configuration
    cut to a tiny size and the inverse traffic at TINY_LR (the limits as
    committed)."""
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for name, sizes in SIZES.items():
        path = tmp / "benchmark" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(sizes)
        path.write_text(json.dumps(cfg))
    path = tmp / "benchmark" / "traffic" / "inverse.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), lr=TINY_LR)))
    _add_extra_cells(tmp)
    return tmp


#: cells whose limits are committed (``workloads/<cell>.json``) but which
#: BENCHMARK.json leaves out (PERF.md, section 7): their entry, the metrics
#: they report, and the per-layer metrics only they read
EXTRA_CELLS = {
    "c3_step": ({"config": "config3_spheres", "traffic": "inverse", "chips": 1},
                ["step_Mrays_s", "tail_p95_ms.step", "idle_pct.step", "pack_host_ms.step",
                 "backward_ms.step"],
                [{"name": "k4_roofline", "unit": "%", "better": "higher",
                  "source": "device_trace", "layer": "K4 l2_hand", "moves": "step_Mrays_s"}]),
    "c5_step.mesh4": ({"config": "config5_multimesh", "traffic": "inverse", "chips": 4},
                      ["step_Mrays_s", "tail_p95_ms.step", "idle_pct.step", "pack_host_ms.step",
                       "backward_ms.step", "traversal_ms.step", "segsum_ms.step"],
                      [{"name": "nccl_ms.step", "unit": "ms", "better": "lower",
                        "source": "device_trace", "layer": "mesh collectives",
                        "moves": "step_Mrays_s"}]),
}


def _add_extra_cells(tmp: Path):
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    listed = {w["name"] for w in spec["workloads"]}
    for name, (entry, metrics, own) in EXTRA_CELLS.items():
        if name in listed:
            continue
        spec["workloads"].append({"name": name, "why": "test", **entry})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if m["name"] in metrics and "workloads" in m:
                m["workloads"].append(name)
        spec["per_layer"] += [dict(m, workloads=[name]) for m in own]
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
