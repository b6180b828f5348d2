"""The port's benchmark command (tpurt_torch.tools.bench) on the CPU, where
the kernels' plain versions run, against the repo root's bench.py: the JSON
line has exactly bench.py's keys, each route calls the function bench.py
calls, and --mesh 2 and --scene-shard 2 run over gloo ranks (one spawn a
world, in a module fixture).  The ray counts against bench.py's are in
tests/test_torch_bench_counts.py."""
import ast
import contextlib
import io
import json
from pathlib import Path

import pytest
import torch

from tpurt_torch.tools import bench
import torch_one_thread  # noqa: F401  (one PyTorch thread)

REPO = Path(__file__).resolve().parents[1]


def _bench_py_keys(mode):
    """The keys of bench.py's final json.dumps, read from its source: the
    dict literal with "metric", and in fwdbwd the dict it spreads in."""
    tree = ast.parse((REPO / "bench.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    final = next(d for d in ast.walk(main) if isinstance(d, ast.Dict)
                 and any(isinstance(k, ast.Constant) and k.value == "metric" for k in d.keys))
    keys = [k.value for k in final.keys if k is not None]
    spread = {v.id for k, v in zip(final.keys, final.values) if k is None}
    extra = [k.value for n in ast.walk(main) if isinstance(n, ast.Assign)
             and isinstance(n.value, ast.Dict) and n.value.keys
             and any(isinstance(t, ast.Name) and t.id in spread for t in n.targets)
             for k in n.value.keys]
    assert spread and extra
    return keys + (extra if mode == "fwdbwd" else [])


def _spy(monkeypatch, owner, name, calls):
    real = getattr(owner, name)

    def spy(*a, **kw):
        calls.append((name, kw))
        return real(*a, **kw)

    monkeypatch.setattr(owner, name, spy)


@pytest.mark.parametrize("mode", ["fwd", "fwdbwd"])
@pytest.mark.parametrize("config", [1, 4])
def test_bench_main_prints_bench_py_keys(capsys, monkeypatch, config, mode):
    """One JSON line with exactly bench.py's keys; fwdbwd on phase-1 calls
    l2_loss_and_grad with hand=True (K4's plain version), on clusters
    render_and_grad (K5's and K8's)."""
    calls = []
    _spy(monkeypatch, bench.MK, "l2_loss_and_grad", calls)
    _spy(monkeypatch, bench, "render_and_grad", calls)
    record, launches = bench.main(["--config", str(config), "--mode", mode, "--device", "cpu",
                                   "--res", "16x16", "--iters", "1", "--warmup", "1"])
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line == record
    assert list(line) == _bench_py_keys(mode)
    assert line["metric"] == f"Mrays/s/chip {mode} config{config} 16x16"
    assert line["mesh"] is None and line["scene_shard"] is None and line["vs_baseline"] is None
    assert line["ms_per_frame"] > 0 and line["value"] > 0
    assert 0 < line["rays_traced"] <= line["rays_nominal"]
    if config == 1:
        assert line["rays_traced"] == line["rays_nominal"]
    else:
        assert line["rays_traced"] < line["rays_nominal"]
    steps = 2 if mode == "fwdbwd" else 0   # the first call and one chained call
    if config == 1:
        assert calls == [("l2_loss_and_grad", {"hand": True})] * steps
        assert launches.get("l2_hand_reference", 0) == steps
        assert "l2_fused_reference" not in launches
    else:
        assert [c[0] for c in calls] == ["render_and_grad"] * steps
        assert launches["trace_records_reference"] > 0
        assert (launches.get("sorted_segsum_reference", 0) > 0) == (mode == "fwdbwd")


def _main_quiet(argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        record, launches = bench.main(argv)
    assert json.loads(out.getvalue().splitlines()[-1]) == record
    return record, launches


@pytest.fixture(scope="module")
def mesh2():
    """bench.py's tests/test_api.py case: config 2 fwdbwd over two gloo ranks."""
    return _main_quiet(["--config", "2", "--res", "16x16", "--mesh", "2", "--backend", "gloo",
                        "--device", "cpu", "--iters", "1", "--warmup", "1"])


@pytest.fixture(scope="module")
def ring2():
    """Config 3 fwdbwd on the ring of two gloo ranks (its phase-1 plan becomes "bvh")."""
    return _main_quiet(["--config", "3", "--res", "16x16", "--scene-shard", "2",
                        "--backend", "gloo", "--device", "cpu", "--iters", "1",
                        "--warmup", "1"])


def test_bench_mesh_over_gloo_ranks(mesh2):
    record, launches = mesh2
    assert record["mesh"] == 2 and record["scene_shard"] is None
    assert record["ms_per_frame"] > 0 and record["ms_per_frame_fwd"] > 0
    assert 0 < record["rays_traced"] <= record["rays_nominal"]
    assert list(record) == _bench_py_keys("fwdbwd")
    # each rank's rows: the phase-1 forward and its replay backward (K1, K2)
    assert launches["tile_color_reference"] > 0 and launches["tile_color_vjp_reference"] > 0


def test_bench_scene_shard_over_gloo_ranks(ring2):
    record, launches = ring2
    assert record["scene_shard"] == 2 and record["mesh"] is None
    assert record["ms_per_frame"] > 0
    assert record["rays_traced"] == record["rays_nominal"] > 0
    assert list(record) == _bench_py_keys("fwdbwd")
    # the ring's closest hits and shadows (K6, K7) and its table gathers' backward (K8)
    for k in ("trace_bounce_reference", "trace_shadows_reference", "sorted_segsum_reference"):
        assert launches[k] > 0, k


@pytest.mark.parametrize("extra", [[], ["--mesh", "2", "--backend", "gloo"]])
def test_bench_on_cuda_without_a_card_raises(monkeypatch, extra):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no card"):
        bench.main(["--device", "cuda", "--res", "16x16", *extra])


def test_bench_ranks_need_a_backend():
    with pytest.raises(SystemExit, match="--backend"):
        bench.main(["--device", "cpu", "--res", "8x8", "--mesh", "2"])
