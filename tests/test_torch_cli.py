"""The port's command line (python -m tpurt_torch.cli) on the CPU, where the
kernels' plain versions run: render writes a PNG, inverse lowers its loss and
saves a checkpoint, multihost-render over two gloo processes equals render,
inverse runs over two spawned ranks, --profile writes a trace, and bench
prints bench.py's JSON line.  The verification tier is in
tests/test_torch_cli_verify.py."""
import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tpurt_torch.cli import main
from tpurt_torch.scene.scene import Scene
from tpurt_torch.utils import load_png, load_pytree

import torch_one_thread  # noqa: F401  (one PyTorch thread)

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("args", [["--config", "1"], ["--config", "4", "--accel", "grid"],
                                  ["--config", "rtiow"]])
def test_cli_render_writes_a_png(tmp_path, capsys, args):
    out = str(tmp_path / "r.png")
    main(["render", *args, "--res", "16x16", "--out", out, "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["out"] == out and line["plan"] == ("clusters" if "grid" in args else "phase1")
    img = load_png(out)
    assert img.shape == (16, 16, 3) and img.max() > img.min()


def test_cli_inverse_reduces_loss(tmp_path, capsys):
    ckpt = str(tmp_path / "ck.npz")
    main(["inverse", "--config", "1", "--res", "12x12", "--steps", "6", "--lr", "0.5",
          "--device", "cpu", "--ckpt", ckpt])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    losses = [l["loss"] for l in lines if "loss" in l]
    assert len(losses) == 2 and losses[-1] < losses[0]
    assert isinstance(load_pytree(ckpt, device="cpu"), Scene)


def test_cli_bench_prints_the_json_line(capsys):
    """tpurt's bench defaults: config 3 (phase-1), forward."""
    main(["bench", "--device", "cpu", "--res", "16x16", "--iters", "1"])
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["metric"] == "Mrays/s/chip fwd config3 16x16"
    assert line["rays_traced"] == line["rays_nominal"] == 16 * 16 * 3 * 3  # 3 depths, 2 lights
    assert line["ms_per_frame"] > 0 and "ms_per_frame_fwd" not in line


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_multihost_render_equals_render(tmp_path, capsys):
    """Two processes over gloo on 127.0.0.1, each rendering its rows: process
    0's PNG equals the single-process render's."""
    out, ref = str(tmp_path / "mh.png"), str(tmp_path / "r.png")
    common = ["--config", "3", "--res", "20x16", "--device", "cpu"]
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpurt_torch.cli", "multihost-render", *common,
         "--backend", "gloo", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(i), "--out", out],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    assert json.loads(outs[0][0].splitlines()[-1]) == {"out": out, "devices": 2}
    assert outs[1][0] == ""
    main(["render", *common, "--out", ref])
    assert np.array_equal(load_png(out), load_png(ref))


def test_cli_inverse_over_two_ranks(tmp_path, capsys):
    ckpt = str(tmp_path / "ck.npz")
    main(["inverse", "--config", "1", "--res", "12x12", "--steps", "3", "--lr", "0.5",
          "--device", "cpu", "--devices", "2", "--backend", "gloo", "--ckpt", ckpt])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    losses = [l["loss"] for l in lines if "loss" in l]
    assert [l["step"] for l in lines if "loss" in l] == [0, 2]
    assert losses[-1] < losses[0]
    assert isinstance(load_pytree(ckpt, device="cpu"), Scene)


def test_cli_inverse_over_ranks_needs_a_backend():
    with pytest.raises(SystemExit, match="--backend"):
        main(["inverse", "--config", "1", "--res", "8x8", "--device", "cpu", "--devices", "2"])


@pytest.mark.parametrize("cmd,name", [("render", "render.json"),
                                      ("animate", "animate.json"),
                                      ("inverse", "inverse.json")])
def test_cli_profile_writes_a_trace(tmp_path, capsys, cmd, name):
    prof = tmp_path / "prof"
    extra = {"render": ["--out", str(tmp_path / "r.png")],
             "animate": ["--frames", "2", "--out", str(tmp_path / "f{}.png")],
             "inverse": ["--steps", "1"]}[cmd]
    main([cmd, "--config", "1", "--res", "8x8", "--device", "cpu", "--profile", str(prof),
          *extra])
    trace = json.loads((prof / name).read_text())
    assert trace["traceEvents"]
