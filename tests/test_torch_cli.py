"""The port's command line (python -m tpurt_torch.cli) and its verification
tier (tpurt_torch.tools.verify) on the CPU, where the kernels' plain
versions run: render writes a PNG, inverse lowers its loss and saves a
checkpoint, the commands not ported yet name their queue item, and two of
the tier's cases pass against the oracle."""
import json

import numpy as np
import pytest

from tpurt_torch.cli import main
from tpurt_torch.scene.scene import Scene
from tpurt_torch.tools import verify
from tpurt_torch.utils import load_png, load_pytree


@pytest.mark.parametrize("args", [["--config", "1"], ["--config", "4", "--accel", "grid"]])
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


@pytest.mark.parametrize("cmd,item", [("bench", 5), ("multihost-render", 6)])
def test_cli_commands_not_ported_raise(cmd, item):
    with pytest.raises(NotImplementedError, match=f"Queue 1 item {item}"):
        main([cmd, "--device", "cpu"])


@pytest.mark.parametrize("name", ["c1-phase1", "c4-grid"])
def test_verify_case_passes_on_the_cpu(name):
    result = verify.render_grad_case(name, device="cpu")
    assert result["ok"] and result["grads_ok"], result
    assert result["plan"] == ("phase1" if name == "c1-phase1" else "clusters")
    assert np.isfinite(result["mean_diff"]) and result["frac_bad_px"] < verify.BAD_SHARE


@pytest.mark.parametrize("name", list(verify.EQUALITY_CASES))
def test_verify_equality_case_is_exact_on_the_cpu(name):
    """The wavefront loop continues each ray in the kernel's arithmetic, so
    its records equal the multi-bounce launch's, and the re-binned shadows
    the in-kernel ones (config 3 at 64x64 had one id off before)."""
    assert verify.EQUALITY_CASES[name]("cpu") == 0
