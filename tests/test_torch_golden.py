"""The port's kernel paths against the golden images of tests/test_golden.py
(rendered by tpurt's oracle): the five configs at that file's sizes and
tolerance, each through the path prepare() picks or the one tpurt's kernel
test names.  On the CPU the kernels' plain versions run."""
from pathlib import Path

import numpy as np
import pytest

import tpurt_torch
from tpurt_torch.kernels import megakernel as MK
from tpurt_torch.kernels import traversal as TV
from tpurt_torch.scene import configs
from tpurt_torch.utils import load_png

import torch_one_thread  # noqa: F401  (one PyTorch thread)

GOLDEN = Path(__file__).resolve().parent / "golden"

# name: (constructor, (height, width), keywords, accel, plain version the path runs)
SPECS = {
    "config1": (configs.config1_sphere, (64, 64), {}, "auto", "tile_color_reference"),
    "config2": (configs.config2_cornell, (64, 64), {}, "auto", "tile_color_reference"),
    "config3": (configs.config3_spheres, (64, 64), {}, "auto", "tile_color_reference"),
    "config4": (configs.config4_bunny, (64, 64), {"subdiv": 3}, "bvh",
                "trace_records_reference"),
    "config5": (configs.config5_multimesh, (48, 64), {"n_blobs": 3, "subdiv": 2}, "bvh",
                "trace_records_reference"),
}


@pytest.mark.parametrize("name", list(SPECS))
def test_golden_kernel_paths(name):
    build, res, kw, accel, plain = SPECS[name]
    scene, cfg = build(*res, **kw, device="cpu")
    plan = tpurt_torch.prepare(scene, cfg, accel=accel)
    assert plan.kind != "oracle"
    MK.reset_launches()
    TV.reset_launches()
    img = tpurt_torch.render(scene, cfg, plan=plan).numpy()
    assert {**MK.launches, **TV.launches}[plain] == 1
    gold = load_png(GOLDEN / f"{name}.png")
    diff = np.abs(img - gold).max(-1)
    bad = diff > (2.5 / 255.0)
    assert bad.mean() < 1e-3, f"{name}[{plan.kind}]: {bad.sum()} pixels differ " \
        f"(max {diff.max():.4f})"
