"""The port's render path end to end against tpurt's, and the edges of its
public API: plans, unported paths, devices, the build and the backward."""
import numpy as np
import pytest
import torch

import tpurt.render as jrender
from tpurt.scene import configs as jconfigs
import tpurt_torch
from tpurt_torch.bridge import scene_from_tpurt
from tpurt_torch.core.types import RenderConfig
from tpurt_torch.kernels import build
from tpurt_torch.kernels import megakernel as TMK
from tpurt_torch.scene import configs as tconfigs
from tpurt_torch.scene.scene import build_scene

ATOL = 2e-4  # the bar of tests/test_kernels.py


def test_render_matches_tpurt_config3():
    js, jcfg = jconfigs.config3_spheres(24, 24)
    ref = np.asarray(jrender.render(js, jcfg))
    cfg = RenderConfig(width=24, height=24, max_depth=2, shadows=True)
    TMK.reset_launches()
    img = tpurt_torch.render(scene_from_tpurt(js, device="cpu"), cfg)
    # on the CPU the kernel's wrapper runs its plain version
    assert {k: n for k, n in TMK.launches.items() if n} == {"tile_color_reference": 1}
    assert img.shape == (24, 24, 3) and img.dtype == torch.float32
    np.testing.assert_allclose(img.numpy(), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_prepare_plans_phase1(k):
    scene, cfg = tconfigs.ALL_CONFIGS[k](8, 8, device="cpu")
    assert tpurt_torch.prepare(scene, cfg).kind == "phase1"
    assert tpurt_torch.prepare(scene, cfg, accel="none").kind == "oracle"


def test_oracle_backend_matches_phase1():
    scene, cfg = tconfigs.config2_cornell(16, 16, device="cpu")
    img = tpurt_torch.render(scene, cfg)
    ref = tpurt_torch.render(scene, cfg, backend="oracle")
    np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=0, atol=ATOL)


def test_clustered_scene_raises():
    """A scene beyond the phase-1 limit is planned as clusters; what still
    raises is the uniform-grid build, which is not ported."""
    verts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    tris = np.zeros((TMK._F32_MAX_PRIMS + 1, 3), np.int32) + [0, 1, 2]
    scene = build_scene(vertices=verts, triangles=tris, device="cpu")
    cfg = RenderConfig(width=4, height=4)
    plan = tpurt_torch.prepare(scene, cfg)
    assert plan.kind == "clusters" and plan.depth_cap == 0
    assert plan.tri_ids.shape == (33, 128) and plan.tree.children.shape == (32, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1"):
        tpurt_torch.prepare(scene, cfg, accel="grid")
    with pytest.raises(NotImplementedError, match="grid"):
        tpurt_torch.render(scene, cfg.replace(accel="grid"))


def test_textured_small_scene_is_planned_as_clusters():
    scene, cfg = tconfigs.config5_multimesh(8, 8, n_blobs=1, subdiv=0, device="cpu")
    assert scene.n_tris == 22 and scene.textured
    plan = tpurt_torch.prepare(scene, cfg)
    assert plan.kind == "clusters" and plan.tri_ids.shape == (1, 128)
    assert tpurt_torch.prepare(scene, cfg, accel="none").kind == "oracle"
    img = tpurt_torch.render(scene, cfg, plan=plan)
    ref = tpurt_torch.render(scene, cfg, backend="oracle")
    np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=0, atol=ATOL)


def test_cap_depth_follows_the_plan():
    from tpurt_torch.render import RenderPlan, cap_depth

    cfg = RenderConfig(max_depth=2)
    assert cap_depth(cfg, RenderPlan(kind="clusters", depth_cap=0)).max_depth == 0
    assert cap_depth(cfg, RenderPlan(kind="clusters")).max_depth == 2
    assert cap_depth(cfg, RenderPlan(kind="clusters", depth_cap=5)) is cfg


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tconfigs.config3_spheres(8, 8, device="cuda")
    js, _ = jconfigs.config1_sphere(4, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        scene_from_tpurt(js, device="cuda")


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load()


def test_default_device_is_the_card(monkeypatch):
    from tpurt_torch.core.types import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tconfigs.config3_spheres(8, 8)
    js, _ = jconfigs.config1_sphere(4, 4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        scene_from_tpurt(js)
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")


def test_render_backward_runs():
    scene, cfg = tconfigs.config1_sphere(4, 4, device="cpu")
    scene.sph_center.requires_grad_(True)
    img = tpurt_torch.render(scene, cfg)
    assert img.requires_grad
    TMK.reset_launches()
    img.sum().backward()
    assert TMK.launches["tile_color_vjp_reference"] == 1
    assert torch.isfinite(scene.sph_center.grad).all()
    assert scene.sph_center.grad.abs().max() > 0
