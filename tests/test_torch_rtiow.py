"""The final scene of "Ray Tracing in One Weekend" (configs.rtiow_final_spheres)
on the CPU: the scene equals the benchmark's frozen arrays
(benchmark/scenes/rtiow_final_spheres.py), keeps the book's invariants and
plans phase 1; at 24x36 with all 487 spheres the plain version of K1 and
the first train step (the plain version of K4) agree with the benchmark's
float64 reference (benchmark/reference/tracer.py) to the port's bars."""
import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import tpurt_torch
from benchmark import program as P
from benchmark.reference import tracer
from benchmark.scenes import rtiow_final_spheres as frozen
from tpurt_torch.dist import train as T
from tpurt_torch.scene import configs

import torch_one_thread  # noqa: F401  (one PyTorch thread)

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "benchmark" / "configs"
                     / "rtiow_final_spheres.json").read_text())
H, W = 24, 36
ATOL = 2e-4       # the port's colour bar (tests/test_kernels.py)
GRAD_RTOL = 2e-3  # of max|g| of each leaf (tests/test_kernels.py)
#: the leaves the book's scene is recovered by
LEAVES = ("sph_center", "sph_radius", "materials.kd", "light_pos", "light_color")


@pytest.fixture(scope="module")
def built():
    scene, cfg = configs.rtiow_final_spheres(H, W, device="cpu")
    return scene, cfg, configs.rtiow_draws(CONFIG["scene_seed"])


def test_scene_equals_the_frozen_arrays(built):
    scene, _, _ = built
    mine = P.scene_from_arrays(frozen.build(CONFIG), "cpu")
    a, b = P.float_leaves(mine), P.float_leaves(scene)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for k in ("triangles", "tri_mat", "sph_mat"):
        assert torch.equal(getattr(mine, k), getattr(scene, k)), k
    assert torch.equal(mine.materials.texture_id, scene.materials.texture_id)
    assert (mine.smooth, mine.textured, mine.n_real_spheres) == \
        (scene.smooth, scene.textured, scene.n_real_spheres) == (False, False, CONFIG["spheres"])


def test_the_books_invariants(built):
    scene, cfg, draws = built
    c, r = scene.sph_center.double().numpy(), scene.sph_radius.double().numpy()
    m = scene.materials
    assert len(draws) == scene.n_spheres == CONFIG["spheres"]
    assert np.array_equal(scene.sph_mat.numpy(), np.arange(scene.n_spheres))
    # the ground, then the small spheres, then glass, diffuse and metal of radius 1
    assert tuple(c[0]) == (0.0, -1000.0, 0.0) and r[0] == 1000.0
    assert np.array_equal(c[-3:], [[0, 1, 0], [-4, 1, 0], [4, 1, 0]]) and (r[-3:] == 1).all()
    assert [d["kind"] for d in draws[-3:]] == ["glass", "diffuse", "metal"]
    small = draws[1:-3]
    assert (r[1:-3] == np.float32(0.2)).all() and (c[1:-3, 1] == np.float32(0.2)).all()
    assert all(math.hypot(d["center"][0] - 4.0, d["center"][2]) > 0.9 for d in small)
    # every kept candidate of the 22 x 22 grid lies in its own cell
    cells = {(math.floor(d["center"][0]), math.floor(d["center"][2])) for d in small}
    assert len(cells) == len(small) and all(-11 <= a < 11 and -11 <= b < 11 for a, b in cells)
    for i, d in enumerate(small, 1):
        want = "diffuse" if d["choose_mat"] < 0.8 else "metal" if d["choose_mat"] < 0.95 \
            else "glass"
        assert d["kind"] == want, i
    # the material mapping, row by row
    for i, d in enumerate(draws):
        a, f = np.float32(d["albedo"]), d["fuzz"]
        kd, ks = m.kd[i].numpy(), m.ks[i].numpy()
        shin, refl = float(m.shininess[i]), float(m.reflectivity[i])
        assert np.array_equal(m.ka[i].numpy(), np.float32([0.1] * 3)), i
        if d["kind"] == "diffuse":
            assert np.array_equal(kd, a) and not ks.any() and refl == 0.0, i
        elif d["kind"] == "metal":
            assert 0.0 <= f < 0.5 and (a >= 0.5).all()
            assert np.allclose(kd, a * np.float32(f)) and (ks == 0.5).all() and shin == 64.0, i
            assert refl == np.float32(1.0 - f), i
        else:
            assert not kd.any() and (ks == 0.5).all() and shin == 128.0, i
            assert refl == np.float32(0.04), i
    assert sum(d["kind"] == "diffuse" for d in small) > 0.7 * len(small)
    # the book's camera and the lights and ambient that stand in for its sky
    cam = scene.camera
    assert cam.eye.tolist() == [13.0, 2.0, 3.0] and cam.look_at.tolist() == [0.0, 0.0, 0.0]
    assert float(cam.fov_y) == np.float32(math.radians(20.0))
    assert scene.ambient.tolist() == pytest.approx([0.5, 0.7, 1.0])
    assert scene.light_pos.tolist() == [[10, 12, 6], [-8, 6, -4]]
    assert (cfg.max_depth, cfg.shadows) == (2, True)


def test_prepare_plans_phase1(built):
    scene, cfg, _ = built
    assert tpurt_torch.prepare(scene, cfg).kind == CONFIG["plan"] == "phase1"
    # no triangle: the one a scene holds is the degenerate pad
    assert scene.n_tris == 1 and float(scene.vertices.min()) == 1e7


@pytest.fixture(scope="module")
def reference():
    arrays = frozen.build(CONFIG)
    return arrays, tracer.from_arrays(arrays, "cpu")


def test_render_agrees_with_the_reference(built, reference):
    scene, cfg, _ = built
    _, ref_scene = reference
    img = tpurt_torch.render(scene, cfg)   # the plain version of K1
    with torch.no_grad():
        ref = tracer.render(ref_scene, H, W, cfg.max_depth, cfg.shadows)
    gap = (img.double() - ref).abs()
    assert float(gap.max()) <= ATOL, float(gap.max())


def test_first_train_step_agrees_with_the_reference(built, reference, monkeypatch):
    """The step from the command line's start (kd halved and raised by 0.2,
    the lights at 0.6) towards the scene's own image: its loss and the
    gradients it applies (the plain version of K4) against the reference's
    loss_and_grads."""
    scene, cfg, _ = built
    _, ref_scene = reference
    with torch.no_grad():
        target = tracer.render(ref_scene, H, W, cfg.max_depth, cfg.shadows)
    mats = dataclasses.replace(scene.materials, kd=scene.materials.kd * 0.5 + 0.2)
    start = dataclasses.replace(scene, light_color=scene.light_color * 0.6, materials=mats)
    applied = {}
    real = T.sgd_update

    def keep(s, grads, lr):
        applied.update(P.float_leaves(grads))
        return real(s, grads, lr)

    monkeypatch.setattr(T, "sgd_update", keep)
    _, loss = T.make_train_step(cfg)(start, target.float(), 0.5)
    ref_start = ref_scene.with_leaves({
        **ref_scene.leaves, "materials.kd": ref_scene.leaves["materials.kd"] * 0.5 + 0.2,
        "light_color": ref_scene.leaves["light_color"] * 0.6})
    rloss, rgrads, _ = tracer.loss_and_grads(ref_start, target, H, W, cfg.max_depth,
                                             cfg.shadows)
    assert float(loss) == pytest.approx(float(rloss), rel=1e-4)
    for k in LEAVES:
        got, want = applied[k].double(), rgrads[k]
        bar = GRAD_RTOL * float(want.abs().max())
        assert float(want.abs().max()) > 0 and float((got - want).abs().max()) <= bar, k
