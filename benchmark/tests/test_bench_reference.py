"""The benchmark's inputs and its reference against the program, on the
CPU at small sizes: the frozen scenes equal the program's configurations,
and the reference's images and gradients agree with the program's."""
import numpy as np
import pytest
import torch

from benchmark import check, harness
from benchmark import program as P
from benchmark.reference import tracer
from benchmark.scenes import config3_spheres, config5_multimesh
from tpurt_torch import render_and_grad
from tpurt_torch.scene import configs

CASES = {
    "config5": (config5_multimesh, {"n_blobs": 2, "subdiv": 2, "resolution": "90x160",
                                    "max_depth": 1, "shadows": True},
                lambda: configs.config5_multimesh(90, 160, n_blobs=2, subdiv=2, device="cpu")),
    "config3": (config3_spheres, {"resolution": "36x48", "max_depth": 2, "shadows": True},
                lambda: configs.config3_spheres(36, 48, device="cpu")),
}


@pytest.mark.parametrize("name", CASES)
def test_frozen_scene_equals_the_programs(name):
    builder, params, program_scene = CASES[name]
    mine = P.scene_from_arrays(builder.build(params), "cpu")
    theirs, _ = program_scene()
    a, b = P.float_leaves(mine), P.float_leaves(theirs)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for k in ("triangles", "tri_mat", "sph_mat"):
        assert torch.equal(getattr(mine, k), getattr(theirs, k)), k
    assert torch.equal(mine.materials.texture_id, theirs.materials.texture_id)
    assert (mine.smooth, mine.textured, mine.n_real_spheres) == \
        (theirs.smooth, theirs.textured, theirs.n_real_spheres)


def test_frozen_blob_at_full_subdivision_has_the_published_count():
    v, t = config5_multimesh.meshes.displaced_blob(6, 0.55, (0, 0, 0), 0)
    assert t.shape == (81920, 3) and v.dtype == np.float32


@pytest.mark.parametrize("name", CASES)
def test_reference_agrees_with_the_program(name):
    builder, params, _ = CASES[name]
    arrays = builder.build(params)
    rcfg = P.render_config(params)
    scene = P.scene_from_arrays(arrays, "cpu")
    plan = P.prepare(scene, rcfg)
    img = P.render(scene, rcfg, plan=plan)
    ref_scene = harness.ref_scene(arrays, "cpu")
    with torch.no_grad():
        ref = tracer.render(ref_scene, rcfg.height, rcfg.width, rcfg.max_depth, rcfg.shadows)
    numbers = check.frame_numbers(img, ref)
    assert numbers["img_p99_gap"] < 1e-4 and numbers["pix_off_share"] < 0.01, numbers
    target = ref * 0.9
    (loss, _), grads = render_and_grad(scene, lambda im: torch.mean((im - target) ** 2),
                                       rcfg, plan=plan)
    rloss, rgrads, _ = tracer.loss_and_grads(ref_scene, target, rcfg.height, rcfg.width,
                                             rcfg.max_depth, rcfg.shadows)
    assert abs(float(loss) - float(rloss)) <= 1e-4 * float(rloss)
    pg, rg = check.leaf_norms(P.float_leaves(grads)), check.leaf_norms(rgrads)
    gap, at = check._leaf_gap(pg, rg, sorted(set(pg) | set(rg)))
    # at 90 × 160 the camera leaves are sums of large terms of both signs: float32
    # moves camera.up by ~3% against float64
    assert gap < 3e-2, (at, pg[at], rg.get(at))


def test_binned_search_equals_brute_force():
    arrays = config5_multimesh.build({"n_blobs": 3, "subdiv": 2})
    scene = harness.ref_scene(arrays, "cpu")
    o, d = tracer.camera_rays(scene, 30, 40)
    eye = scene.leaves["camera.eye"]
    binned = tracer.closest(scene, o, d, common=eye)
    brute = tracer.closest(scene, o, d)
    for k in binned:
        assert torch.equal(binned[k], brute[k]), k
    hit = brute["hit"]
    v0, v1, v2 = (c for c in tracer._tri_corners(scene, brute["prim"][hit]))
    _, t, _, _ = tracer._tri_test(o[hit], d[hit], v0, v1 - v0, v2 - v0, tracer.T_MAX)
    p = o[hit] + t[:, None] * d[hit]
    light = scene.leaves["light_pos"][0]
    to_l = light - p
    dist = to_l.norm(dim=-1)
    ldir = to_l / dist[:, None]
    p_off = p + 1e-3 * torch.nn.functional.normalize(torch.randn_like(p), dim=-1)
    a = tracer.occluded(scene, p_off, ldir, dist - 1e-3, light=light)
    b = tracer.occluded(scene, p_off, ldir, dist - 1e-3)
    assert torch.equal(a, b) and 0 < int(a.sum()) < len(a)
