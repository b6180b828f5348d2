"""The clustered path of the port as a whole: tpurt_torch.render on a
clusters plan against tpurt.render over the same cluster topology, against
the port's own oracle.  (The gradient of the path is held in
tests/test_torch_deferred.py, to spread the slow tpurt runs over files.)"""
import dataclasses

import numpy as np
import pytest
import torch

import tpurt.render as jrender
from tpurt.scene import configs as jconfigs
import tpurt_torch
from tpurt_torch.bridge import plan_from_tpurt, scene_from_tpurt
from tpurt_torch.core.types import RenderConfig
from tpurt_torch.kernels import traversal as TTV

import torch_one_thread  # noqa: F401  (one PyTorch thread)

#: the bar of tests/test_traversal.py: two intersection routines (forms in
#: the kernel, Möller–Trumbore in the oracle) and two frameworks
ATOL = 2e-4

CASES = {
    # name: (scene constructor, accel, depth cap that prepare must find)
    "config4": (lambda: jconfigs.config4_bunny(16, 16, subdiv=4), None, 0),
    "config3_bvh": (lambda: jconfigs.config3_spheres(24, 24), "bvh", None),
    "config5": (lambda: jconfigs.config5_multimesh(24, 32, n_blobs=2, subdiv=2), None, 0),
}


def _tcfg(jcfg):
    return RenderConfig(width=jcfg.width, height=jcfg.height, max_depth=jcfg.max_depth,
                        shadows=jcfg.shadows)


@pytest.fixture(scope="module", params=list(CASES))
def rendered(request):
    """tpurt's clustered image of a scene, and the port's scene and plan."""
    build, accel, cap = CASES[request.param]
    js, jcfg = build()
    jplan = jrender.prepare(js, jcfg, accel=accel)
    assert jplan.kind == "clusters" and jplan.depth_cap == cap
    ref = np.asarray(jrender.render(js, jcfg, plan=jplan))
    ts = scene_from_tpurt(js, device="cpu")
    return request.param, ts, _tcfg(jcfg), plan_from_tpurt(jplan, ts), jplan, ref


def test_clustered_render_matches_tpurt(rendered):
    name, ts, tcfg, plan, jplan, ref = rendered
    assert plan.kind == "clusters" and plan.depth_cap == jplan.depth_cap
    np.testing.assert_array_equal(plan.tri_ids.numpy(), np.asarray(jplan.tri_ids))
    TTV.reset_launches()
    img = tpurt_torch.render(ts, tcfg, plan=plan)
    want = {"trace_records_reference": 1}
    if name == "config3_bvh":
        want["trace_bounce_reference"] = 2
    assert {k: n for k, n in TTV.launches.items() if n} == want
    assert img.shape == ref.shape and img.dtype == torch.float32
    np.testing.assert_allclose(img.numpy(), ref, rtol=0, atol=ATOL)


def test_clustered_render_matches_the_ports_oracle(rendered):
    _, ts, tcfg, plan, _, _ = rendered
    img = tpurt_torch.render(ts, tcfg, plan=plan)
    ref = tpurt_torch.render(ts, tcfg, accel="none")
    np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=0, atol=ATOL)


def test_the_ports_own_plan_renders_the_same_image(rendered):
    """The port's own prepare builds its clusters with the same C++ builder
    as tpurt.prepare (tests/test_torch_grid_render.py holds the two plans
    equal): its image is tpurt's."""
    name, ts, tcfg, _, jplan, ref = rendered
    ours = tpurt_torch.prepare(ts, tcfg, accel=CASES[name][1])
    assert ours.kind == "clusters" and ours.depth_cap == jplan.depth_cap
    assert ours.tri_ids.dtype == torch.int32 and ours.tri_ids.device == ts.vertices.device
    assert sorted(set(ours.tri_ids.reshape(-1).tolist())) == list(range(ts.n_tris))
    assert ours.tree.children.shape == (ours.tri_ids.shape[0] - 1, 2)
    img = tpurt_torch.render(ts, tcfg, plan=ours)
    np.testing.assert_allclose(img.numpy(), ref, rtol=0, atol=ATOL)
    # render() without a plan prepares one itself
    if name == "config5":
        assert torch.equal(tpurt_torch.render(ts, tcfg), img)


def test_wavefront_matches_multibounce(rendered):
    name, ts, tcfg, plan, _, _ = rendered
    if name != "config3_bvh":
        # no reflective material: the cap leaves depth 0 and one launch either way
        tcfg, plan = tcfg.replace(max_depth=1), dataclasses.replace(plan, depth_cap=None)
    img_w = tpurt_torch.render(ts, tcfg.replace(wavefront=True), plan=plan)
    img_m = tpurt_torch.render(ts, tcfg.replace(wavefront=False), plan=plan)
    np.testing.assert_allclose(img_w.numpy(), img_m.numpy(), rtol=0, atol=1e-6)
