"""The port's uniform-grid plan against tpurt's: config 4 at 24x24 (subdiv 2,
the size of tests/test_traversal.py's grid test) through
prepare(accel="grid"), the image and the hit ids.  tpurt's traversal kernel
runs in Pallas interpret mode, once, in a module fixture; this file is on its
own so that the run lands on a worker of its own."""
import numpy as np
import pytest
import torch

import tpurt.render as jrender
from tpurt.kernels import traversal as JTV
from tpurt.kernels.packc import pack_clusters as jpack_clusters
from tpurt.scene import configs as jconfigs
import tpurt_torch
from tpurt_torch.bridge import scene_from_tpurt
from tpurt_torch.core.types import RenderConfig
from tpurt_torch.kernels import traversal as TTV
from tpurt_torch.kernels.packc import pack_clusters
from tpurt_torch.render import cap_depth

import torch_one_thread  # noqa: F401  (one PyTorch thread)

ATOL = 2e-4  # the port's colour bar (tests/test_traversal.py)
H = W = 24


@pytest.fixture(scope="module")
def grid_case():
    """tpurt's grid plan, image and depth-0 records of config 4, and the
    port's scene and config."""
    js, jcfg = jconfigs.config4_bunny(H, W, subdiv=2)
    jplan = jrender.prepare(js, jcfg, accel="grid")
    assert jplan.kind == "clusters" and jplan.depth_cap == 0
    image = np.asarray(jrender.render(js, jcfg, plan=jplan))
    capped = jrender.cap_depth(jcfg, jplan)
    ids, _ = JTV._wavefront_records(js, capped, jpack_clusters(js, jplan.tri_ids), 0, H)
    ts = scene_from_tpurt(js, device="cpu")
    tcfg = RenderConfig(width=W, height=H, max_depth=jcfg.max_depth, shadows=jcfg.shadows)
    return js, jcfg, jplan, image, np.asarray(ids), ts, tcfg


def test_grid_plan_renders_tpurts_image(grid_case):
    _, _, _, image, _, ts, tcfg = grid_case
    plan = tpurt_torch.prepare(ts, tcfg, accel="grid")
    TTV.reset_launches()
    img = tpurt_torch.render(ts, tcfg, plan=plan)
    assert {k: n for k, n in TTV.launches.items() if n} == {"trace_records_reference": 1}
    assert img.shape == image.shape and img.dtype == torch.float32
    np.testing.assert_allclose(img.numpy(), image, rtol=0, atol=ATOL)


def test_grid_plan_hit_ids_equal_tpurts(grid_case):
    _, _, _, _, ids, ts, tcfg = grid_case
    plan = tpurt_torch.prepare(ts, tcfg, accel="grid")
    packed = pack_clusters(ts, plan.tri_ids, plan.tree)
    got, _, _, _ = TTV.trace_records(packed, cap_depth(tcfg, plan), 0, H)
    assert got.shape == ids.shape == (1, H * W)
    np.testing.assert_array_equal(got.numpy(), ids)
    assert (ids >= 0).any() and (ids < 0).any()


@pytest.mark.parametrize("accel", ["grid", "bvh"])
def test_prepare_gives_tpurts_tri_ids(grid_case, accel):
    js, jcfg, jplan, _, _, ts, tcfg = grid_case
    want = jplan if accel == "grid" else jrender.prepare(js, jcfg, accel=accel)
    plan = tpurt_torch.prepare(ts, tcfg, accel=accel)
    assert plan.kind == "clusters" and plan.depth_cap == want.depth_cap == 0
    assert plan.tri_ids.dtype == torch.int32
    np.testing.assert_array_equal(plan.tri_ids.numpy(), np.asarray(want.tri_ids))
