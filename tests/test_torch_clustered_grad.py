"""The gradient of the clustered path: tpurt_torch.render_and_grad and the
train step on a clusters plan (autograd through deferred shading at the
kernel's records, the gathered tables' gradients through the sorted segment sum)
against jax.grad of tpurt's clustered render.  A file of its own: tpurt's
side is the slowest run of the port's tests, so it runs once, in a fixture."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.render as jrender
from tpurt.kernels import traversal as JTV
from tpurt.scene import configs as jconfigs
import tpurt_torch
from tpurt_torch.bridge import leaves_as_numpy, plan_from_tpurt, scene_from_tpurt
from tpurt_torch.core.types import RenderConfig
from tpurt_torch.dist.train import make_train_step
from tpurt_torch.kernels import segsum as TS
from tpurt_torch.kernels import traversal as TTV
from tpurt_torch.scene import configs as tconfigs

import torch_one_thread  # noqa: F401  (one PyTorch thread)


@pytest.fixture(scope="module")
def clustered():
    """tpurt's loss sum(img²) and its gradient on a small config 4 through a
    clusters plan; the same scene, config and plan for the port."""
    js, jcfg = jconfigs.config4_bunny(16, 16, subdiv=1)
    jplan = jrender.prepare(js, jcfg, accel="bvh")

    def loss_j(s):
        return jnp.sum(JTV.render_rows_clustered(s, jcfg, jplan.tri_ids, 0, 16) ** 2)

    loss_ref, gj = jax.value_and_grad(loss_j, allow_int=True)(js)
    ts = scene_from_tpurt(js, device="cpu")
    cfg = RenderConfig(width=16, height=16, max_depth=jcfg.max_depth, shadows=jcfg.shadows)
    return ts, cfg, plan_from_tpurt(jplan, ts), float(loss_ref), gj


def test_clustered_gradients_match_tpurt(clustered):
    ts, cfg, plan, loss_ref, gj = clustered
    TTV.reset_launches()
    TS.reset_launches()
    (loss, img), grads = tpurt_torch.render_and_grad(
        ts, lambda im: (im ** 2).sum(), cfg, plan=plan)
    np.testing.assert_allclose(float(loss), loss_ref, rtol=1e-5)
    assert {k: n for k, n in TTV.launches.items() if n} == {"trace_records_reference": 1}
    # the vertex table and the material table, at depth 0
    assert TS.launches == {"sorted_segsum": 0, "sorted_segsum_reference": 2}
    assert img.shape == (16, 16, 3) and grads.triangles is None
    ours = leaves_as_numpy(grads)
    for f in ("vertices", "vnormals", "light_pos", "light_color"):
        a = np.asarray(getattr(gj, f))
        assert np.isfinite(ours[f]).all() and np.abs(a).max() > 0, f
        # the bar of tests/test_traversal.py: relative to the leaf's largest
        # gradient (sums over pixels in two orders)
        np.testing.assert_allclose(ours[f], a, rtol=0, atol=2e-4 * (np.abs(a).max() + 1e-6),
                                   err_msg=f)


def test_train_step_clustered_plan_matches_tpurt(clustered):
    """One step against a black target: the loss is mean(img²), so every
    leaf moves by lr·g/(H·W·3) of the gradient above."""
    ts, cfg, plan, loss_ref, gj = clustered
    lr, n = 4.0, 16 * 16 * 3
    TS.reset_launches()
    new, loss = make_train_step(cfg, plan=plan)(ts, torch.zeros((16, 16, 3)), lr)
    assert TS.launches == {"sorted_segsum": 0, "sorted_segsum_reference": 2}
    np.testing.assert_allclose(float(loss), loss_ref / n, rtol=1e-5)
    assert torch.equal(new.triangles, ts.triangles)
    for f in ("vertices", "vnormals", "light_pos", "light_color"):
        a = np.asarray(getattr(gj, f))
        moved = (getattr(ts, f) - getattr(new, f)).numpy() * (n / lr)
        # the gradient bar above; the step itself rounds to 1e-7 of a leaf of
        # size 1, which is 2e-5 of these gradients after the scaling
        np.testing.assert_allclose(moved, a, rtol=0, atol=2e-4 * (np.abs(a).max() + 1e-6),
                                   err_msg=f)


def test_clustered_gradients_reach_materials_and_camera():
    scene, cfg = tconfigs.config5_multimesh(
        12, 16, n_blobs=1, subdiv=1, device="cpu")
    plan = tpurt_torch.prepare(scene, cfg)
    assert plan.kind == "clusters"       # textured, however small
    (_, _), grads = tpurt_torch.render_and_grad(scene, lambda im: im.sum(), cfg, plan=plan)
    for name, g in leaves_as_numpy(grads).items():
        assert np.isfinite(g).all(), name
    for name in ("vertices", "uvs", "textures", "materials.kd", "light_color", "camera.eye"):
        assert np.abs(leaves_as_numpy(grads)[name]).max() > 0, name
