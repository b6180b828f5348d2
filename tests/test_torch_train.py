"""The port's single-device train step against tpurt's, on the CPU (the JAX
side in Pallas interpret mode), and the helpers around it."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.render as jrender
from tpurt.dist import train as jtrain
from tpurt.scene import configs as jconfigs
from tpurt_torch.bridge import leaves_as_numpy, scene_from_tpurt
from tpurt_torch.core.types import RenderConfig
from tpurt_torch.dist.train import make_train_step, sgd_update
from tpurt_torch.kernels import megakernel as TMK
from tpurt_torch.render import RenderPlan
from tpurt_torch.scene import configs as tconfigs

import torch_one_thread  # noqa: F401  (one PyTorch thread)

STEPS, LR, SIZE = 3, 0.01, 16


@pytest.fixture(scope="module")
def jax_run():
    """tpurt's train step on config 3 at 16x16 for STEPS steps towards the
    render of the scene with its spheres moved."""
    js, jcfg = jconfigs.config3_spheres(SIZE, SIZE)
    moved = dataclasses.replace(
        js, sph_center=js.sph_center + jnp.asarray([0.05, 0.0, -0.03]))
    target = np.array(jrender.render(moved, jcfg))  # a writable copy for torch
    step = jtrain.make_train_step(jcfg)
    scene, losses = js, []
    for _ in range(STEPS):
        scene, loss = step(scene, jnp.asarray(target), LR)
        losses.append(float(loss))
    return js, jcfg, target, losses, np.asarray(scene.sph_center)


def test_train_step_matches_tpurt(jax_run):
    js, jcfg, target, j_losses, j_centers = jax_run
    cfg = RenderConfig(width=SIZE, height=SIZE, max_depth=jcfg.max_depth, shadows=jcfg.shadows)
    step = make_train_step(cfg)
    scene = scene_from_tpurt(js, device="cpu")
    tgt = torch.from_numpy(target)
    TMK.reset_launches()
    losses = []
    for _ in range(STEPS):
        scene, loss = step(scene, tgt, LR)
        losses.append(float(loss))
    assert {n: c for n, c in TMK.launches.items() if c} == {"l2_hand_reference": STEPS}
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    np.testing.assert_allclose(scene.sph_center.numpy(), j_centers, rtol=0, atol=1e-5)
    assert losses[-1] < losses[0]
    assert not scene.sph_center.requires_grad


def test_generic_plan_differentiates_render(jax_run):
    js, jcfg, target, j_losses, _ = jax_run
    cfg = RenderConfig(width=SIZE, height=SIZE, max_depth=jcfg.max_depth, shadows=jcfg.shadows)
    TMK.reset_launches()
    step = make_train_step(cfg, plan=RenderPlan(kind="oracle"))
    scene, loss = step(scene_from_tpurt(js, device="cpu"), torch.from_numpy(target), LR)
    assert not any(TMK.launches.values())      # the oracle, not the phase-1 kernels
    np.testing.assert_allclose(float(loss), j_losses[0], rtol=1e-3)
    assert torch.isfinite(scene.sph_center).all()


def test_a_mesh_that_is_not_a_mesh_raises():
    """The tile-parallel mesh is a dist.shard.Mesh (tests/test_torch_dist.py);
    any other mesh raises and names the ring's own step
    (tests/test_torch_scene_shard.py)."""
    with pytest.raises(TypeError, match="make_ring_train_step"):
        make_train_step(RenderConfig(width=4, height=4), mesh=object())


def test_sgd_update_leaves_integer_leaves_alone():
    scene, cfg = tconfigs.config3_spheres(4, 4, device="cpu")
    _, grads = TMK.l2_loss_and_grad(scene, torch.zeros(4, 4, 3), cfg)
    assert grads.triangles is None and grads.sph_mat is None
    new = sgd_update(scene, grads, 0.5)
    for name in ("triangles", "tri_mat", "sph_mat"):
        assert getattr(new, name) is getattr(scene, name)
    assert new.materials.texture_id is scene.materials.texture_id
    torch.testing.assert_close(new.sph_center, scene.sph_center - 0.5 * grads.sph_center)
    torch.testing.assert_close(new.materials.kd, scene.materials.kd - 0.5 * grads.materials.kd)
    assert (new.smooth, new.textured, new.n_real_spheres) == (
        scene.smooth, scene.textured, scene.n_real_spheres)
    # a float leaf whose gradient is None passes through as well
    grads.light_pos = None
    assert sgd_update(scene, grads, 0.5).light_pos is scene.light_pos


def test_leaves_as_numpy_names_every_leaf():
    scene, cfg = tconfigs.config1_sphere(4, 4, device="cpu")
    leaves = leaves_as_numpy(scene)
    assert leaves["materials.kd"].shape == (1, 3) and leaves["camera.eye"].shape == (3,)
    assert leaves["triangles"].dtype == np.int32
    _, grads = TMK.l2_loss_and_grad(scene, torch.zeros(4, 4, 3), cfg)
    g = leaves_as_numpy(grads)
    assert "triangles" not in g and "materials.texture_id" not in g
    assert set(g) == {k for k, v in leaves.items() if np.issubdtype(v.dtype, np.floating)}
