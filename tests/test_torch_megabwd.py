"""The port's phase-1 backward against tpurt's, on the CPU.

The JAX side runs as tests/test_kernels.py runs it (Pallas in interpret mode);
the port's wrappers run their plain versions, because the tensors lie on the
CPU.  Inputs come from numpy with a seed and go to both packages.  Bars are
those of tests/test_kernels.py: the loss to rtol 1e-5, every float leaf of
the gradient to 2e-3 of that leaf's largest magnitude.  The hand adjoint and
its helpers against autograd on the port's own tensors are in
tests/test_torch_megabwd_adjoint.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.render as jrender
from tpurt.kernels import megakernel as JMK
from tpurt.scene import configs as jconfigs
import tpurt_torch
from tpurt_torch.bridge import leaves_as_numpy, scene_from_tpurt
from tpurt_torch.core.types import RenderConfig
from tpurt_torch.kernels import megakernel as TMK
from tpurt_torch.scene import configs as tconfigs

import torch_one_thread  # noqa: F401  (one PyTorch thread)

GRAD_RTOL = 2e-3
SIZE = 16
# the leaves tests/test_kernels.py:67-76 holds jax.grad of the Pallas render to;
# camera.fov_y is left out there and here: it is one scalar, the sum of large
# per-pixel terms of both signs, and two float32 evaluations of sum(image²) on
# config 3 at 16x16 sit 1.3 % apart around the float64 value
RENDER_GRAD_LEAVES = (
    "light_color", "light_pos", "sph_center", "sph_radius", "vertices", "camera.eye",
    "materials.ka", "materials.kd", "materials.ks", "materials.shininess",
    "materials.reflectivity")


def _config(jcfg):
    return RenderConfig(width=jcfg.width, height=jcfg.height,
                        max_depth=jcfg.max_depth, shadows=jcfg.shadows)


def _target(h, w, seed=1):
    return np.random.default_rng(seed).random((h, w, 3), dtype=np.float32)


def _jax_leaves(grads):
    """The float leaves of a tpurt Scene of gradients, named as
    bridge.leaves_as_numpy names the port's."""
    out = {}
    for name in ("vertices", "vnormals", "uvs", "sph_center", "sph_radius", "textures",
                 "light_pos", "light_color", "ambient"):
        out[name] = np.asarray(getattr(grads, name))
    for name in ("ka", "kd", "ks", "shininess", "reflectivity"):
        out[f"materials.{name}"] = np.asarray(getattr(grads.materials, name))
    for name in ("eye", "look_at", "up", "fov_y"):
        out[f"camera.{name}"] = np.asarray(getattr(grads.camera, name))
    return out


def _assert_leaves_close(got: dict, want: dict):
    for name, a in want.items():
        b = got[name]
        assert np.isfinite(b).all(), name
        np.testing.assert_allclose(b, a, rtol=0, atol=GRAD_RTOL * (np.abs(a).max() + 1e-6),
                                   err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax_l2(k):
    """tpurt's fused L2 loss and gradients on config k, computed once."""
    js, jcfg = jconfigs.ALL_CONFIGS[k](SIZE, SIZE)
    loss, grads = JMK.l2_loss_and_grad(js, jnp.asarray(_target(SIZE, SIZE)), jcfg)
    return js, jcfg, float(loss), _jax_leaves(grads)


@functools.lru_cache(maxsize=None)
def _jax_render_grad(name):
    """jax.grad of sum(render(scene)²) on a tpurt scene, computed once."""
    js, jcfg = (jconfigs.config4_bunny(16, 16, subdiv=1) if name == "bunny"
                else jconfigs.ALL_CONFIGS[name](SIZE, SIZE))
    grads = jax.grad(lambda s: jnp.sum(jrender.render(s, jcfg) ** 2), allow_int=True)(js)
    return js, jcfg, _jax_leaves(grads)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_l2_loss_and_grad_matches_tpurt(k):
    js, jcfg, j_loss, j_grads = _jax_l2(k)
    TMK.reset_launches()
    loss, grads = TMK.l2_loss_and_grad(
        scene_from_tpurt(js, device="cpu"), torch.from_numpy(_target(SIZE, SIZE)),
        _config(jcfg))
    assert {n: c for n, c in TMK.launches.items() if c} == {"l2_hand_reference": 1}
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-5)
    assert grads.triangles is None and grads.materials.texture_id is None
    _assert_leaves_close(leaves_as_numpy(grads), j_grads)


@pytest.mark.parametrize("k", [1, 2, 3, "smooth"])
def test_fused_kernel_path_matches_hand_path(k):
    if k == "smooth":
        scene, cfg = tconfigs.smooth_box(SIZE, SIZE, device="cpu")
    else:
        js, jcfg, _, _ = _jax_l2(k)
        scene, cfg = scene_from_tpurt(js, device="cpu"), _config(jcfg)
    target = torch.from_numpy(_target(SIZE, SIZE))
    TMK.reset_launches()
    l_hand, g_hand = TMK.l2_loss_and_grad(scene, target, cfg, hand=True)
    l_fused, g_fused = TMK.l2_loss_and_grad(scene, target, cfg, hand=False)
    assert {n: c for n, c in TMK.launches.items() if c} == {
        "l2_hand_reference": 1, "l2_fused_reference": 1}
    np.testing.assert_allclose(float(l_fused), float(l_hand), rtol=1e-5)
    _assert_leaves_close(leaves_as_numpy(g_fused), leaves_as_numpy(g_hand))
    if k == "smooth":
        assert np.abs(leaves_as_numpy(g_hand)["vnormals"]).max() > 0


@pytest.mark.parametrize("name", [2, 3])
def test_render_and_grad_matches_tpurt(name):
    js, jcfg, j_grads = _jax_render_grad(name)
    TMK.reset_launches()
    (loss, image), grads = tpurt_torch.render_and_grad(
        scene_from_tpurt(js, device="cpu"), lambda im: (im ** 2).sum(), _config(jcfg))
    assert {n: c for n, c in TMK.launches.items() if c} == {
        "tile_color_reference": 1, "tile_color_vjp_reference": 1}
    assert image.shape == (SIZE, SIZE, 3) and not image.requires_grad
    np.testing.assert_allclose(float(loss), float((image ** 2).sum()), rtol=1e-6)
    got = leaves_as_numpy(grads)
    assert all(np.isfinite(a).all() for a in got.values())
    _assert_leaves_close(got, {k: j_grads[k] for k in RENDER_GRAD_LEAVES})


def test_smooth_normals_gradients_match_tpurt():
    js, jcfg, j_grads = _jax_render_grad("bunny")
    scene = scene_from_tpurt(js, device="cpu")
    assert scene.smooth
    _, grads = tpurt_torch.render_and_grad(scene, lambda im: (im ** 2).sum(), _config(jcfg))
    got = leaves_as_numpy(grads)
    _assert_leaves_close({k: got[k] for k in ("vertices", "vnormals")},
                         {k: j_grads[k] for k in ("vertices", "vnormals")})
    assert np.abs(got["vnormals"]).max() > 0
    # the hand adjoint's barycentric branch on the same scene
    target = torch.from_numpy(_target(16, 16))
    _, g_hand = TMK.l2_loss_and_grad(scene, target, _config(jcfg), hand=True)
    _, g_fused = TMK.l2_loss_and_grad(scene, target, _config(jcfg), hand=False)
    _assert_leaves_close(leaves_as_numpy(g_hand), leaves_as_numpy(g_fused))
