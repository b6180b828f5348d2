"""The port's phase-1 backward against tpurt's, on the CPU.

The JAX side runs as tests/test_kernels.py runs it (Pallas in interpret mode);
the port's wrappers run their plain versions, because the tensors lie on the
CPU.  Inputs come from numpy with a seed and go to both packages.  Bars are
those of tests/test_kernels.py: the loss to rtol 1e-5, every float leaf of
the gradient to 2e-3 of that leaf's largest magnitude.
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
from tpurt_torch.kernels import megabwd as TMB
from tpurt_torch.kernels import megakernel as TMK
from tpurt_torch.kernels.pack import PackedScene, pack_scene
from tpurt_torch.scene import configs as tconfigs

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


@pytest.mark.parametrize("k", [1, 2, 3, "smooth"])
def test_hand_adjoint_matches_autograd_on_packed_tensors(k):
    if k == "smooth":
        scene, cfg = tconfigs.smooth_box(20, 28, device="cpu")
    else:
        scene, cfg = tconfigs.ALL_CONFIGS[k](20, 28, device="cpu")
    packed = pack_scene(scene)
    off, n_pix = 3 * 28, 15 * 28     # a slab of rows
    target = torch.from_numpy(_target(15, 28).reshape(n_pix, 3).T.copy())
    sq_h, cot_h = TMB.hand_l2_reference(packed, cfg, off, n_pix, target)
    sq_a, cot_a = TMK.l2_fused_reference(packed, cfg, off, n_pix, target)
    torch.testing.assert_close(sq_h, sq_a, rtol=0, atol=0)
    for name in ("globals", "tri_forms", "sph_forms", "attrs"):
        a, b = getattr(cot_a, name), getattr(cot_h, name)
        assert float((a - b).abs().max()) <= GRAD_RTOL * float(a.abs().max()) + 1e-12, name


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


def test_backward_of_a_row_slab_equals_those_rows_of_the_full_gradient():
    scene, cfg = tconfigs.config3_spheres(20, 12, device="cpu")
    W, row0, nrows = 12, 7, 5
    g_full = torch.zeros((3, 20 * W))
    g_slab = torch.from_numpy(_target(nrows, W).reshape(nrows * W, 3).T.copy()) - 0.5
    g_full[:, row0 * W:(row0 + nrows) * W] = g_slab

    def cotangents(off, n_pix, g):
        packed = pack_scene(scene)
        leaves = [t.detach().requires_grad_(True) for t in (
            packed.tri_forms, packed.sph_forms, packed.attrs, packed.globals)]
        colour, _ = TMK.fused_forward(PackedScene(*leaves), cfg, off, n_pix)
        colour.backward(g)
        return [t.grad for t in leaves]

    for a, b in zip(cotangents(row0 * W, nrows * W, g_slab), cotangents(0, 20 * W, g_full)):
        assert a.abs().max() > 0
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))


def test_tie_convention_of_the_adjoint_helpers():
    # max(x, 0): nothing at the tie, the whole cotangent above it
    x = torch.tensor([-1.0, 0.0, 2.0], requires_grad=True)
    y = TMB.max_pass(x)
    y.sum().backward()
    assert y.tolist() == [0.0, 0.0, 2.0] and x.grad.tolist() == [0.0, 0.0, 1.0]
    # the guarded light distance: nothing unless dist > 1e-20
    d = torch.tensor([1e-20, 1.0], requires_grad=True)
    TMB.max_pass(d, 1e-20).sum().backward()
    assert d.grad.tolist() == [0.0, 1.0]
    # the clip: the whole seed on the closed interval, bounds included
    a = torch.tensor([-0.5, 0.0, 0.3, 1.0, 1.5], requires_grad=True)
    c = TMK.clip_pass(a)
    c.backward(torch.full((5,), 7.0))
    assert c.tolist() == pytest.approx([0.0, 0.0, 0.3, 1.0, 1.0])
    assert a.grad.tolist() == [0.0, 7.0, 7.0, 7.0, 0.0]
    assert TMB.clip_mask(a).tolist() == [False, True, True, True, False]


def test_normalize_and_reflect_adjoints_match_autograd():
    rng = np.random.default_rng(5)
    v, n, cot = (torch.from_numpy(rng.normal(size=(3, 7)).astype(np.float32)) for _ in range(3))
    v.requires_grad_(True)
    n.requires_grad_(True)
    out = torch.stack(TMK._normalize(tuple(v)))
    (gv,) = torch.autograd.grad(out, v, cot)
    torch.testing.assert_close(torch.stack(TMB._nrm_bwd(tuple(v.detach()), tuple(cot))), gv,
                               rtol=1e-5, atol=1e-6)
    out = torch.stack(TMK._reflect(tuple(v), tuple(n)))
    gm, gn = torch.autograd.grad(out, (v, n), cot)
    cot_m, cot_n = TMB._refl_bwd(tuple(v.detach()), tuple(n.detach()), tuple(cot))
    torch.testing.assert_close(torch.stack(cot_m), gm, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(torch.stack(cot_n), gn, rtol=1e-5, atol=1e-6)


def test_reference_with_records_skips_the_shadow_tests(monkeypatch):
    scene, cfg = tconfigs.config3_spheres(12, 16, device="cpu")
    packed = pack_scene(scene)
    colour, occ = TMK.tile_color_reference(packed, cfg, 0, 192)

    def no_shadow_test(*args):
        raise AssertionError("a shadow test ran although records were given")

    monkeypatch.setattr(TMK, "_occluded", no_shadow_test)
    again, occ_again = TMK.tile_color_reference(packed, cfg, 0, 192, occ_rec=occ)
    torch.testing.assert_close(again, colour, rtol=0, atol=0)
    assert torch.equal(occ_again, occ)


def test_l2_loss_and_grad_declines_what_phase1_does_not_take():
    scene, cfg = tconfigs.config1_sphere(4, 4, device="cpu")
    scene.textured = True
    with pytest.raises(ValueError, match="phase-1"):
        TMK.l2_loss_and_grad(scene, torch.zeros(4, 4, 3), cfg)


def test_path_counts_agree_with_the_occlusion_records():
    scene, cfg = tconfigs.config3_spheres(12, 16, device="cpu")
    packed = pack_scene(scene)
    _, occ = TMK.tile_color_reference(packed, cfg, 0, 192)
    counts = TMK.path_counts(packed, cfg, 0, 192)
    full = (1 << packed.n_lights) - 1
    assert counts["rays"][0] == 192 and counts["rays"][1] <= 192
    for d in range(cfg.max_depth + 1):
        shaded = counts["shaded_tri"][d] + counts["shaded_sph"][d]
        # a depth without a shaded point records every bit; a shaded point
        # may too, where every light is blocked
        assert int((occ[d] != full).sum()) <= shaded <= counts["rays"][d]
        if d + 1 <= cfg.max_depth:
            assert counts["rays"][d + 1] <= shaded
        set_bits = sum(int(((occ[d] >> li) & 1).sum()) for li in range(packed.n_lights))
        assert set_bits == counts["blocked"][d] + packed.n_lights * (192 - shaded)
