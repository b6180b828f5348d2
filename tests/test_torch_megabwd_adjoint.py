"""The port's hand adjoint of the phase-1 L2 loss and its helpers against
autograd on the port's own plain versions, on the CPU: the cotangents of the
packed tables, a slab of rows, the tie convention, the normalize and reflect
adjoints, the shadow records and the path counts.  The bars are those of
tests/test_torch_megabwd.py, which holds the same backward to tpurt's."""
import numpy as np
import pytest
import torch

from tpurt_torch.kernels import megabwd as TMB
from tpurt_torch.kernels import megakernel as TMK
from tpurt_torch.kernels.pack import PackedScene, pack_scene
from tpurt_torch.scene import configs as tconfigs
from test_torch_megabwd import GRAD_RTOL, _target
import torch_one_thread  # noqa: F401  (one PyTorch thread)


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
