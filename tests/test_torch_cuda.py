"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Each test skips where PyTorch sees no card.  The card's machine has no JAX,
so run this file there without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import pytest
import torch

import tpurt_torch
from tpurt_torch.dist.train import make_train_step
from tpurt_torch.kernels import megabwd as MB
from tpurt_torch.kernels import megakernel as MK
from tpurt_torch.kernels.pack import pack_scene
from tpurt_torch.scene import configs

pytestmark = pytest.mark.cuda

ATOL = 2e-4  # the port's colour bar (tests/test_kernels.py)
GRAD_RTOL = 2e-3  # of max|g| of each cotangent table (tests/test_kernels.py)

SIZES = [
    (1, 24, 24, 0, 24),
    (2, 24, 24, 0, 24),
    (3, 24, 24, 0, 24),
    (3, 40, 56, 0, 40),
    (3, 40, 56, 13, 9),   # a slab of rows: the pixel offset
    (3, 33, 47, 0, 33),   # n_pix not a multiple of the block size
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize("k,h,w,row0,nrows", SIZES)
def test_kernel_matches_plain_version(cuda, k, h, w, row0, nrows):
    scene, cfg = configs.ALL_CONFIGS[k](h, w, device=cuda)
    packed = pack_scene(scene)
    n_pix = nrows * w
    col_k, occ_k = MK.megakernel_fwd_cuda(packed, cfg, row0 * w, n_pix)
    col_r, occ_r = MK.tile_color_reference(packed, cfg, row0 * w, n_pix)
    torch.cuda.synchronize()
    assert col_k.shape == (3, n_pix) and occ_k.shape == (cfg.max_depth + 1, n_pix)
    torch.testing.assert_close(col_k, col_r, atol=ATOL, rtol=0)
    assert torch.equal(occ_k, occ_r)


def test_render_goes_through_the_kernel(cuda):
    scene, cfg = configs.config3_spheres(24, 24, device=cuda)
    MK.reset_launches()
    img = tpurt_torch.render(scene, cfg)
    torch.cuda.synchronize()
    assert {k: n for k, n in MK.launches.items() if n} == {"megakernel_fwd": 1}
    cpu_scene, _ = configs.config3_spheres(24, 24, device="cpu")
    torch.testing.assert_close(img.cpu(), tpurt_torch.render(cpu_scene, cfg),
                               atol=ATOL, rtol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    scene, cfg = configs.config3_spheres(8, 8, device=cuda)
    packed = pack_scene(scene)
    packed.attrs = packed.attrs.double()
    with pytest.raises(ValueError, match="attrs"):
        MK.megakernel_fwd_cuda(packed, cfg, 0, 64)
    packed = pack_scene(scene)
    packed.tri_forms = packed.tri_forms.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        MK.megakernel_fwd_cuda(packed, cfg, 0, 64)


def _scene(k, h, w, device):
    build = configs.smooth_box if k == "smooth" else configs.ALL_CONFIGS[k]
    return build(h, w, device=device)


def _rand(shape, seed, device):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.rand(shape, generator=gen).to(device)


def _assert_tables_close(got, want):
    for name in ("globals", "tri_forms", "sph_forms", "attrs"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        bar = GRAD_RTOL * float(b.abs().max()) + 1e-12
        assert float((a - b).abs().max()) <= bar, (name, float((a - b).abs().max()), bar)


@pytest.mark.parametrize("k,h,w,row0,nrows", SIZES + [("smooth", 32, 40, 0, 32)])
def test_backward_kernel_matches_plain_version(cuda, k, h, w, row0, nrows):
    scene, cfg = _scene(k, h, w, cuda)
    packed = pack_scene(scene)
    off, n_pix = row0 * w, nrows * w
    _, occ = MK.megakernel_fwd_cuda(packed, cfg, off, n_pix)
    g = _rand((3, n_pix), 1, cuda) - 0.5
    got = MK.megakernel_bwd_cuda(packed, cfg, off, n_pix, occ, g)
    want = MK.tile_color_vjp_reference(packed, cfg, off, n_pix, occ, g)
    torch.cuda.synchronize()
    _assert_tables_close(got, want)


@pytest.mark.parametrize("which", ["fused", "hand"])
@pytest.mark.parametrize("k,h,w,row0,nrows", SIZES + [("smooth", 32, 40, 0, 32)])
def test_l2_kernels_match_plain_version(cuda, which, k, h, w, row0, nrows):
    scene, cfg = _scene(k, h, w, cuda)
    packed = pack_scene(scene)
    off, n_pix = row0 * w, nrows * w
    target = _rand((3, n_pix), 2, cuda)
    kernel, plain = {"fused": (MK.l2_fused_cuda, MK.l2_fused_reference),
                     "hand": (MB.hand_l2_cuda, MB.hand_l2_reference)}[which]
    sq_k, got = kernel(packed, cfg, off, n_pix, target)
    sq_r, want = plain(packed, cfg, off, n_pix, target)
    torch.cuda.synchronize()
    assert sq_k.shape == (n_pix,)
    torch.testing.assert_close(sq_k.sum(), sq_r.sum(), rtol=1e-5, atol=0)
    _assert_tables_close(got, want)


def test_tables_beyond_shared_memory_use_device_atomics(cuda, monkeypatch):
    scene, cfg = configs.config3_spheres(24, 24, device=cuda)
    packed = pack_scene(scene)
    target = _rand((3, 576), 3, cuda)
    _, want = MB.hand_l2_cuda(packed, cfg, 0, 576, target)
    monkeypatch.setattr(MK, "SHARED_TABLE_FLOATS", 0)
    _, got = MB.hand_l2_cuda(packed, cfg, 0, 576, target)
    torch.cuda.synchronize()
    _assert_tables_close(got, want)


def test_render_and_grad_launches_forward_and_backward(cuda):
    scene, cfg = configs.config3_spheres(24, 24, device=cuda)
    target = _rand((24, 24, 3), 4, cuda)
    MK.reset_launches()
    (loss, img), grads = tpurt_torch.render_and_grad(
        scene, lambda im: (im - target).abs().sum(), cfg)
    torch.cuda.synchronize()
    assert {k: n for k, n in MK.launches.items() if n} == {
        "megakernel_fwd": 1, "megakernel_bwd": 1}
    assert torch.isfinite(grads.sph_center).all() and grads.sph_center.abs().max() > 0
    assert grads.triangles is None


def test_train_step_goes_through_the_hand_kernel(cuda):
    scene, cfg = configs.config3_spheres(24, 24, device=cuda)
    moved, _ = configs.config3_spheres(24, 24, device=cuda)
    moved.sph_center = moved.sph_center + torch.tensor([0.05, 0.0, -0.03], device=cuda)
    target = tpurt_torch.render(moved, cfg)
    step = make_train_step(cfg)
    MK.reset_launches()
    losses = []
    for _ in range(3):
        scene, loss = step(scene, target, 0.05)
        losses.append(float(loss))
    assert {k: n for k, n in MK.launches.items() if n} == {"l2_hand": 3}
    assert losses[-1] < losses[0]
    MK.reset_launches()
    MK.l2_loss_and_grad(scene, target, cfg, hand=False)
    assert {k: n for k, n in MK.launches.items() if n} == {"l2_fused": 1}


def test_backward_wrappers_reject_what_the_kernels_do_not_take(cuda):
    scene, cfg = configs.config3_spheres(8, 8, device=cuda)
    packed = pack_scene(scene)
    _, occ = MK.megakernel_fwd_cuda(packed, cfg, 0, 64)
    g = torch.zeros((3, 64), device=cuda)
    with pytest.raises(ValueError, match="g:"):
        MK.megakernel_bwd_cuda(packed, cfg, 0, 64, occ, g.double())
    with pytest.raises(ValueError, match="occ:"):
        MK.megakernel_bwd_cuda(packed, cfg, 0, 64, occ[:2], g)
    with pytest.raises(ValueError, match="target"):
        MB.hand_l2_cuda(packed, cfg, 0, 64, g.t().contiguous().t())
    with pytest.raises(ValueError, match="target:"):
        MK.l2_fused_cuda(packed, cfg, 0, 64, g.cpu())
    deep = cfg.replace(max_depth=MK.MAX_DEPTHS)
    with pytest.raises(ValueError, match="max_depth"):
        MB.hand_l2_cuda(packed, deep, 0, 64, g)
    cpu_packed = pack_scene(configs.config3_spheres(8, 8, device="cpu")[0])
    with pytest.raises(ValueError, match="card"):
        MB.hand_l2_cuda(cpu_packed, cfg, 0, 64, g)
