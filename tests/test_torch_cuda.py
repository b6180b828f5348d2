"""The port's CUDA kernel on the card, against its plain PyTorch version.

Each test skips where PyTorch sees no card.  The card's machine has no JAX,
so run this file there without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import pytest
import torch

import tpurt_torch
from tpurt_torch.kernels import megakernel as MK
from tpurt_torch.kernels.pack import pack_scene
from tpurt_torch.scene import configs

pytestmark = pytest.mark.cuda

ATOL = 2e-4  # the port's colour bar (tests/test_kernels.py)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "k,h,w,row0,nrows",
    [
        (1, 24, 24, 0, 24),
        (2, 24, 24, 0, 24),
        (3, 24, 24, 0, 24),
        (3, 40, 56, 0, 40),
        (3, 40, 56, 13, 9),   # a slab of rows: the pixel offset
        (3, 33, 47, 0, 33),   # n_pix not a multiple of the block size
    ],
)
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
    assert MK.launches == {"megakernel_fwd": 1, "tile_color_reference": 0}
    cpu_scene, _ = configs.config3_spheres(24, 24)
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
