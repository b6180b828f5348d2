"""The plain version of the port's forward kernel against tpurt's Pallas
forward kernel, run in interpret mode as tests/test_kernels.py runs it.

Colour to atol 2e-4 (the bar of tests/test_kernels.py); occlusion records
bit-equal.  On the card, tests/test_torch_cuda.py holds the CUDA kernel to
this plain version.
"""
import numpy as np
import pytest
import torch

from tpurt.kernels import megakernel as JMK
from tpurt.kernels import pack as JPK
from tpurt.scene import configs as jconfigs
from tpurt_torch.bridge import scene_from_tpurt
from tpurt_torch.core.types import RenderConfig
from tpurt_torch.kernels import megakernel as TMK
from tpurt_torch.kernels.pack import pack_scene
from tpurt_torch.scene import configs as tconfigs

ATOL = 2e-4


def _config(jcfg):
    return RenderConfig(width=jcfg.width, height=jcfg.height,
                        max_depth=jcfg.max_depth, shadows=jcfg.shadows)


@pytest.mark.parametrize(
    "k,h,w,row0,nrows",
    [
        (1, 24, 24, 0, 24),
        (2, 24, 24, 0, 24),
        (3, 24, 24, 0, 24),
        (3, 40, 56, 0, 40),   # n_pix not a multiple of the TPU tile
        (3, 40, 56, 13, 9),   # a slab of rows: the int32 pixel offset
    ],
)
def test_reference_matches_tpurt_kernel(k, h, w, row0, nrows):
    js, jcfg = jconfigs.ALL_CONFIGS[k](h, w)
    jp = JPK.pack_scene(js)
    n_pix = nrows * w
    statics = JMK._statics_for(jp, jcfg, n_pix)
    j_col, (_, _, j_occ) = JMK._render_core_fwd(statics, jp, row0 * w)
    j_col = np.asarray(j_col)[:, :n_pix]
    j_occ = np.asarray(j_occ)[:, :n_pix]

    TMK.reset_launches()
    col, occ = TMK.tile_color_reference(pack_scene(scene_from_tpurt(js, device="cpu")),
                                        _config(jcfg), row0 * w, n_pix)
    assert TMK.launches["tile_color_reference"] == 1
    assert col.shape == (3, n_pix) and occ.dtype == torch.int32
    np.testing.assert_allclose(col.numpy(), j_col, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(occ.numpy(), j_occ)


def test_render_rows_slab_matches_full_image():
    scene, cfg = tconfigs.config3_spheres(20, 12, device="cpu")
    full = TMK.render_fused(scene, cfg)
    slab = TMK.render_rows_fused(scene, cfg, 7, 5)
    torch.testing.assert_close(slab, full[7:12], atol=0, rtol=0)


def test_supports_gate():
    scene, cfg = tconfigs.config3_spheres(8, 8, device="cpu")
    assert TMK.supports(scene, cfg)
    scene.triangles = scene.triangles[:1].repeat(TMK._F32_MAX_PRIMS + 1, 1)
    assert not TMK.supports(scene, cfg)
    scene, _ = tconfigs.config3_spheres(8, 8, device="cpu")
    scene.textured = True
    assert not TMK.supports(scene, cfg)


def test_forward_checks_lights_and_device():
    scene, cfg = tconfigs.config1_sphere(4, 4, device="cpu")
    packed = pack_scene(scene)
    many = packed.globals[None, 15:].repeat(1, TMK.MAX_LIGHTS + 1)
    packed.globals = torch.cat([packed.globals[:15], many[0]])
    assert packed.n_lights == TMK.MAX_LIGHTS + 1
    with pytest.raises(ValueError, match="lights"):
        TMK.fused_forward(packed, cfg, 0, 16)
    meta = pack_scene(scene)
    meta.globals = torch.empty_like(meta.globals, device="meta")
    with pytest.raises(ValueError, match="meta"):
        TMK.fused_forward(meta, cfg, 0, 16)
