"""The port's pack_scene against tpurt.kernels.pack.pack_scene.

tpurt lays the forms out block-major in lanes, padded per block; the port
keeps one row per primitive.  Each test undoes tpurt's layout, checks that
every column the port drops is zero there, and compares the rest with
atol 1e-6 relative to the array's magnitude.
"""
import numpy as np
import pytest
import torch

from tpurt.kernels import pack as JPK
from tpurt.scene import configs as jconfigs
from tpurt_torch.bridge import scene_from_tpurt
from tpurt_torch.kernels import pack as TPK


def _close(ours, theirs):
    ours = ours.detach().numpy()
    theirs = np.asarray(theirs)
    scale = max(1.0, float(np.abs(theirs).max(initial=0.0)))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6 * scale)


def _groups(w, n_groups, lanes, n):
    """(8, G·P_pad) block-major → (8, G, n) groups of the first n prims."""
    nb = w.shape[1] // (n_groups * lanes)
    g = np.asarray(w).reshape(8, nb, n_groups, lanes).transpose(0, 2, 1, 3)
    return g.reshape(8, n_groups, nb * lanes)[:, :, :n]


@pytest.mark.parametrize("k", [1, 2, 3])
def test_pack_matches_tpurt(k):
    js, _ = jconfigs.ALL_CONFIGS[k](16, 16)
    jp = JPK.pack_scene(js)
    tp = TPK.pack_scene(scene_from_tpurt(js, device="cpu"))
    T, S = js.n_tris, js.n_spheres
    assert tp.tri_forms.shape == (T, 3, 4) and tp.sph_forms.shape == (S, 2, 4)
    assert tp.n_lights == js.n_lights

    # triangles: tpurt rows [no | nd | uo | ud | vo | vd], each over
    # [o.xyz, 1, d.xyz, 0]; the port keeps (a.xyz, a.w) per pair
    g = _groups(jp.wtri, 6, jp.tlb, T)
    for pair in range(3):
        o_form, d_form = g[:, 2 * pair], g[:, 2 * pair + 1]
        _close(tp.tri_forms[:, pair], o_form[0:4].T)
        _close(tp.tri_forms[:, pair, :3], d_form[4:7].T)
        assert not o_form[4:].any() and not d_form[:4].any() and not d_form[7].any()

    # spheres: tpurt rows [ct | cd]; the port keeps [-2c | cc - r²], [c | 0]
    g = _groups(jp.wsph, 2, jp.slb, S)
    _close(tp.sph_forms[:, 0], g[0:4, 0].T)
    _close(tp.sph_forms[:, 1, :3], g[4:7, 1].T)
    assert not g[4:, 0].any() and not g[:4, 1].any() and not g[7, 1].any()
    assert not tp.sph_forms[:, 1, 3].any()

    attrs = np.asarray(jp.attrs)
    t_pad = attrs.shape[0] - jp.n_sph_blocks * jp.slb
    _close(tp.attrs[:T], attrs[:T, :TPK.ACOLS])
    _close(tp.attrs[T:], attrs[t_pad:t_pad + S, :TPK.ACOLS])
    assert not attrs[:, TPK.ACOLS:].any()
    _close(tp.globals, np.asarray(jp.globals)[0])


def test_pack_is_differentiable():
    js, _ = jconfigs.config3_spheres(8, 8)
    scene = scene_from_tpurt(js, device="cpu")
    leaves = [scene.vertices, scene.sph_center, scene.sph_radius,
              scene.materials.kd, scene.light_pos, scene.camera.eye]
    for leaf in leaves:
        leaf.requires_grad_(True)
    p = TPK.pack_scene(scene)
    loss = sum((x * x).sum() for x in (p.tri_forms, p.sph_forms, p.attrs, p.globals))
    grads = torch.autograd.grad(loss, leaves)
    for leaf, g in zip(leaves, grads):
        assert g.shape == leaf.shape and torch.isfinite(g).all() and g.abs().sum() > 0
