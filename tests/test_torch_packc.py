"""The port's clustered packing against tpurt's: the same FP32 expressions in
two frameworks, compared after undoing tpurt's TPU layout."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.accel import build_clusters as jbuild_clusters
from tpurt.kernels import packc as JPC
from tpurt.scene import configs as jconfigs
from tpurt_torch.bridge import scene_from_tpurt
from tpurt_torch.kernels import packc as TPC

#: relative to each table's largest magnitude: XLA and PyTorch may round a
#: division or an rsqrt differently in the last bit
RTOL = 1e-6


def _close(ours, theirs, name):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape, name
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=RTOL * np.abs(theirs).max(),
                               err_msg=name)


def _scene(name):
    if name == "config4":
        return jconfigs.config4_bunny(8, 8, subdiv=2)[0]
    if name == "config4_flat":
        return dataclasses.replace(jconfigs.config4_bunny(8, 8, subdiv=2)[0], smooth=False)
    return jconfigs.config3_spheres(8, 8)[0]


@pytest.fixture(scope="module", params=["config4", "config4_flat", "config3"])
def packed_pair(request):
    js = _scene(request.param)
    cs = jbuild_clusters(np.asarray(js.vertices), np.asarray(js.triangles))
    jp = JPC.pack_clusters(js, jnp.asarray(cs.tri_ids))
    ts = scene_from_tpurt(js, device="cpu")
    tp = TPC.pack_clusters(ts, torch.from_numpy(cs.tri_ids))
    return request.param, js, cs, jp, tp


def test_attribute_columns_equal_tpurt():
    for name in ("R_N0", "R_N1", "R_N2", "R_GID", "R_CENTER", "R_RADIUS", "R_REFL", "TROWS"):
        assert getattr(TPC, name) == getattr(JPC, name), name


def test_triangle_forms_match_tpurt(packed_pair):
    _, _, cs, jp, tp = packed_pair
    C, leaf = cs.tri_ids.shape
    w = np.asarray(jp.wtri_c)[:C]                     # (C, 8, 6, 128)
    # rows 0:4 of groups 0, 2, 4 hold [N | -N·v0], [r1 | c1], [r2 | c2];
    # rows 4:7 of groups 1, 3, 5 repeat N, r1, r2 for the direction
    theirs = np.stack([w[:, 0:4, g, :] for g in (0, 2, 4)], 1)  # (C, 3, 4, 128)
    theirs = theirs.transpose(0, 3, 1, 2).reshape(C * leaf, 3, 4)
    for k in range(3):
        _close(tp.tri_forms[:, k], theirs[:, k], f"form row {k}")
    dirs = np.stack([w[:, 4:7, g, :] for g in (1, 3, 5)], 1).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(dirs.reshape(C * leaf, 3, 3), theirs[:, :, :3])


def test_triangle_attributes_match_tpurt(packed_pair):
    _, _, cs, jp, tp = packed_pair
    C, leaf = cs.tri_ids.shape
    theirs = np.asarray(jp.attr_c)[:C].transpose(0, 2, 1).reshape(C * leaf, JPC.TROWS)
    _close(tp.tri_attrs[:, :9], theirs[:, :9], "corner normals")
    np.testing.assert_array_equal(tp.tri_attrs[:, 9:].numpy(), theirs[:, 9:])
    np.testing.assert_array_equal(tp.tri_attrs[:, TPC.R_GID].numpy(),
                                  cs.tri_ids.reshape(-1).astype(np.float32))


def test_cluster_boxes_and_meta_match_tpurt(packed_pair):
    _, js, cs, jp, tp = packed_pair
    C = cs.n_clusters
    aabb = np.asarray(jp.aabb)
    np.testing.assert_array_equal(tp.aabb_lo.numpy(), aabb[0:3, :C].T)
    np.testing.assert_array_equal(tp.aabb_hi.numpy(), aabb[3:6, :C].T)
    np.testing.assert_array_equal(tp.aabb_lo.numpy(), cs.aabb_lo)
    assert (tp.n_clusters, tp.n_lights, tp.n_tris) == (jp.n_clusters, jp.n_lights, jp.n_tris)
    assert tp.n_slots == C * JPC.LANES
    _close(tp.globals, np.asarray(jp.globals)[0], "globals")


def test_sphere_rows_match_tpurt(packed_pair):
    name, js, _, jp, tp = packed_pair
    if js.n_real_spheres == 0:
        assert jp.n_sph_blocks == 0 and tp.n_spheres == 0
        return
    S = js.n_spheres
    w = np.asarray(jp.wsph)                           # (8, 2·S_pad), block-major
    ct, cd = w[0:4, 0:S].T, w[4:8, JPC.LANES:JPC.LANES + S].T
    _close(tp.sph_forms[:, 0], ct, "sphere form [-2c | c·c - r²]")
    _close(tp.sph_forms[:, 1, :3], cd[:, :3], "sphere form [c]")
    assert float(tp.sph_forms[:, 1, 3].abs().max()) == 0.0
    np.testing.assert_array_equal(tp.sph_attrs.numpy(), np.asarray(jp.sattr)[:, :S].T)


def test_refit_follows_moved_vertices(packed_pair):
    _, js, cs, _, _ = packed_pair
    moved = dataclasses.replace(js, vertices=js.vertices * 1.5 + 0.25)
    jp = JPC.pack_clusters(moved, jnp.asarray(cs.tri_ids))
    tp = TPC.pack_clusters(scene_from_tpurt(moved, device="cpu"), torch.from_numpy(cs.tri_ids))
    C = cs.n_clusters
    np.testing.assert_array_equal(tp.aabb_lo.numpy(), np.asarray(jp.aabb)[0:3, :C].T)
    np.testing.assert_array_equal(tp.aabb_hi.numpy(), np.asarray(jp.aabb)[3:6, :C].T)
    assert not np.array_equal(tp.aabb_lo.numpy(), cs.aabb_lo)
    ts, ids = scene_from_tpurt(js, device="cpu"), torch.from_numpy(cs.tri_ids)
    with pytest.raises(ValueError, match="tree"):
        TPC.pack_clusters(ts, torch.cat([ids, ids]), tree=TPC.tree_for(ts, ids))
