"""The port's host-side build code against tpurt's: procedural meshes, the
cluster build, and the upper level over the clusters that only the port has."""
import dataclasses

import numpy as np
import pytest
import torch

from tpurt.accel import build_clusters as jbuild_clusters
from tpurt.scene import meshes as jmeshes
import tpurt_torch
from tpurt_torch.accel import build_clusters, build_tree
from tpurt_torch.kernels.packc import pack_clusters
from tpurt_torch.scene import configs as tconfigs
from tpurt_torch.scene import meshes as tmeshes


@pytest.mark.parametrize("name,args", [
    ("icosphere", (2, 0.7, (0.1, 0.2, 0.3))),
    ("displaced_blob", (2, 0.55, (1.0, 0.5, -1.0), 3)),
    ("uv_sphere_grid", (6, 5, 1.5, (0.0, 1.0, 0.0))),
])
def test_meshes_equal_tpurt(name, args):
    ours, theirs = getattr(tmeshes, name)(*args), getattr(jmeshes, name)(*args)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_merge_equals_tpurt():
    parts = [(*tmeshes.icosphere(1), 1),
             (*tmeshes.quad((0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 0, 0)), 0,
              np.asarray([[0, 0], [0, 1], [1, 1], [1, 0]], np.float32))]
    for a, b in zip(tmeshes.merge(parts), jmeshes.merge(parts)):
        np.testing.assert_array_equal(a, b)


def test_build_clusters_equals_tpurt():
    verts, tris = tmeshes.displaced_blob(3)
    ours, theirs = build_clusters(verts, tris), jbuild_clusters(verts, tris)
    assert ours.n_clusters == theirs.n_clusters == 10
    np.testing.assert_array_equal(ours.tri_ids, theirs.tri_ids)
    np.testing.assert_array_equal(ours.aabb_lo, theirs.aabb_lo)
    np.testing.assert_array_equal(ours.aabb_hi, theirs.aabb_hi)
    # every triangle sits in exactly one cluster; pad slots repeat the first
    assert sorted(set(ours.tri_ids.ravel().tolist())) == list(range(len(tris)))


def _leaves_below(tree, ref):
    n_inner = tree.children.shape[0]
    if ref >= n_inner:
        return [ref - n_inner]
    return _leaves_below(tree, tree.children[ref, 0]) + _leaves_below(tree, tree.children[ref, 1])


@pytest.mark.parametrize("subdiv", [0, 3, 4])
def test_upper_level_covers_every_cluster(subdiv):
    verts, tris = tmeshes.displaced_blob(subdiv)
    cs = build_clusters(verts, tris)
    tree = build_tree(cs.aabb_lo, cs.aabb_hi)
    C = cs.n_clusters
    assert tree.children.shape == (C - 1, 2) and tree.n_clusters == C
    # the root reaches every cluster once, in order; every inner node covers
    # a consecutive range, and the refit pairs list exactly that range
    assert _leaves_below(tree, 0) == list(range(C))
    for node in range(C - 1):
        below = _leaves_below(tree, node)
        assert below == list(range(below[0], below[-1] + 1))
        assert tree.pair_cluster[tree.pair_node == node].tolist() == below
    # parents come before children, so the depth is bounded by the node count
    assert all((tree.children[i][tree.children[i] < C - 1] > i).all() for i in range(C - 1))
    assert (C == 1 and tree.depth == 0) or int(np.ceil(np.log2(C))) <= tree.depth < C


def test_refit_boxes_contain_their_children_and_follow_the_vertices():
    scene, cfg = tconfigs.config4_bunny(8, 8, subdiv=3, device="cpu")
    plan = tpurt_torch.prepare(scene, cfg, accel="bvh")
    C = plan.tri_ids.shape[0]

    def check(sc, packed):
        boxes = packed.boxes.numpy()
        lo, hi = boxes[:, 0, :3], boxes[:, 1, :3]
        for node, (a, b) in enumerate(packed.children.numpy()):
            for child in (a, b):
                assert (lo[node] <= lo[child]).all() and (hi[node] >= hi[child]).all()
        # cluster boxes, widened, contain every vertex of their triangles
        tri = scene.triangles.long()[plan.tri_ids.reshape(-1).long()]
        pts = sc.vertices[tri].reshape(C, -1, 3).numpy()
        assert (pts >= lo[C - 1:, None, :]).all() and (pts <= hi[C - 1:, None, :]).all()
        assert (lo[C - 1:] < packed.aabb_lo.numpy()).all()
        return lo, hi

    lo0, hi0 = check(scene, pack_clusters(scene, plan.tri_ids, plan.tree))
    moved = torch.tensor([0.5, -0.25, 2.0])
    shifted = dataclasses.replace(scene, vertices=scene.vertices + moved)
    lo1, hi1 = check(shifted, pack_clusters(shifted, plan.tri_ids, plan.tree))
    np.testing.assert_allclose(lo1 - lo0, np.broadcast_to(moved.numpy(), lo0.shape), atol=1e-3)
    np.testing.assert_allclose(hi1 - hi0, np.broadcast_to(moved.numpy(), hi0.shape), atol=1e-3)
