"""The traversal kernel's structures, on the CPU: the slot order inside a
cluster, the group boxes, the 4-wide upper level, and that no box on the way
to a hit can cull it (csrc/traversal.cu runs on the card only; the card tests
hold it to brute force, tests/test_torch_cuda.py)."""
import dataclasses

import numpy as np
import pytest
import torch

import tpurt_torch
from tpurt_torch.accel import GROUP, build_clusters, build_tree, build_wide, slot_order
from tpurt_torch.core import geom
from tpurt_torch.kernels import megakernel as MK
from tpurt_torch.kernels import packc as PC
from tpurt_torch.kernels import traversal as TV
from tpurt_torch.kernels.packc import pack_clusters
from tpurt_torch.scene import configs, meshes

import torch_one_thread  # noqa: F401  (one PyTorch thread)


def _mesh(subdiv):
    verts, tris = meshes.displaced_blob(subdiv)
    floor_v, floor_t = meshes.quad((-8, 0, -8), (-8, 0, 8), (8, 0, 8), (8, 0, -8))
    verts, tris, _, _ = meshes.merge([(verts, tris, 0), (floor_v, floor_t, 0)])
    return verts, tris


def _pads(tri_ids):
    pad = np.zeros(tri_ids.shape, bool)
    pad[:, 1:] = tri_ids[:, 1:] == tri_ids[:, :1]
    return pad


@pytest.mark.parametrize("subdiv", [1, 3, 4])
def test_slot_order_permutes_within_each_cluster(subdiv):
    verts, tris = _mesh(subdiv)
    cs = build_clusters(verts, tris)
    order = slot_order(verts, tris, cs.tri_ids)
    C, L = cs.tri_ids.shape
    assert order.shape == (C, L) and order.dtype == np.int64
    np.testing.assert_array_equal(np.sort(order, 1), np.broadcast_to(np.arange(L), (C, L)))
    ordered = np.take_along_axis(cs.tri_ids, order, 1)
    np.testing.assert_array_equal(np.sort(ordered, 1), np.sort(cs.tri_ids, 1))
    # pad slots sort last, so they fill whole groups where they can
    pad = np.take_along_axis(_pads(cs.tri_ids), order, 1)
    n_pad = pad.sum(1)
    np.testing.assert_array_equal(pad, np.arange(L)[None, :] >= L - n_pad[:, None])
    if subdiv == 1:   # 82 triangles: one cluster, 46 pads, 2 groups of pads only
        assert C == 1 and n_pad[0] == 46
        assert pad.reshape(C, -1, GROUP).all(2).sum() == 2


def test_slot_order_makes_groups_smaller_than_slabs():
    """Summed group box area over a blob's 40 full clusters, split order
    against the clusters' own (groups that are slabs along the last split)."""
    verts, tris = meshes.displaced_blob(4)
    cs = build_clusters(verts, tris)

    def area(order):
        ids = np.take_along_axis(cs.tri_ids, order, 1).reshape(-1, GROUP)
        c = verts[tris[ids]]                            # (G, GROUP, 3, 3)
        ext = c.max((1, 2)) - c.min((1, 2))
        return float((ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]).sum())

    slab = np.broadcast_to(np.arange(cs.tri_ids.shape[1]), cs.tri_ids.shape)
    assert area(slot_order(verts, tris, cs.tri_ids)) < 0.6 * area(slab)


@pytest.fixture(scope="module")
def mesh():
    """A config-4-like scene (subdiv 3: 1,282 triangles, 11 clusters) with
    its plan and packing."""
    scene, cfg = configs.config4_bunny(24, 32, subdiv=3, device="cpu")
    plan = tpurt_torch.prepare(scene, cfg, accel="bvh")
    return scene, cfg, plan, pack_clusters(scene, plan.tri_ids, plan.tree)


def test_packing_follows_the_slot_order(mesh):
    scene, cfg, plan, packed = mesh
    order = plan.tree.slot_order
    assert order is not None and order.shape == plan.tri_ids.shape
    gids = packed.tri_attrs[:, PC.R_GID].reshape(plan.tri_ids.shape)
    assert torch.equal(gids, plan.tri_ids.gather(1, order).to(gids.dtype))
    # without the order the slots keep tri_ids' order; the cluster boxes and
    # the plain versions' records do not depend on it
    plain = pack_clusters(scene, plan.tri_ids, dataclasses.replace(plan.tree, slot_order=None))
    assert torch.equal(plain.tri_attrs[:, PC.R_GID].reshape(plan.tri_ids.shape),
                       plan.tri_ids.to(gids.dtype))
    assert torch.equal(plain.boxes, packed.boxes)
    for a, b in zip(TV.trace_records(packed, cfg, 0, 24)[:3], TV.trace_records(plain, cfg, 0, 24)[:3]):
        assert torch.equal(a, b)


def test_group_boxes_contain_their_slots_after_a_refit(mesh):
    scene, _, plan, _ = mesh
    moved = dataclasses.replace(scene, vertices=scene.vertices * 1.25 + torch.tensor([0.5, -0.25, 2.0]))
    ids = plan.tri_ids.gather(1, plan.tree.slot_order)
    pure_pad = torch.from_numpy(
        np.take_along_axis(_pads(plan.tri_ids.numpy()), plan.tree.slot_order.numpy(), 1)
    ).reshape(-1, GROUP).all(1)
    for sc in (scene, moved):
        packed = pack_clusters(sc, plan.tri_ids, plan.tree)
        n_groups = packed.n_slots // GROUP
        assert packed.group_boxes.shape == (n_groups, 2, 4)
        lo, hi = packed.group_boxes[:, 0, :3], packed.group_boxes[:, 1, :3]
        pts = sc.vertices[sc.triangles.long()[ids.reshape(-1).long()]].reshape(n_groups, -1, 3)
        real = ~pure_pad
        assert (pts[real] > lo[real, None]).all() and (pts[real] < hi[real, None]).all()
        # a group inside its cluster's (widened) box; groups of pads only
        # get the box no ray enters
        cl = packed.boxes[packed.n_clusters - 1:].repeat_interleave(packed.leaf // GROUP, 0)
        assert (lo[real] >= cl[real, 0, :3]).all() and (hi[real] <= cl[real, 1, :3]).all()
        assert torch.isinf(packed.group_boxes[pure_pad, :, :3]).all()
    # 1,282 triangles in 11 clusters: one holds 2 and 126 pads, so 7 of its
    # groups hold pads only
    assert int(pure_pad.sum()) == 7


def _wide_paths(packed):
    """{cluster: [(node, child slot), ...]} from the 4-wide root."""
    paths, todo = {}, [(0, [])]
    children = packed.wide_children.tolist()
    while todo:
        node, path = todo.pop()
        for k, ch in enumerate(children[node]):
            if ch >= 0:
                todo.append((ch, path + [(node, k)]))
            elif ch <= -2:
                assert -2 - ch not in paths, "a cluster reached twice"
                paths[-2 - ch] = path + [(node, k)]
    return paths


@pytest.mark.parametrize("subdiv", [0, 3, 4])
def test_wide_level_reaches_every_cluster_once(subdiv):
    scene, cfg = configs.config4_bunny(8, 8, subdiv=subdiv, device="cpu")
    plan = tpurt_torch.prepare(scene, cfg, accel="bvh")
    packed = pack_clusters(scene, plan.tri_ids, plan.tree)
    C = packed.n_clusters
    paths = _wide_paths(packed)
    assert sorted(paths) == list(range(C))
    # each child box is the box of the binary node it stands for
    refs = plan.tree.wide_refs
    have = refs >= 0
    assert torch.equal(packed.wide_boxes[have], packed.boxes[refs[have]])
    assert torch.isinf(packed.wide_boxes[~have][:, :, :3]).all()
    assert torch.equal(have, packed.wide_children != -1)
    n_inner = C - 1
    for c, path in paths.items():
        node, k = path[-1]
        assert int(refs[node, k]) == n_inner + c
    # two binary levels a node: half the depth, rounded up
    wide = build_wide(build_tree(packed.aabb_lo.numpy(), packed.aabb_hi.numpy()))
    assert wide.depth == max(len(p) for p in paths.values()) == max(1, (plan.tree.depth + 1) // 2)
    # the stack bound holds when every box admits the ray
    most, stack = 1, [0]
    while stack:
        node = stack.pop()
        if node >= 0:
            stack.extend(ch for ch in packed.wide_children[node].tolist() if ch != -1)
            most = max(most, len(stack))
    assert most <= packed.stack == plan.tree.stack <= TV.MAX_STACK


def _path_boxes(packed, paths, slot):
    """Every box between the root and slot `slot`: the scene's, the 4-wide
    children's on the way, the group's."""
    rows = [packed.boxes[0]]
    rows += [packed.wide_boxes[n, k] for n, k in paths[slot // packed.leaf]]
    return rows + [packed.group_boxes[slot // GROUP]]


def _real_slot(packed, pure_pad, gid):
    """A slot holding triangle gid in a group that the kernel tests."""
    slots = torch.nonzero(packed.tri_attrs[:, PC.R_GID] == gid)[:, 0]
    return int(next(s for s in slots.tolist() if not pure_pad[s // GROUP]))


def _sample_rays(scene, packed, cfg, n, seed):
    """Camera rays of every pixel and n rays between random points of the
    scene's box, a tenth of them axis-parallel."""
    o, d = geom.generate_rays(scene.camera, cfg.height, cfg.width)
    rng = np.random.default_rng(seed)
    lo, hi = packed.aabb_lo.amin(0).numpy(), packed.aabb_hi.amax(0).numpy()
    a = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    b = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    dirs = b - a
    axes = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n // 10)] * rng.choice([-1, 1], (n // 10, 1))
    dirs[: n // 10] = axes
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return (torch.cat([o.reshape(-1, 3), torch.from_numpy(a)]),
            torch.cat([d.reshape(-1, 3), torch.from_numpy(dirs.astype(np.float32))]))


def test_no_box_culls_the_closest_hit(mesh):
    scene, cfg, plan, packed = mesh
    o, d = _sample_rays(scene, packed, cfg, 600, seed=3)
    ids, _, tb, _ = TV.trace_bounce(packed, cfg, o, d, torch.ones(o.shape[0], dtype=torch.bool),
                                    shadows=False)
    paths = _wide_paths(packed)
    pure_pad = torch.isinf(packed.group_boxes[:, 0, 0])
    rows, oo, dd, tt = [], [], [], []
    for i in torch.nonzero(ids >= 0)[:, 0].tolist():
        for box in _path_boxes(packed, paths, _real_slot(packed, pure_pad, int(ids[i]))):
            rows.append(box)
            oo.append(o[i])
            dd.append(d[i])
            tt.append(tb[i])
    assert len(tt) > 2000
    tt = torch.stack(tt)
    entry = TV.box_entry_reference(torch.stack(rows), torch.stack(oo), torch.stack(dd), tt)
    assert (entry <= tt).all(), int((entry > tt).sum())
    # and the group boxes do cull: most groups of a cluster that a ray enters
    # start beyond its hit
    g = packed.group_boxes[:, None].expand(-1, o.shape[0], -1, -1).reshape(-1, 2, 4)
    far = TV.box_entry_reference(g, o.repeat(packed.group_boxes.shape[0], 1),
                                 d.repeat(packed.group_boxes.shape[0], 1),
                                 tb.repeat(packed.group_boxes.shape[0]))
    assert float(torch.isinf(far).float().mean()) > 0.9


def test_no_box_culls_an_occluder(mesh):
    scene, cfg, plan, packed = mesh
    ids, _, _, _ = TV.trace_records(packed, cfg, 0, cfg.height, max_depth=0, shadows=False)
    o, d = TV._camera_rays(packed, cfg, 0, cfg.height * cfg.width)
    p_off, _, _, p = TV._continue_rays(packed, o, d, ids[0])
    live = torch.nonzero(ids[0] >= 0)[:, 0]
    paths = _wide_paths(packed)
    rows, oo, dd, tt = [], [], [], []
    for li in range(packed.n_lights):
        light = packed.globals[15 + 3 * li:18 + 3 * li]
        to_l = light - p[live]
        dist = torch.sqrt((to_l * to_l).sum(1))
        ldir = to_l * (1.0 / dist.clamp_min(1e-20))[:, None]
        tmax = dist - 1e-3
        tm, _, _ = MK._tri_t(packed, TV._cols(p_off[live]), TV._cols(ldir))
        for r, s in torch.nonzero(tm < tmax[:, None]).tolist():
            if torch.isinf(packed.group_boxes[s // GROUP, 0, 0]):
                continue          # a pad slot: the triangle sits in a tested group too
            for box in _path_boxes(packed, paths, s):
                rows.append(box)
                oo.append(p_off[live[r]])
                dd.append(ldir[r])
                tt.append(tmax[r])
    assert len(tt) > 1000
    tt = torch.stack(tt)
    entry = TV.box_entry_reference(torch.stack(rows), torch.stack(oo), torch.stack(dd), tt)
    assert (entry <= tt).all(), int((entry > tt).sum())


def test_box_entry_reference_on_axis_parallel_rays():
    box = torch.tensor([[[0.0, 0.0, 0.0, 0.0], [1.0, 1.0, 1.0, 0.0]]])
    d = torch.tensor([[0.0, 0.0, 1.0]])         # inv.x = inv.y = inf
    inside = torch.tensor([[0.5, 0.5, -1.0]])
    assert float(TV.box_entry_reference(box, inside, d, torch.tensor([5.0]))[0]) == 1.0
    assert torch.isinf(TV.box_entry_reference(box, inside, d, torch.tensor([0.5])))[0]
    # in the plane of a face: (0 - 0) * inf is NaN, which fmin and fmax drop,
    # so the slab is empty.  A widened box holds its triangles strictly
    # inside, so no hit lies on that plane
    on_face = torch.tensor([[0.0, 0.5, -1.0]])
    for sign in (1.0, -1.0):
        assert torch.isinf(TV.box_entry_reference(box, on_face, d * sign, torch.tensor([5.0])))[0]
    never = torch.full((1, 2, 4), float("inf"))
    for sign in (1.0, -1.0):
        assert torch.isinf(TV.box_entry_reference(never, inside, d * sign,
                                                  torch.tensor([1e30])))[0]
