"""Clustered packing for the traversal kernel (``tpurt/kernels/packc.py``).

Scenes too large for the phase-1 kernels are partitioned on the host into
clusters of at most LEAF triangles (``tpurt_torch/accel/clusters.py``); this
module packs, per frame and on the scene's device, what the traversal kernel
(``csrc/traversal.cu``) reads.  It computes what ``tpurt``'s packing
computes; the layout is one row per triangle slot, slot ``c * LEAF + s``
being slot s of cluster c (the TPU layout's lane transposes, its pad
clusters and its padded cluster count are gone):

* ``tri_forms``  (C·LEAF, 3, 4)   Baldwin–Weber forms (``pack.py`` math)
* ``tri_attrs``  (C·LEAF, TROWS)  what the continuation and the records need:
  three corner normals (the face normal when the scene shades flat), the
  global triangle id as f32, the material's reflectivity
* ``aabb_lo``, ``aabb_hi`` (C, 3) cluster boxes, REFIT from the live vertices
  on every call: a step that moves vertices keeps a valid structure without
  a host rebuild (``tri_ids``, the slot order and the upper level's topology
  are frozen)
* ``boxes``      (2C − 1, 2, 4)   the boxes of the C − 1 inner nodes of the
  frozen binary ``ClusterTree``, then the C cluster boxes, each as
  [lo | 0], [hi | 0] and widened by BOX_MARGIN so that the box test never
  rejects a hit the triangle test would accept; the inner boxes are refit
  here by one scattered min and max.  The kernel reads only box 0, the
  scene's box
* ``children``   (C − 1, 2) i32   the binary tree's references (frozen)
* ``wide_boxes`` (N4, 4, 2, 4)    what the kernel's upper level walks: the
  4-wide nodes' children's boxes side by side, one gather of ``boxes``
  (a missing child gets a box that no ray enters)
* ``wide_children`` (N4, 4) i32   their references (frozen; ``build_wide``)
* ``group_boxes`` (C·LEAF/GROUP, 2, 4)  a widened box over each GROUP
  consecutive slots; a group of pad slots only gets the box no ray enters
* ``sph_forms`` (S, 2, 4), ``sph_attrs`` (S, TROWS)  the resident spheres
  (centre, radius, global id T + s, reflectivity); S = 0 for a mesh-only
  scene, whose only sphere is the pad
* ``globals``    camera, ambient and lights, shared with ``pack.py``.

With the tree's slot order (``RenderPlan.tree``, made by ``prepare``),
the slots of each cluster are packed in that order; without one they are
packed as ``tri_ids`` has them.

Everything here is built under ``torch.no_grad()``: the traversal finds
topology (ids and occlusion bits), which is not differentiable, and every
caller in ``tpurt`` applies ``stop_gradient`` to the packed scene before the
kernel.  Gradients flow through deferred shading only.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpurt_torch import constants as C
from tpurt_torch.accel.clusters import GROUP, ClusterTree, build_tree, build_wide
from tpurt_torch.core import vec
from tpurt_torch.kernels import pack as PK
from tpurt_torch.trace import span

# traversal attribute columns, as tpurt/kernels/packc.py:33-40
R_N0 = 0        # shading normals at the 3 corners (== face normal if flat)
R_N1 = 3
R_N2 = 6
R_GID = 9       # global primitive id as f32 (tris: tri id; spheres: T + s)
R_CENTER = 10   # sphere center (3); zero for triangles
R_RADIUS = 13
R_REFL = 14     # material reflectivity (ends dead reflection paths)
TROWS = 16

#: a box is widened on every side by BOX_MARGIN · (1 + its largest |coordinate|):
#: a hit point computed in float32 from the forms lies within a few ulps of
#: the scene's scale of its triangle, far inside this margin
BOX_MARGIN = 5e-5


@dataclasses.dataclass(frozen=True)
class DeviceTree:
    """What is frozen of a clusters plan besides ``tri_ids``, on the scene's
    device: a ClusterTree's arrays, its 4-wide form (``WideTree``) and the
    slot order (``slot_order``; None packs the slots as ``tri_ids`` has
    them)."""

    children: torch.Tensor      # (C - 1, 2) i32
    pair_node: torch.Tensor     # (K,) i64
    pair_cluster: torch.Tensor  # (K,) i64
    depth: int
    wide_refs: torch.Tensor     # (N4, 4) i64
    wide_children: torch.Tensor  # (N4, 4) i32
    stack: int                  # entries the kernel's stack needs
    slot_order: torch.Tensor | None = None  # (C, LEAF) i64

    @staticmethod
    def from_host(tree: ClusterTree, device, slot_order=None) -> "DeviceTree":
        wide = build_wide(tree)
        return DeviceTree(
            children=torch.from_numpy(tree.children).to(device),
            pair_node=torch.from_numpy(tree.pair_node).to(device),
            pair_cluster=torch.from_numpy(tree.pair_cluster).to(device),
            depth=tree.depth,
            wide_refs=torch.from_numpy(wide.refs).to(device),
            wide_children=torch.from_numpy(wide.children).to(device),
            stack=wide.stack,
            slot_order=None if slot_order is None else torch.from_numpy(
                np.asarray(slot_order, np.int64)).to(device))


@dataclasses.dataclass
class PackedClusters:
    tri_forms: torch.Tensor   # (C·LEAF, 3, 4) f32
    tri_attrs: torch.Tensor   # (C·LEAF, TROWS) f32
    aabb_lo: torch.Tensor     # (C, 3) f32
    aabb_hi: torch.Tensor     # (C, 3) f32
    boxes: torch.Tensor       # (2C − 1, 2, 4) f32
    children: torch.Tensor    # (C − 1, 2) i32
    wide_boxes: torch.Tensor  # (N4, 4, 2, 4) f32
    wide_children: torch.Tensor  # (N4, 4) i32
    group_boxes: torch.Tensor  # (C·LEAF/GROUP, 2, 4) f32
    sph_forms: torch.Tensor   # (S, 2, 4) f32
    sph_attrs: torch.Tensor   # (S, TROWS) f32
    globals: torch.Tensor     # (NGLOB_BASE + 6 L,) f32
    n_clusters: int
    leaf: int
    n_lights: int
    n_tris: int               # total triangles (gid >= n_tris is a sphere)
    tree_depth: int           # of the binary tree
    stack: int                # entries the kernel's stack needs (DeviceTree.stack)

    @property
    def n_slots(self):
        return self.tri_forms.shape[0]

    @property
    def n_spheres(self):
        return self.sph_forms.shape[0]


def _corners(scene, tri_ids):
    """(flat slot → triangle id (C·LEAF,), its corner indices (C·LEAF, 3))."""
    flat = tri_ids.reshape(-1).long()
    return flat, scene.triangles.long()[flat]


def _cluster_boxes(v0, v1, v2, shape):
    """(lo, hi), each (shape[0], 3), of the corners (C·LEAF, 3) of every
    slot, the slots taken shape[1] at a time: (C, LEAF) boxes the clusters,
    (C·LEAF/GROUP, GROUP) the groups."""
    lo = torch.minimum(torch.minimum(v0, v1), v2).reshape(*shape, 3).amin(1)
    hi = torch.maximum(torch.maximum(v0, v1), v2).reshape(*shape, 3).amax(1)
    return lo, hi


@torch.no_grad()
def tree_for(scene, tri_ids) -> DeviceTree:
    """Build the upper level's topology for `tri_ids` from the scene's
    present geometry (a host round trip: `prepare` does this once)."""
    _, tri = _corners(scene, tri_ids)
    lo, hi = _cluster_boxes(*(scene.vertices[tri[:, k]] for k in range(3)), tri_ids.shape)
    tree = build_tree(lo.cpu().numpy(), hi.cpu().numpy())
    return DeviceTree.from_host(tree, tri_ids.device)


def _box_rows(lo, hi):
    """(n, 2, 4) rows [lo | 0], [hi | 0] of boxes (n, 3), widened."""
    reach = torch.maximum(lo.abs(), hi.abs()).amax(1, keepdim=True)
    margin = BOX_MARGIN * (1.0 + reach)
    rows = torch.zeros((lo.shape[0], 2, 4), dtype=C.DTYPE, device=lo.device)
    rows[:, 0, :3] = lo - margin
    rows[:, 1, :3] = hi + margin
    return rows


def _node_boxes(lo, hi, tree: DeviceTree):
    """(2C − 1, 2, 4) widened boxes: inner nodes, then clusters."""
    rows = _box_rows(lo, hi)
    n_inner = tree.children.shape[0]
    idx = tree.pair_node[:, None].expand(-1, 3)
    inner_lo = torch.full((n_inner, 3), float("inf"), dtype=C.DTYPE, device=lo.device)
    inner_hi = torch.full((n_inner, 3), float("-inf"), dtype=C.DTYPE, device=lo.device)
    inner_lo.scatter_reduce_(0, idx, rows[tree.pair_cluster, 0, :3], "amin")
    inner_hi.scatter_reduce_(0, idx, rows[tree.pair_cluster, 1, :3], "amax")
    inner = torch.zeros((n_inner, 2, 4), dtype=C.DTYPE, device=lo.device)
    inner[:, 0, :3] = inner_lo
    inner[:, 1, :3] = inner_hi
    return torch.cat([inner, rows])


def _never_box(device):
    """(1, 2, 4): a box that no ray enters.  lo = hi = +inf, so both slab
    distances of an axis are +inf (or both -inf) and the slabs never meet."""
    rows = torch.zeros((1, 2, 4), dtype=C.DTYPE, device=device)
    rows[:, :, :3] = float("inf")
    return rows


@span("tpurt.pack")
@torch.no_grad()
def pack_clusters(scene, tri_ids, tree: DeviceTree | None = None) -> PackedClusters:
    """Scene + frozen cluster topology (C, LEAF) int32 → PackedClusters.
    `tree` is the frozen upper level and slot order (`RenderPlan.tree`);
    without one it is built here from the present boxes, which costs a host
    round trip, and the slots keep their order."""
    n_clusters, leaf = tri_ids.shape
    if tree is None:
        tree = tree_for(scene, tri_ids)
    if tree.children.shape[0] != n_clusters - 1:
        raise ValueError(f"the tree covers {tree.children.shape[0] + 1} clusters, "
                         f"tri_ids has {n_clusters}")
    if leaf % GROUP:
        raise ValueError(f"clusters of {leaf} slots do not split into groups of {GROUP}")
    # a pad slot repeats its cluster's first triangle (accel/clusters.py)
    pad = torch.zeros_like(tri_ids, dtype=torch.bool)
    pad[:, 1:] = tri_ids[:, 1:] == tri_ids[:, :1]
    if tree.slot_order is not None:
        tri_ids, pad = tri_ids.gather(1, tree.slot_order), pad.gather(1, tree.slot_order)
    flat, tri = _corners(scene, tri_ids)
    v0, v1, v2 = (scene.vertices[tri[:, k]] for k in range(3))
    e1, e2 = v1 - v0, v2 - v0
    if scene.smooth:
        n0, n1, n2 = (scene.vnormals[tri[:, k]] for k in range(3))
    else:
        n0 = n1 = n2 = vec.normalize(vec.cross(e1, e2))
    zeros = torch.zeros((flat.shape[0], 1), dtype=C.DTYPE, device=v0.device)
    refl_t = scene.materials.reflectivity[scene.tri_mat.long()[flat]]
    tri_attrs = torch.cat(
        [n0, n1, n2, flat.to(C.DTYPE)[:, None],
         zeros, zeros, zeros, zeros,                    # center / radius unused
         refl_t[:, None], zeros], 1)

    lo, hi = _cluster_boxes(v0, v1, v2, tri_ids.shape)
    boxes = _node_boxes(lo, hi, tree)
    dev = v0.device
    wide_boxes = torch.cat([boxes, _never_box(dev)])[tree.wide_refs]
    group_boxes = torch.where(pad.reshape(-1, GROUP).all(1)[:, None, None],
                              _never_box(dev),
                              _box_rows(*_cluster_boxes(v0, v1, v2, (-1, GROUP))))

    if scene.n_real_spheres == 0:
        # mesh-only scene: the pad sphere is never tested
        sph_forms = torch.zeros((0, 2, 4), dtype=C.DTYPE, device=dev)
        sph_attrs = torch.zeros((0, TROWS), dtype=C.DTYPE, device=dev)
    else:
        S = scene.n_spheres
        sph_forms = PK.sphere_form_groups(scene.sph_center, scene.sph_radius)
        sgid = (torch.arange(S, device=dev) + scene.n_tris).to(C.DTYPE)
        zs = torch.zeros((S, 1), dtype=C.DTYPE, device=dev)
        refl_s = scene.materials.reflectivity[scene.sph_mat.long()]
        sph_attrs = torch.cat(
            [zs.expand(-1, 9), sgid[:, None], scene.sph_center,
             scene.sph_radius[:, None], refl_s[:, None], zs], 1)

    return PackedClusters(
        tri_forms=PK.tri_form_groups(v0, e1, e2).contiguous(),
        tri_attrs=tri_attrs.contiguous(),
        aabb_lo=lo, aabb_hi=hi,
        boxes=boxes,
        children=tree.children,
        wide_boxes=wide_boxes.contiguous(),
        wide_children=tree.wide_children,
        group_boxes=group_boxes.contiguous(),
        sph_forms=sph_forms.contiguous(),
        sph_attrs=sph_attrs.contiguous(),
        globals=PK.globals_vec(scene).contiguous(),
        n_clusters=n_clusters, leaf=leaf,
        n_lights=scene.n_lights, n_tris=scene.n_tris,
        tree_depth=tree.depth, stack=tree.stack,
    )
