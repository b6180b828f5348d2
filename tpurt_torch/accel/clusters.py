"""Host-side cluster build, a copy of ``tpurt/accel/clusters.py`` (numpy
only; a test holds the two equal on ``tri_ids`` and boxes).

A median-split BVH is descended only until leaves hold <= LEAF triangles;
each leaf becomes a CLUSTER, one contiguous padded block of triangle slots.
The split position is a multiple of `leaf` (so leaves come out full) chosen
by a surface-area-heuristic sweep over the three centroid-sorted axes.
Leaves are emitted in depth-first order of the splits, so consecutive
cluster indices are spatial neighbours: the upper level that the CUDA
traversal kernel walks (``build_tree`` below, collapsed to 4 wide by
``build_wide``) is a tree over consecutive ranges of cluster indices.
Inside a cluster, ``slot_order`` continues the split down to groups of
GROUP slots, each of which gets a box of its own.

Padding uses DUPLICATES of the cluster's first triangle: duplicates are
harmless under closest-hit (ties resolve to the same triangle id) and under
any-hit (boolean or).
"""
from __future__ import annotations

import dataclasses

import numpy as np

LEAF = 128  # triangle slots per cluster
GROUP = 16  # slots of a group inside a cluster


@dataclasses.dataclass(frozen=True)
class ClusterSet:
    """Flattened cluster partition of a triangle set.

    tri_ids:  (C, LEAF) int32 — global triangle index per slot (duplicates
              pad short clusters; a cluster is never empty).
    aabb_lo:  (C, 3) f32, aabb_hi: (C, 3) f32 — cluster bounds.
    """

    tri_ids: np.ndarray
    aabb_lo: np.ndarray
    aabb_hi: np.ndarray

    @property
    def n_clusters(self) -> int:
        return self.tri_ids.shape[0]


def build_clusters(vertices, triangles, leaf: int = LEAF) -> ClusterSet:
    """Median-split partition of triangles into ≤leaf-sized spatial clusters.

    vertices (V, 3) f32, triangles (T, 3) i32 (numpy or anything
    np.asarray-able).  O(T log T) host build, geometry-only (no materials).
    """
    verts = np.asarray(vertices, np.float32)
    tris = np.asarray(triangles, np.int64)
    T = tris.shape[0]
    v0 = verts[tris[:, 0]]
    v1 = verts[tris[:, 1]]
    v2 = verts[tris[:, 2]]
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    cent = (lo + hi) * 0.5

    leaves: list[np.ndarray] = []

    # iterative median split (avoids python recursion limits at 1M tris)
    stack = [np.arange(T)]
    while stack:
        idx = stack.pop()
        if len(idx) <= leaf:
            leaves.append(idx)
            continue
        # split at a multiple of `leaf` so leaves come out full (a plain
        # halving of e.g. 81920 tris bottoms out at 80-tri leaves — 60% more
        # clusters to cull and stream for the same geometry); WHICH multiple
        # and WHICH axis come from a surface-area-heuristic sweep over all
        # three centroid-sorted axes: SAH minimizes child-box area × count,
        # i.e. the expected number of clusters a ray enters
        n = len(idx)

        def _ha(blo, bhi):
            d = np.maximum(bhi - blo, 0.0)
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

        ks = np.arange(leaf, n, leaf)
        best = None
        for axis in range(3):
            srt = idx[np.argsort(cent[idx, axis], kind="stable")]
            klo, khi = lo[srt], hi[srt]
            llo = np.minimum.accumulate(klo)
            lhi = np.maximum.accumulate(khi)
            rlo = np.minimum.accumulate(klo[::-1])[::-1]
            rhi = np.maximum.accumulate(khi[::-1])[::-1]
            cost = _ha(llo[ks - 1], lhi[ks - 1]) * ks + _ha(
                rlo[ks], rhi[ks]) * (n - ks)
            j = int(np.argmin(cost))
            if best is None or cost[j] < best[0]:
                best = (float(cost[j]), srt, int(ks[j]))
        _, srt, half = best
        stack.append(srt[:half])
        stack.append(srt[half:])

    C = len(leaves)
    tri_ids = np.empty((C, leaf), np.int32)
    aabb_lo = np.empty((C, 3), np.float32)
    aabb_hi = np.empty((C, 3), np.float32)
    for ci, idx in enumerate(leaves):
        pad = np.full(leaf - len(idx), idx[0], np.int64)
        tri_ids[ci] = np.concatenate([idx, pad])
        aabb_lo[ci] = lo[idx].min(0)
        aabb_hi[ci] = hi[idx].max(0)
    return ClusterSet(tri_ids=tri_ids, aabb_lo=aabb_lo, aabb_hi=aabb_hi)


def _half_area(blo, bhi):
    d = np.maximum(bhi - blo, 0.0)
    return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]


@dataclasses.dataclass(frozen=True)
class ClusterTree:
    """Frozen topology of the upper level over C clusters: a binary tree
    whose every node covers a consecutive range of cluster indices.

    A reference `r` names a box: r < C - 1 is inner node r (root = 0, parents
    before children), r >= C - 1 is cluster r - (C - 1).
    children:     (C - 1, 2) int32 references of each inner node's two halves
    pair_node:    (K,) int64 and
    pair_cluster: (K,) int64 — every (inner node, cluster below it) pair; the
                  refit is one min and one max scattered over these pairs
    depth:        edges on the longest root-to-cluster path (the traversal
                  stack needs depth + 1 entries)
    """

    children: np.ndarray
    pair_node: np.ndarray
    pair_cluster: np.ndarray
    depth: int

    @property
    def n_clusters(self) -> int:
        return self.children.shape[0] + 1


def build_tree(aabb_lo, aabb_hi) -> ClusterTree:
    """Upper-level topology over clusters in their given order.  Each range
    [a, b) is split where the surface-area heuristic (left box area × count
    + right box area × count) is least, so the spatial splits that ordered
    the clusters are found again.  O(C · depth) host work; the boxes are not
    kept: ``pack_clusters`` refits them from the live vertices."""
    lo = np.asarray(aabb_lo, np.float32)
    hi = np.asarray(aabb_hi, np.float32)
    C = lo.shape[0]
    n_inner = C - 1
    children = np.zeros((n_inner, 2), np.int32)
    ranges = np.zeros((n_inner, 2), np.int64)
    depth = 0
    next_id = 0
    # (a, b, parent, side, level); the stack order numbers nodes in preorder
    stack = [(0, C, -1, 0, 0)]
    while stack:
        a, b, parent, side, level = stack.pop()
        depth = max(depth, level)
        if b - a == 1:
            ref = n_inner + a
        else:
            ref = next_id
            next_id += 1
            ranges[ref] = (a, b)
            llo = np.minimum.accumulate(lo[a:b])
            lhi = np.maximum.accumulate(hi[a:b])
            rlo = np.minimum.accumulate(lo[a:b][::-1])[::-1]
            rhi = np.maximum.accumulate(hi[a:b][::-1])[::-1]
            ks = np.arange(1, b - a)
            cost = _half_area(llo[ks - 1], lhi[ks - 1]) * ks \
                + _half_area(rlo[ks], rhi[ks]) * (b - a - ks)
            m = a + int(ks[int(np.argmin(cost))])
            stack.append((m, b, ref, 1, level + 1))
            stack.append((a, m, ref, 0, level + 1))
        if parent >= 0:
            children[parent, side] = ref
    sizes = ranges[:, 1] - ranges[:, 0]
    pair_node = np.repeat(np.arange(n_inner, dtype=np.int64), sizes)
    starts = np.repeat(ranges[:, 0] - (np.cumsum(sizes) - sizes), sizes)
    pair_cluster = np.arange(pair_node.shape[0], dtype=np.int64) + starts
    return ClusterTree(children=children, pair_node=pair_node,
                       pair_cluster=pair_cluster, depth=depth)


def slot_order(vertices, triangles, tri_ids) -> np.ndarray:
    """(C, LEAF) int64: a permutation of each cluster's slots that makes its
    groups of GROUP consecutive slots compact.  The split goes on inside
    the cluster: every range of slots is halved along the axis (of the
    triangles' centroids) whose halves have the least summed box area,
    until ranges hold GROUP slots; all clusters split at once.  Pad slots
    (repeats of the cluster's first triangle) sort last on every axis, so
    they fill whole groups where they can.  ``tri_ids[c, order[c]]`` is the
    cluster's slots in the new order: the same set."""
    verts = np.asarray(vertices, np.float32)
    ids = np.asarray(tri_ids, np.int64)
    C, L = ids.shape
    if L % GROUP or (L // GROUP) & (L // GROUP - 1):
        raise ValueError(f"{L} slots do not halve into groups of {GROUP}")
    corners = verts[np.asarray(triangles, np.int64)[ids]]        # (C, L, 3, 3)
    pad = np.zeros((C, L, 1), bool)
    pad[:, 1:, 0] = ids[:, 1:] == ids[:, :1]
    lo = np.where(pad, np.inf, corners.min(2))
    hi = np.where(pad, -np.inf, corners.max(2))
    cent = np.where(pad, np.inf, (corners.min(2) + corners.max(2)) * 0.5)
    order = np.broadcast_to(np.arange(L), (C, L)).copy()
    rows = np.arange(C)[:, None]
    n = L
    while n > GROUP:
        h = n // 2
        ranges = order.reshape(C, L // n, n)
        best_cost, best = None, None
        for axis in range(3):
            key = cent[rows[:, :, None], ranges, axis]
            srt = np.take_along_axis(ranges, np.argsort(key, axis=2, kind="stable"), 2)
            cost = sum(_half_area(lo[rows[:, :, None], part].min(2).reshape(-1, 3),
                                  hi[rows[:, :, None], part].max(2).reshape(-1, 3))
                       for part in (srt[:, :, :h], srt[:, :, h:]))
            cost = cost.reshape(C, L // n, 1)
            if best is None:
                best_cost, best = cost, srt
            else:
                better = cost < best_cost
                best_cost = np.where(better, cost, best_cost)
                best = np.where(better, srt, best)
        order = best.reshape(C, L)
        n = h
    return order


@dataclasses.dataclass(frozen=True)
class WideTree:
    """The upper level collapsed two binary levels into one: node n's up to
    four children are the grandchildren of binary node n's (a child that is
    a cluster stands for itself).  Node 0 is the root; a tree over one
    cluster is one node with one child.

    refs:     (N4, 4) int64 — the binary reference (ClusterTree numbering)
              whose box fills each child slot, -1 where there is no child
    children: (N4, 4) int32 — what the kernel follows: a node n >= 0, a
              cluster c as -2 - c, -1 for no child
    stack:    entries the traversal stack needs at most: pushing the
              admitted children of every node on a path, far to near
    depth:    nodes on the longest root-to-cluster path
    """

    refs: np.ndarray
    children: np.ndarray
    stack: int
    depth: int


def build_wide(tree: ClusterTree) -> WideTree:
    """The 4-wide topology of a ClusterTree (host work, once a plan)."""
    n_inner = tree.children.shape[0]
    refs, children = {}, {}
    # (binary inner node, its wide number, stack entries below it, depth);
    # a tree over one cluster has no inner node and a root all the same
    todo = [(0, 0, 0, 1)]
    stack = depth = 1
    while todo:
        node, num, below, level = todo.pop()
        if n_inner == 0:
            kids = [0]
        else:
            kids = []
            for ch in tree.children[node]:
                kids.extend(tree.children[ch] if ch < n_inner else [ch])
        refs[num] = [int(k) for k in kids] + [-1] * (4 - len(kids))
        children[num] = [-1] * 4
        stack = max(stack, below + len(kids))
        depth = max(depth, level)
        for slot, k in enumerate(kids):
            if n_inner and k < n_inner:
                children[num][slot] = len(refs) + len(todo)
                todo.append((int(k), len(refs) + len(todo), below + len(kids) - 1, level + 1))
            else:
                children[num][slot] = -2 - (int(k) - n_inner)
    return WideTree(refs=np.asarray([refs[i] for i in range(len(refs))], np.int64),
                    children=np.asarray([children[i] for i in range(len(refs))], np.int32),
                    stack=stack, depth=depth)
