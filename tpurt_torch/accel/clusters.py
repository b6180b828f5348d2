"""Host-side cluster build, a copy of ``tpurt/accel/clusters.py`` (numpy
only; a test holds the two equal on ``tri_ids`` and boxes).

A median-split BVH is descended only until leaves hold <= LEAF triangles;
each leaf becomes a CLUSTER, one contiguous padded block of triangle slots.
The split position is a multiple of `leaf` (so leaves come out full) chosen
by a surface-area-heuristic sweep over the three centroid-sorted axes.
Leaves are emitted in depth-first order of the splits, so consecutive
cluster indices are spatial neighbours: the upper level that the CUDA
traversal kernel walks (``build_tree`` below) is a tree over consecutive
ranges of cluster indices.

Padding uses DUPLICATES of the cluster's first triangle: duplicates are
harmless under closest-hit (ties resolve to the same triangle id) and under
any-hit (boolean or).
"""
from __future__ import annotations

import dataclasses

import numpy as np

LEAF = 128  # triangle slots per cluster


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
