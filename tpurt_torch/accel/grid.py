"""Host-side uniform-grid build, a copy of ``tpurt/accel/grid.py`` (numpy
only; a test holds the two equal on ``tri_ids``, boxes, dims, origin and
cell size).  It is the plain version of ``accel/native.py``'s
``build_grid_native``, which ``prepare(accel="grid")`` calls.

The grid is a second partitioning policy feeding the same traversal: each
occupied cell's triangle list is padded to LEAF with duplicates and becomes
a cluster block whose box is the cell box cut to the block's triangles.  A
cell with more than LEAF triangles spills into several blocks, and one
triangle lies in every cell its box overlaps.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from tpurt_torch.accel.clusters import LEAF, ClusterSet


@dataclasses.dataclass(frozen=True)
class GridSet:
    """Uniform grid metadata + its cluster-block flattening."""

    clusters: ClusterSet
    origin: np.ndarray      # (3,) grid origin
    cell_size: np.ndarray   # (3,)
    dims: tuple             # (nx, ny, nz)


def build_grid(vertices, triangles, target_tris_per_cell: int = 64) -> GridSet:
    """Uniform grid sized so the average occupied cell holds roughly
    `target_tris_per_cell` triangles; cells become padded cluster blocks,
    in the order each cell is first touched (dict insertion order)."""
    verts = np.asarray(vertices, np.float32)
    tris = np.asarray(triangles, np.int64)
    T = max(tris.shape[0], 1)
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    scene_lo = lo.min(0)
    scene_hi = hi.max(0)
    extent = np.maximum(scene_hi - scene_lo, 1e-6)

    # heuristic: n_cells ≈ T / target, distributed by extent
    n_cells = max(1, T // target_tris_per_cell)
    k = (n_cells / np.prod(extent / extent.max())) ** (1 / 3) / extent.max()
    dims = tuple(int(np.clip(np.ceil(e * k), 1, 256)) for e in extent)
    cell = extent / np.asarray(dims, np.float32)

    # rasterize each triangle's AABB into overlapping cells
    lo_cell = np.clip(((lo - scene_lo) / cell).astype(np.int64), 0, np.asarray(dims) - 1)
    hi_cell = np.clip(((hi - scene_lo) / cell).astype(np.int64), 0, np.asarray(dims) - 1)

    cell_map: dict[tuple, list] = {}
    for t in range(tris.shape[0]):
        for x in range(lo_cell[t, 0], hi_cell[t, 0] + 1):
            for y in range(lo_cell[t, 1], hi_cell[t, 1] + 1):
                for z in range(lo_cell[t, 2], hi_cell[t, 2] + 1):
                    cell_map.setdefault((x, y, z), []).append(t)

    blocks, blos, bhis = [], [], []
    for (x, y, z), ids in cell_map.items():
        clo = scene_lo + np.asarray([x, y, z]) * cell
        chi = clo + cell
        for s in range(0, len(ids), LEAF):
            chunk = np.asarray(ids[s : s + LEAF], np.int64)
            pad = np.full(LEAF - len(chunk), chunk[0], np.int64)
            blocks.append(np.concatenate([chunk, pad]).astype(np.int32))
            # tighten to the triangles actually in the block ∩ cell box
            blos.append(np.maximum(lo[chunk].min(0), clo).astype(np.float32))
            bhis.append(np.minimum(hi[chunk].max(0), chi).astype(np.float32))

    cs = ClusterSet(
        tri_ids=np.stack(blocks, 0),
        aabb_lo=np.stack(blos, 0),
        aabb_hi=np.stack(bhis, 0),
    )
    return GridSet(
        clusters=cs,
        origin=scene_lo,
        cell_size=cell.astype(np.float32),
        dims=dims,
    )
