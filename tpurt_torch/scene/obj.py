"""Wavefront .obj import and export, the counterpart of ``tpurt/scene/obj.py``.

Supports: v / vn / vt / f (triangles and polygon fans), negative indices,
per-face v/vt/vn index triples, usemtl grouping (a material-name id per
triangle); unknown directives are ignored.  A file is parsed by the C++
parser (``accel.native.load_obj_native``); inline lines by the numpy parser
``parse_obj_lines``, which is its plain version: the two give equal arrays
(``tests/test_torch_obj.py``).
"""
from __future__ import annotations

import os

import numpy as np

from tpurt_torch.accel.native import load_obj_native
from tpurt_torch.scene.scene import build_scene


def load_obj(path_or_lines):
    """Parse an .obj file (a path) or its lines (any iterable of str) → dict:

    vertices   (V', 3) f32
    triangles  (T, 3) i32
    uvs        (V', 2) f32 (zero where the file has none)
    normals    (V', 3) f32 or None (file normals)
    tri_group  (T,) i32 — usemtl group index per triangle
    groups     list[str] — group names, index = tri_group value

    V' counts UNIQUE (position, uv, normal) corner triples: a position
    referenced with two different uvs or normals (a texture seam or hard
    edge) is duplicated so per-corner attributes survive exactly.
    Unreferenced positions are dropped.
    """
    if isinstance(path_or_lines, (str, bytes, os.PathLike)):
        return load_obj_native(path_or_lines)
    return parse_obj_lines(path_or_lines)


def parse_obj_lines(lines):
    """The numpy parser (``tpurt``'s), the plain version of the C++ one."""
    vs, vts, vns, faces = [], [], [], []
    groups = ["default"]
    cur_group = 0
    for raw in lines:
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            vs.append([float(x) for x in parts[1:4]])
        elif tag == "vt":
            vts.append([float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0])
        elif tag == "vn":
            vns.append([float(x) for x in parts[1:4]])
        elif tag == "usemtl":
            name = parts[1] if len(parts) > 1 else "default"
            if name not in groups:
                groups.append(name)
            cur_group = groups.index(name)
        elif tag == "f":
            corners = []
            for c in parts[1:]:
                ids = c.split("/")
                vi = int(ids[0])
                ti = int(ids[1]) if len(ids) > 1 and ids[1] else 0
                ni = int(ids[2]) if len(ids) > 2 and ids[2] else 0
                corners.append((vi, ti, ni))
            # fan-triangulate polygons
            for k in range(1, len(corners) - 1):
                faces.append((corners[0], corners[k], corners[k + 1], cur_group))

    V = len(vs)

    def resolve(i, n):
        return (i - 1) if i > 0 else (n + i)

    verts_in = np.asarray(vs, np.float32).reshape(-1, 3)
    F = len(faces)
    tri_group = np.fromiter((g for *_, g in faces), np.int32, count=F)

    # one row per corner: (position idx, uv idx or -1, normal idx or -1);
    # unique rows become output vertices (seam-preserving duplication)
    corner = np.empty((F * 3, 3), np.int64)
    for t, (c0, c1, c2, _g) in enumerate(faces):
        for k, (vi, ti, ni) in enumerate((c0, c1, c2)):
            corner[t * 3 + k] = (
                resolve(vi, V),
                resolve(ti, len(vts)) if ti else -1,
                resolve(ni, len(vns)) if ni else -1,
            )
    uniq, inverse = np.unique(corner, axis=0, return_inverse=True)
    tris = inverse.reshape(F, 3).astype(np.int32)

    verts = verts_in[uniq[:, 0]]
    uvs = np.zeros((len(uniq), 2), np.float32)
    if vts:
        vt_arr = np.asarray(vts, np.float32).reshape(-1, 2)
        has_uv = uniq[:, 1] >= 0
        uvs[has_uv] = vt_arr[uniq[has_uv, 1]]
    has_normals = bool(vns) and (uniq[:, 2] >= 0).any()
    if has_normals:
        vn_arr = np.asarray(vns, np.float32).reshape(-1, 3)
        nrms = np.zeros((len(uniq), 3), np.float32)
        has_n = uniq[:, 2] >= 0
        nrms[has_n] = vn_arr[uniq[has_n, 2]]
        lens = np.linalg.norm(nrms, axis=-1, keepdims=True)
        nrms = (nrms / np.maximum(lens, 1e-20)).astype(np.float32)
    else:
        nrms = None

    return {
        "vertices": verts,
        "triangles": tris,
        "uvs": uvs,
        "normals": nrms,
        "tri_group": tri_group,
        "groups": groups,
    }


def scene_from_obj(path, materials=None, lights=None, camera=None, smooth=True,
                   device=None, **kw):
    """Load an .obj straight into a Scene on `device` (the card unless
    ``device="cpu"``); usemtl groups map to material ids in order of first
    appearance."""
    mesh = load_obj(path)
    return build_scene(
        vertices=mesh["vertices"],
        triangles=mesh["triangles"],
        tri_mat=mesh["tri_group"],
        vnormals=mesh["normals"],
        uvs=mesh["uvs"],
        materials=materials or [{"kd": 0.7} for _ in mesh["groups"]],
        lights=lights,
        camera=camera,
        smooth=smooth,
        device=device,
        **kw,
    )


def save_obj(path, vertices, triangles, uvs=None, normals=None,
             group_names=None, tri_group=None):
    """Write a mesh as Wavefront .obj (per-vertex uv/normal layout — the
    inverse of load_obj's seam-duplicated output; positions are written with
    9 significant digits, which read back to the same float32)."""
    vertices = np.asarray(vertices)
    triangles = np.asarray(triangles)
    has_uv = uvs is not None
    has_n = normals is not None
    with open(path, "w") as f:
        f.write("# tpurt mesh export\n")
        for v in vertices:
            f.write(f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n")
        if has_uv:
            for t in np.asarray(uvs):
                f.write(f"vt {t[0]:.9g} {t[1]:.9g}\n")
        if has_n:
            for n in np.asarray(normals):
                f.write(f"vn {n[0]:.9g} {n[1]:.9g} {n[2]:.9g}\n")
        cur = -1
        for ti, tri in enumerate(triangles):
            if tri_group is not None and tri_group[ti] != cur:
                cur = int(tri_group[ti])
                name = (group_names[cur] if group_names is not None
                        else f"mat{cur}")
                f.write(f"usemtl {name}\n")
            idx = [int(i) + 1 for i in tri]
            if has_uv and has_n:
                f.write("f {0}/{0}/{0} {1}/{1}/{1} {2}/{2}/{2}\n".format(*idx))
            elif has_uv:
                f.write("f {0}/{0} {1}/{1} {2}/{2}\n".format(*idx))
            elif has_n:
                f.write("f {0}//{0} {1}//{1} {2}//{2}\n".format(*idx))
            else:
                f.write("f {0} {1} {2}\n".format(*idx))
    return path
