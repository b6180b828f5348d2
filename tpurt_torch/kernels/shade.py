"""K11, deferred shading in one launch: the wrapper of
``csrc/shade.cu:shade_records_kernel``.

``shade_records_cuda`` computes what ``shading/deferred.py:_shade_bundle``
computes (the Whitted replay of a bundle's records: (t, u, v) at the
recorded primitive, the shading normal, the material and its texture, Phong
for every light, the reflection chain, the clamp) in one thread a pixel,
for a call that wants no gradient.  ``_shade_bundle`` is its plain version
and stays the route of the CPU, of every call under autograd and of the
ring; ``deferred.shade_from_records`` picks between the two
(``deferred.takes_kernel``).  It replaces no TPU kernel:
``tpurt/shading/deferred.py`` is JAX that XLA fuses.

The kernel reads the scene's leaves where they are and takes every constant
of ``tpurt_torch/constants.py`` that the shading reads as an argument.  A
tensor on the CPU, of another dtype or shape, or not contiguous raises;
nothing falls back.
"""
from __future__ import annotations

import torch

from tpurt_torch import constants as C

#: the floor of a light's distance before it divides the light's direction
#: (``deferred._shade_bundle``, and the kernel's argument)
LIGHT_DIST_MIN = 1e-20

#: launches of the kernel since the process started
LAUNCHES = 0


#: inputs that may have any row stride (camera rays share one origin: a
#: stride of 0); their three columns are contiguous
_ROWS = ("o", "d")


def _check(name, x, shape, dtype):
    """Raise unless `x` has `dtype` and `shape` (None: any size there) and is
    contiguous (rays: in each row)."""
    if x.dtype != dtype:
        raise TypeError(f"shade_records_cuda: {name} must be {dtype}, got {x.dtype}")
    if x.dim() != len(shape) or any(s is not None and s != n for s, n in zip(shape, x.shape)):
        raise ValueError(f"shade_records_cuda: {name} must have shape {shape}, got "
                         f"{tuple(x.shape)}")
    if not (x.stride(-1) == 1 and x.stride(0) >= 0 if name in _ROWS else x.is_contiguous()):
        raise ValueError(f"shade_records_cuda: {name} must be contiguous"
                         + (" in each row" if name in _ROWS else ""))


def _inputs(scene, o, d, prim, is_tri, occ, max_depth):
    """(name, tensor) of every input the kernel reads, each checked."""
    n = o.shape[0] if o.dim() == 2 else -1
    m, f32, i32 = scene.materials, torch.float32, torch.int32
    rec = (prim.shape[0] if prim.dim() == 2 else -1, n)
    tensors = (
        ("prim", prim, (None, n), i32), ("is_tri", is_tri, rec, torch.bool),
        ("occ", occ, rec, i32),
        ("o", o, (n, 3), f32), ("d", d, (n, 3), f32),
        ("vertices", scene.vertices, (None, 3), f32),
        ("vnormals", scene.vnormals, (scene.vertices.shape[0], 3), f32),
        ("uvs", scene.uvs, (scene.vertices.shape[0], 2), f32),
        ("triangles", scene.triangles, (None, 3), i32),
        ("tri_mat", scene.tri_mat, (scene.triangles.shape[0],), i32),
        ("sph_center", scene.sph_center, (None, 3), f32),
        ("sph_radius", scene.sph_radius, (scene.sph_center.shape[0],), f32),
        ("sph_mat", scene.sph_mat, (scene.sph_center.shape[0],), i32),
        ("ka", m.ka, (None, 3), f32), ("kd", m.kd, (m.ka.shape[0], 3), f32),
        ("ks", m.ks, (m.ka.shape[0], 3), f32),
        ("shininess", m.shininess, (m.ka.shape[0],), f32),
        ("reflectivity", m.reflectivity, (m.ka.shape[0],), f32),
        ("texture_id", m.texture_id, (m.ka.shape[0],), i32),
        ("textures", scene.textures, (None, None, None, 3), f32),
        ("light_pos", scene.light_pos, (None, 3), f32),
        ("light_color", scene.light_color, (scene.light_pos.shape[0], 3), f32),
        ("ambient", scene.ambient, (3,), f32),
    )
    for name, x, shape, dtype in tensors:
        _check(name, x, shape, dtype)
    if prim.shape[0] < max_depth + 1:
        raise ValueError(f"shade_records_cuda: {prim.shape[0]} depths of records for "
                         f"max_depth {max_depth}")
    if n >= 2 ** 31:
        raise ValueError(f"shade_records_cuda: {n} pixels do not fit an int32")
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"shade_records_cuda runs on a card; o is on {dev}")
    for name, x, _, _ in tensors:
        if x.device != dev:
            raise ValueError(f"shade_records_cuda: {name} is on {x.device}, o on {dev}")
    return tensors


def shade_records_cuda(scene, o, d, prim, is_tri, occ, max_depth, shadows):
    """Colours (N, 3) f32 of N pixels: K11 on the records (prim, is_tri, occ,
    each (D, N) with D >= max_depth + 1) of rays o, d (N, 3, any row stride),
    on the current stream of their card.  Same contract as deferred._shade_bundle with no
    corner_fn."""
    from tpurt_torch.kernels import build

    global LAUNCHES
    tensors = _inputs(scene, o, d, prim, is_tri, occ, max_depth)
    ptr = {name: x.data_ptr() for name, x, _, _ in tensors}
    n = o.shape[0]
    out = torch.empty((n, 3), dtype=torch.float32, device=o.device)
    if n == 0:
        return out
    _, th, tw, _ = scene.textures.shape
    with torch.cuda.device(o.device):
        err = build.load().tpurt_shade_records(
            ptr["prim"], ptr["is_tri"], ptr["occ"], n, ptr["o"], o.stride(0), ptr["d"],
            d.stride(0),
            ptr["vertices"], ptr["vnormals"], ptr["uvs"], ptr["triangles"], ptr["tri_mat"],
            scene.n_tris, ptr["sph_center"], ptr["sph_radius"], ptr["sph_mat"],
            scene.n_spheres, int(scene.n_real_spheres != 0), ptr["ka"], ptr["kd"], ptr["ks"],
            ptr["shininess"], ptr["reflectivity"], ptr["texture_id"], ptr["textures"], th, tw,
            ptr["light_pos"], ptr["light_color"], ptr["ambient"], scene.n_lights,
            int(max_depth), int(bool(shadows)), int(bool(scene.smooth)),
            int(bool(scene.textured)), *C.BACKGROUND, C.CLAMP_LO, C.CLAMP_HI,
            C.RAY_OFFSET_EPS, C.MT_DET_EPS, C.T_MIN, C.T_MAX, C.NORMALIZE_EPS, LIGHT_DIST_MIN,
            out.data_ptr(), torch.cuda.current_stream(o.device).cuda_stream)
    build.check(err, "shade_records launch")
    LAUNCHES += 1
    return out
