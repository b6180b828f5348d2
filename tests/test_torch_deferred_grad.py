"""The gradient of the port's deferred shading, whose vertex-table,
material-table, sphere-table and texel backward is the sorted segment sum,
against tpurt's on the same records, rays and scene: tpurt with its vtab
route and its Pallas segment-sum kernel forced on (as
tests/test_grad.py:324-327 does), in interpret mode on the CPU.  The
records come from tpurt's brute-force oracle, so no traversal kernel runs.
On CPU tensors the port's segment sum is its plain version; the card tests
hold the CUDA kernel to it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.core import geom as jgeom
from tpurt.scene import configs as jconfigs
from tpurt.shading import deferred as JD
from tpurt_torch.bridge import scene_from_tpurt
from tpurt_torch.kernels import segsum as TS
from tpurt_torch.shading import deferred as TD

import torch_one_thread  # noqa: F401  (one PyTorch thread)

SCENES = {
    "config3": lambda: jconfigs.config3_spheres(16, 16),   # three spheres, depth 2
    "config4": lambda: jconfigs.config4_bunny(20, 20, subdiv=1),
    "config5": lambda: jconfigs.config5_multimesh(16, 24, n_blobs=2, subdiv=1),   # textured
}
LEAVES = ("vertices", "vnormals", "uvs", "light_pos", "light_color", "textures", "sph_center",
          "sph_radius")
MATERIAL_LEAVES = ("ka", "kd", "ks", "shininess")


@pytest.fixture(scope="module", params=list(SCENES))
def case(request):
    """tpurt's gradient of sum(img²) at its oracle's records, through its
    segment-sum kernel; the same scene, rays and records as torch tensors."""
    js, jcfg = SCENES[request.param]()
    o, d = jgeom.generate_rays(js.camera, jcfg.height, jcfg.width)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    recs = JD.records_oracle(js, o, d, jcfg.max_depth, jcfg.shadows)

    def loss(s):
        return jnp.sum(JD.shade_from_records(s, o, d, recs, jcfg.max_depth, jcfg.shadows) ** 2)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JD, "_PACK_DIRECT_ENV", "1")   # the vtab route
        mp.setattr(JD, "_VTAB_SEGSUM_ENV", "1")   # its Pallas segment sum
        gj = jax.grad(loss, allow_int=True)(js)
    ts = scene_from_tpurt(js, device="cpu")
    trecs = TD.HitRecords(*(torch.from_numpy(np.array(np.asarray(x)))
                            for x in (recs.prim, recs.is_tri, recs.occ)))
    rays = tuple(torch.from_numpy(np.array(np.asarray(x))) for x in (o, d))
    want = {f: np.asarray(getattr(gj, f)) for f in LEAVES}
    want.update({f: np.asarray(getattr(gj.materials, f)) for f in MATERIAL_LEAVES})
    return request.param, jcfg, ts, trecs, rays, want


def _grads(ts, trecs, rays, jcfg):
    live = {f: getattr(ts, f).clone().requires_grad_(True) for f in LEAVES}
    mats = {f: getattr(ts.materials, f).clone().requires_grad_(True) for f in MATERIAL_LEAVES}
    scene = dataclasses.replace(ts, **live, materials=dataclasses.replace(ts.materials, **mats))
    img = TD.shade_from_records(scene, *rays, trecs, jcfg.max_depth, jcfg.shadows)
    live.update(mats)
    got = torch.autograd.grad(img.square().sum(), list(live.values()), allow_unused=True)
    return {f: (torch.zeros_like(live[f]) if g is None else g).numpy()
            for f, g in zip(live, got)}


def _live_depths(ts, trecs):
    """The depths that shade_from_records shades: depth 0, and each depth
    that some lane reaches by a reflective hit (a dead lane's id is -1)."""
    refl = ts.materials.reflectivity
    n = 1
    for prim, is_tri in zip(trecs.prim[:-1], trecs.is_tri[:-1]):
        mat = torch.where(is_tri, ts.tri_mat[prim.clamp(0, ts.n_tris - 1)],
                          ts.sph_mat[prim.clamp(0, ts.n_spheres - 1)])
        if not bool(((prim >= 0) & (refl[mat.long()] > 0)).any()):
            break
        n += 1
    return n


def _zero_leaves(ts):
    """Leaves whose gradient is zero on this scene: uvs and textures where it
    is untextured, normals where it is flat (faceted triangles read no vertex
    normal), the sphere table where it has no sphere."""
    zero = set()
    if not ts.textured:
        zero |= {"uvs", "textures"}
    if not ts.smooth:
        zero.add("vnormals")
    if ts.n_real_spheres == 0:
        zero |= {"sph_center", "sph_radius"}
    return zero


def test_deferred_gradients_match_tpurt(case):
    name, jcfg, ts, trecs, rays, want = case
    TS.reset_launches()
    got = _grads(ts, trecs, rays, jcfg)
    # a segment sum a live depth for each table the scene has: the vertex
    # table, the material table, the sphere table and the texels
    tables = 2 + ts.textured + (ts.n_real_spheres != 0)
    depths = _live_depths(ts, trecs)
    assert TS.launches["sorted_segsum_reference"] == depths * tables
    assert depths == (3 if name == "config3" else 1)
    zero = _zero_leaves(ts)
    for f, a in want.items():
        assert np.isfinite(got[f]).all(), f
        assert (np.abs(a).max() > 0) == (f not in zero), (f, "zero on this scene" if f in zero
                                                          else "nonzero on this scene")
        # the bar of tests/test_traversal.py:89, relative to the leaf's
        # largest gradient: sums over pixels in two orders
        np.testing.assert_allclose(got[f], a, rtol=0, atol=2e-4 * (np.abs(a).max() + 1e-6),
                                   err_msg=f)


def test_segment_sum_route_matches_plain_indexing(case, monkeypatch):
    _, jcfg, ts, trecs, rays, _ = case
    got = _grads(ts, trecs, rays, jcfg)
    monkeypatch.setattr(TD, "gather_rows", TD.gather_rows_reference)
    TS.reset_launches()
    plain = _grads(ts, trecs, rays, jcfg)
    assert TS.launches["sorted_segsum_reference"] == 0
    for f in got:
        # the same f32 updates, summed per row in two orders (on the CPU both
        # are serial: the stable sort keeps index_put's order within a row)
        np.testing.assert_allclose(got[f], plain[f], rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(plain[f]).max()), err_msg=f)


def test_gather_rows_gradcheck_and_dropped_lanes():
    rng = np.random.default_rng(0)
    vtab = torch.from_numpy(rng.standard_normal((7, 4))).requires_grad_(True)   # float64
    idx3 = torch.from_numpy(rng.integers(0, 7, (9, 3)))
    live = torch.ones(9, dtype=torch.bool)
    assert torch.autograd.gradcheck(lambda t: TD.gather_rows(t, idx3, live), (vtab,))
    # a lane outside `live` reads its rows but sends no cotangent back
    live[::2] = False
    out = TD.gather_rows(vtab, idx3, live)
    assert torch.equal(out, vtab[idx3])
    g, = torch.autograd.grad(out.sum(), vtab)
    want = torch.zeros(7, dtype=torch.float64).index_add_(
        0, idx3[live].reshape(-1), torch.ones(int(live.sum()) * 3, dtype=torch.float64))
    assert torch.equal(g, want[:, None].expand(7, 4))


def test_vertex_table_columns():
    js, _ = SCENES["config5"]()
    ts = scene_from_tpurt(js, device="cpu")
    vtab = TD._build_vtab(ts)
    assert ts.smooth and ts.textured and vtab.shape == (ts.vertices.shape[0], 8)
    assert torch.equal(vtab, torch.cat([ts.vertices, ts.vnormals, ts.uvs], 1))
    np.testing.assert_array_equal(vtab.numpy(), np.asarray(JD._build_vtab(js)))
    flat = dataclasses.replace(ts, smooth=False, textured=False)
    assert TD._build_vtab(flat) is flat.vertices
