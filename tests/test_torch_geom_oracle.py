"""The port's geometry routines and oracle against tpurt's, on the same
seeded inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.core import geom as jgeom
from tpurt.ref import render_ref as j_render_ref
from tpurt.scene import configs as jconfigs
from tpurt_torch.bridge import scene_from_tpurt
from tpurt_torch.core import geom as tgeom
from tpurt_torch.ref.oracle import render_ref as t_render_ref

import torch_one_thread  # noqa: F401  (one PyTorch thread)

ATOL = 1e-5        # geometry: f32 rounding of a few dozen ops
IMG_ATOL = 2e-4    # images: the bar of tests/test_kernels.py


def _rays(rng, n=256):
    o = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _both(*arrays):
    """Each array as (jnp, torch)."""
    return [(jnp.asarray(a), torch.from_numpy(a)) for a in arrays]


def _eq(ours, theirs, atol=ATOL):
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=atol)


def test_generate_rays():
    js, cfg = jconfigs.config3_spheres(12, 20)
    ts = scene_from_tpurt(js, device="cpu")
    jo, jd = jgeom.generate_rays(js.camera, 12, 20, row0=3, nrows=5)
    to, td = tgeom.generate_rays(ts.camera, 12, 20, row0=3, nrows=5)
    _eq(to, jo)
    _eq(td, jd)


def test_intersect_tris():
    rng = np.random.default_rng(0)
    o, d = _rays(rng)
    v0 = rng.uniform(-2, 2, (7, 3)).astype(np.float32)
    e1 = rng.uniform(-2, 2, (7, 3)).astype(np.float32)
    e2 = rng.uniform(-2, 2, (7, 3)).astype(np.float32)
    (jo, to), (jd, td), (jv, tv), (je1, te1), (je2, te2) = _both(o, d, v0, e1, e2)
    jhit, jt, ju, jv_ = jgeom.intersect_tris(jo, jd, jv, je1, je2)
    thit, tt, tu, tv_ = tgeom.intersect_tris(to, td, tv, te1, te2)
    assert np.asarray(jhit).any()
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    m = np.asarray(jhit)
    for ours, theirs in ((tt, jt), (tu, ju), (tv_, jv_)):
        _eq(ours[torch.tensor(m)], np.asarray(theirs)[m])


def test_intersect_spheres_and_normals():
    rng = np.random.default_rng(1)
    o, d = _rays(rng)
    c = rng.uniform(-2, 2, (5, 3)).astype(np.float32)
    r = rng.uniform(0.3, 1.2, (5,)).astype(np.float32)
    (jo, to), (jd, td), (jc, tc), (jr, tr) = _both(o, d, c, r)
    jhit, jt = jgeom.intersect_spheres(jo, jd, jc, jr)
    thit, tt = tgeom.intersect_spheres(to, td, tc, tr)
    assert np.asarray(jhit).any()
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    _eq(tt, jt)
    _eq(tgeom.sphere_normal(to, tc[0]), jgeom.sphere_normal(jo, jc[0]))


@pytest.mark.parametrize("k", [2, 3])
def test_closest_and_any_hit(k):
    js, _ = jconfigs.ALL_CONFIGS[k](8, 8)
    ts = scene_from_tpurt(js, device="cpu")
    rng = np.random.default_rng(k)
    o, d = _rays(rng)
    o = o * np.float32(0.3) + np.asarray([0.0, 1.0, 0.0], np.float32)
    (jo, to), (jd, td) = _both(o, d)
    jrec = jax.jit(jgeom.closest_hit)(js, jo, jd)
    trec = tgeom.closest_hit(ts, to, td)
    for key in ("hit", "is_tri", "prim"):
        np.testing.assert_array_equal(trec[key].numpy(), np.asarray(jrec[key]), key)
    _eq(trec["t"], jrec["t"])
    m = np.asarray(jrec["hit"])   # u, v of a miss are whatever triangle 0 gave
    for key in ("u", "v"):
        _eq(trec[key][torch.tensor(m)], np.asarray(jrec[key])[m])
    tmax = rng.uniform(0.5, 4.0, 256).astype(np.float32)
    np.testing.assert_array_equal(
        tgeom.any_hit(ts, to, td, torch.from_numpy(tmax)).numpy(),
        np.asarray(jax.jit(jgeom.any_hit)(js, jo, jd, jnp.asarray(tmax))))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_render_ref_matches_tpurt(k):
    js, cfg = jconfigs.ALL_CONFIGS[k](24, 24)
    ref = np.asarray(j_render_ref(js, config=cfg))
    img = t_render_ref(scene_from_tpurt(js, device="cpu"), config=cfg, chunk=200)
    np.testing.assert_allclose(img.numpy(), ref, rtol=0, atol=IMG_ATOL)
