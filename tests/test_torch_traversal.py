"""The port's traversal records against tpurt's, lane by lane.

tpurt's kernel runs in Pallas interpret mode on the CPU, as its own tests run
it; the port runs its plain versions (the CUDA kernel is held to them on the
card, tests/test_torch_cuda.py).  ids and occ are integers: every comparison
here is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.accel import build_clusters as jbuild_clusters
from tpurt.core import geom as jgeom
from tpurt.kernels import traversal as JTV
from tpurt.kernels.packc import pack_clusters as jpack_clusters
from tpurt.scene import configs as jconfigs
from tpurt.shading.deferred import records_oracle as jrecords_oracle
from tpurt_torch.bridge import scene_from_tpurt
from tpurt_torch.core import geom as tgeom
from tpurt_torch.core.types import RenderConfig
from tpurt_torch.kernels import traversal as TTV
from tpurt_torch.kernels.packc import pack_clusters as tpack_clusters
from tpurt_torch.shading.deferred import records_from_ids
from tpurt_torch.shading.deferred import records_oracle as trecords_oracle

H = W = 32


def _both(js, jcfg):
    """A tpurt scene packed in both packages over the same clusters."""
    cs = jbuild_clusters(np.asarray(js.vertices), np.asarray(js.triangles))
    jp = jpack_clusters(js, jnp.asarray(cs.tri_ids))
    ts = scene_from_tpurt(js, device="cpu")
    tp = tpack_clusters(ts, torch.from_numpy(cs.tri_ids))
    tcfg = RenderConfig(width=jcfg.width, height=jcfg.height, max_depth=jcfg.max_depth,
                        shadows=jcfg.shadows)
    return jp, ts, tp, tcfg


@pytest.fixture(scope="module")
def config3():
    """config 3 (2 triangles, 3 reflective spheres, depth 2, 2 lights) at
    32x32: tpurt's wavefront records, computed once."""
    js, jcfg = jconfigs.config3_spheres(H, W)
    jp, ts, tp, tcfg = _both(js, jcfg)
    ids, occ = JTV._wavefront_records(js, jcfg, jp, 0, H)
    return js, jcfg, ts, tp, tcfg, np.asarray(ids), np.asarray(occ)


def test_multibounce_records_equal_tpurt_wavefront(config3):
    _, _, _, tp, tcfg, ids_j, occ_j = config3
    TTV.reset_launches()
    ids, occ, tb, stats = TTV.trace_records(tp, tcfg, 0, H)
    assert {k: n for k, n in TTV.launches.items() if n} == {"trace_records_reference": 1}
    assert stats is None and ids.dtype == occ.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), ids_j)
    np.testing.assert_array_equal(occ.numpy(), occ_j)
    # dead and missing lanes: id -1, occ 0, t T_NONE; live lanes: t in range
    dead = ids.numpy() < 0
    assert (occ.numpy()[dead] == 0).all() and (tb.numpy()[dead] == np.float32(1e30)).all()
    assert (tb.numpy()[~dead] < 1e3).all() and dead[1:].any() and (~dead[2]).any()


def test_wavefront_records_equal_tpurt_wavefront(config3):
    _, _, ts, tp, tcfg, ids_j, occ_j = config3
    TTV.reset_launches()
    ids, occ = TTV._wavefront_records(ts, tcfg, tp, 0, H)
    assert {k: n for k, n in TTV.launches.items() if n} == {
        "trace_records_reference": 1, "trace_bounce_reference": 2}
    np.testing.assert_array_equal(ids.numpy(), ids_j)
    np.testing.assert_array_equal(occ.numpy(), occ_j)


def test_records_equal_both_oracles(config3):
    js, jcfg, ts, tp, tcfg, _, _ = config3
    ids, occ, _, _ = TTV.trace_records(tp, tcfg, 0, H)
    recs = records_from_ids(ids, occ, ts.n_tris)
    o, d = jgeom.generate_rays(js.camera, H, W)
    jrecs = jrecords_oracle(js, o.reshape(-1, 3), d.reshape(-1, 3), jcfg.max_depth, jcfg.shadows)
    np.testing.assert_array_equal(recs.prim.numpy(), np.asarray(jrecs.prim))
    np.testing.assert_array_equal(recs.is_tri.numpy(), np.asarray(jrecs.is_tri))
    np.testing.assert_array_equal(recs.occ.numpy(), np.asarray(jrecs.occ))
    o, d = tgeom.generate_rays(ts.camera, H, W)
    trecs = trecords_oracle(ts, o.reshape(-1, 3), d.reshape(-1, 3), tcfg.max_depth, tcfg.shadows)
    for name in ("prim", "is_tri", "occ"):
        assert torch.equal(getattr(recs, name), getattr(trecs, name)), name


def test_mesh_records_equal_tpurt_kernel():
    js, jcfg = jconfigs.config4_bunny(H, W, subdiv=2)   # 322 triangles, smooth normals
    # no material of config 4 reflects: prepare() caps the depth at 0, and this
    # one launch with in-kernel shadows is what render() makes of it
    jcfg = jcfg.replace(max_depth=0)
    jp, ts, tp, tcfg = _both(js, jcfg)
    ids_j, occ_j, tb_j, _ = JTV.trace_records(jp, jcfg, 0, H)
    ids, occ, tb, _ = TTV.trace_records(tp, tcfg, 0, H)
    ids_j, occ_j, tb_j = (np.asarray(JTV._untile(x, H, W)) for x in (ids_j, occ_j, tb_j))
    np.testing.assert_array_equal(ids.numpy(), ids_j)
    np.testing.assert_array_equal(occ.numpy(), occ_j)
    assert (ids.numpy()[0] >= 0).mean() > 0.3 and (occ.numpy()[0] > 0).any()
    # the two kernels evaluate the same forms in another order: t to 1e-5
    hit = ids_j >= 0
    np.testing.assert_allclose(tb.numpy()[hit], tb_j[hit], rtol=1e-5)
    # one trace_records launch with the counters on: brute force counts
    stats = TTV.trace_records(tp, tcfg, 0, H, count=True)[3]
    assert dict(zip(TTV.STAT_NAMES, stats.tolist()))["tri_tests"] % tp.n_slots == 0


def test_bounce_reference_equals_tpurt_on_random_rays():
    js, jcfg = jconfigs.config3_spheres(H, W)
    jp, _, tp, tcfg = _both(js, jcfg)
    rng = np.random.default_rng(11)
    n = JTV.RAYS
    o = rng.uniform([-3, 0.2, -3], [3, 3, 3], (n, 3)).astype(np.float32)
    target = rng.uniform([-2, 0, -2], [2, 1.5, 2], (n, 3)).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    n_live = 700
    alive = np.arange(n) < n_live
    alive[rng.integers(0, n_live, 50)] = False
    ids_j, occ_j, _, _ = JTV.trace_bounce(jp, jcfg, jnp.asarray(o), jnp.asarray(d),
                                          jnp.asarray(alive), jnp.int32(n_live))
    ids, occ, _, _ = TTV.trace_bounce(tp, tcfg, torch.from_numpy(o), torch.from_numpy(d),
                                      torch.from_numpy(alive), n_live)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_j))
    assert (ids.numpy()[~alive] == -1).all() and (ids.numpy() >= 0).sum() > 300
    assert (ids.numpy() >= 2).any() and (occ.numpy() > 0).any()


def test_shadow_rebin_equals_in_kernel_shadows(monkeypatch):
    """The re-binned shadow launch over hit points recomputed outside the
    kernel gives the occlusion bits of the in-kernel shadows: the same ray
    construction and band, another order of the rays.  The gate is lowered
    so that the small scene takes the re-binned path, and one material
    reflects so that the wavefront loop runs."""
    js, jcfg = jconfigs.config5_multimesh(24, 32, n_blobs=2, subdiv=2)
    _, ts, tp, tcfg = _both(js, jcfg)
    ts.materials.reflectivity[1] = 0.25
    tp = tpack_clusters(ts, torch.from_numpy(
        jbuild_clusters(np.asarray(js.vertices), np.asarray(js.triangles)).tri_ids))
    ids_k, occ_k = TTV._wavefront_records(ts, tcfg, tp, 0, 24)
    monkeypatch.setattr(TTV, "SHADOW_REBIN_MIN_CLUSTERS", 0)
    TTV.reset_launches()
    ids_r, occ_r = TTV._wavefront_records(ts, tcfg, tp, 0, 24)
    assert {k: n for k, n in TTV.launches.items() if n} == {
        "trace_records_reference": 1, "trace_bounce_reference": 1,
        "trace_shadows_reference": 2}
    assert torch.equal(ids_r, ids_k) and torch.equal(occ_r, occ_k)
    assert (ids_k[1] >= 0).any() and (occ_k[1] > 0).any()
    ids_o, occ_o = TTV._wavefront_records(ts, tcfg.replace(shadow_rebin=False), tp, 0, 24)
    assert torch.equal(occ_o, occ_k) and torch.equal(ids_o, ids_k)
