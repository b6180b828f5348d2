"""The port's deferred shading against tpurt's on the same records, and its
texture lookup against the port's oracle."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.core import geom as jgeom
from tpurt.scene import configs as jconfigs
from tpurt.shading import deferred as JD
from tpurt_torch.bridge import scene_from_tpurt
from tpurt_torch.ref import oracle as toracle
from tpurt_torch.shading import deferred as TD

import torch_one_thread  # noqa: F401  (one PyTorch thread)

#: two frameworks evaluate the same FP32 expressions; pow, rsqrt and the
#: order of a dot product's sum may differ in the last bits
ATOL = 2e-5

SCENES = {
    "config3": lambda: jconfigs.config3_spheres(24, 24),
    "config4": lambda: jconfigs.config4_bunny(24, 24, subdiv=2),
    "config5": lambda: jconfigs.config5_multimesh(24, 32, n_blobs=2, subdiv=2),
}


@pytest.fixture(scope="module", params=list(SCENES))
def shaded(request):
    """tpurt's oracle records of a scene and tpurt's shading of them."""
    js, jcfg = SCENES[request.param]()
    o, d = jgeom.generate_rays(js.camera, jcfg.height, jcfg.width)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    recs = JD.records_oracle(js, o, d, jcfg.max_depth, jcfg.shadows)
    ref = JD.shade_from_records(js, o, d, recs, jcfg.max_depth, jcfg.shadows)
    ts = scene_from_tpurt(js, device="cpu")
    trecs = TD.HitRecords(*(torch.from_numpy(np.array(np.asarray(x)))
                            for x in (recs.prim, recs.is_tri, recs.occ)))
    rays = tuple(torch.from_numpy(np.array(np.asarray(x))) for x in (o, d))
    return request.param, jcfg, ts, trecs, rays, np.asarray(ref)


def test_shade_from_records_matches_tpurt(shaded):
    name, jcfg, ts, trecs, (o, d), ref = shaded
    assert ts.textured == (name == "config5")
    img = TD.shade_from_records(ts, o, d, trecs, jcfg.max_depth, jcfg.shadows)
    assert img.shape == ref.shape and img.dtype == torch.float32
    np.testing.assert_allclose(img.numpy(), ref, rtol=0, atol=ATOL)
    assert ref.std() > 0.05


def test_records_oracle_equals_tpurt(shaded):
    _, jcfg, ts, trecs, (o, d), _ = shaded
    ours = TD.records_oracle(ts, o, d, jcfg.max_depth, jcfg.shadows)
    for name in ("prim", "is_tri", "occ"):
        assert torch.equal(getattr(ours, name), getattr(trecs, name)), name


def test_shading_is_differentiable_at_fixed_records(shaded):
    _, jcfg, ts, trecs, (o, d), _ = shaded
    leaves = {"vertices": ts.vertices, "light_pos": ts.light_pos, "kd": ts.materials.kd}
    live = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    scene = dataclasses.replace(
        ts, vertices=live["vertices"], light_pos=live["light_pos"],
        materials=dataclasses.replace(ts.materials, kd=live["kd"]))
    TD.shade_from_records(scene, o, d, trecs, jcfg.max_depth, jcfg.shadows).square().sum().backward()
    for k, v in live.items():
        assert torch.isfinite(v.grad).all() and float(v.grad.abs().max()) > 0, k


def test_sample_texture_flat_equals_the_oracle_exactly():
    ts = scene_from_tpurt(SCENES["config5"]()[0], device="cpu")
    gen = torch.Generator().manual_seed(3)
    uv = torch.rand((4000, 2), generator=gen) * 20.0 - 6.0     # wraps, negative too
    uv[:8] = torch.tensor([[0.0, 0.0], [1.0, 1.0], [0.5 / 64, 0.5 / 64], [-0.25, 7.75]]).repeat(2, 1)
    mat = torch.randint(0, ts.materials.ka.shape[0], (4000,), generator=gen)
    ours = TD._sample_texture_flat(ts, ts.materials.texture_id[mat], uv)
    theirs = toracle._sample_texture(ts, mat, uv)
    assert torch.equal(ours, theirs)
    untextured = ts.materials.texture_id[mat] < 0
    assert untextured.any() and (ours[untextured] == 1.0).all()
    assert ours[~untextured].min() < 0.3 and ours[~untextured].max() > 0.8


def test_sample_texture_matches_tpurt():
    from tpurt.ref import oracle as joracle

    js = SCENES["config5"]()[0]
    ts = scene_from_tpurt(js, device="cpu")
    rng = np.random.default_rng(5)
    uv = (rng.random((2000, 2)) * 20.0 - 6.0).astype(np.float32)
    mat = rng.integers(0, 4, 2000).astype(np.int32)
    theirs = np.asarray(joracle._sample_texture(js, jnp.asarray(mat), jnp.asarray(uv)))
    ours = toracle._sample_texture(ts, torch.from_numpy(mat).long(), torch.from_numpy(uv))
    # a product of texel and weights: XLA may fuse the multiply-adds
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-6)
