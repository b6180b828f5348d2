"""The port's box helpers (tpurt_torch.core.aabb) against tpurt.core.aabb on
the same seeded boxes and rays, axis-parallel rays with infinite 1/d among
them (and origins on a slab plane, where 0·inf makes the test miss in both)."""
import numpy as np
import pytest
import torch

from tpurt.core import aabb as jaabb
from tpurt_torch.core import aabb

import torch_one_thread  # noqa: F401  (one PyTorch thread)


def _boxes(rng, n):
    lo = rng.uniform(-2.0, 1.0, (n, 3)).astype(np.float32)
    return lo, (lo + rng.uniform(-0.2, 2.0, (n, 3))).astype(np.float32)  # a few inverted


def _rays(rng, n):
    o = rng.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[: n // 4, rng.integers(0, 3, n // 4)] = 0.0          # axis-parallel in one axis
    d[n // 4: n // 3, :2] = 0.0                              # along z
    with np.errstate(divide="ignore"):
        inv_d = (1.0 / d).astype(np.float32)
    return o, inv_d


@pytest.mark.parametrize("seed", [0, 1])
def test_ray_aabb_matches_tpurt(seed):
    rng = np.random.default_rng(seed)
    n = 512
    lo, hi = _boxes(rng, n)
    o, inv_d = _rays(rng, n)
    o[:8, 0], inv_d[:8, 0] = lo[:8, 0], np.inf               # on a slab plane, along it
    for t_min, t_max in ((1e-4, 1e30), (0.5, 3.0)):
        with np.errstate(invalid="ignore"):                  # tpurt's 0·inf, in numpy
            want_hit, want_t = (np.asarray(x)
                                for x in jaabb.ray_aabb(o, inv_d, lo, hi, t_min, t_max))
        assert np.isnan(want_t[:8]).all() and not want_hit[:8].any()
        hit, t = aabb.ray_aabb(*(torch.from_numpy(x) for x in (o, inv_d, lo, hi)), t_min, t_max)
        np.testing.assert_array_equal(hit.numpy(), want_hit)
        np.testing.assert_array_equal(t.numpy(), want_t)
        assert 0 < want_hit.sum() < n
    # the defaults, and one box broadcast against every ray
    with np.errstate(invalid="ignore"):
        want = jaabb.ray_aabb(o, inv_d, lo[:1], hi[:1])
    got = aabb.ray_aabb(*(torch.from_numpy(x) for x in (o, inv_d, lo[:1], hi[:1])))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_union_and_surface_area_match_tpurt():
    rng = np.random.default_rng(2)
    lo_a, hi_a = _boxes(rng, 64)
    lo_b, hi_b = _boxes(rng, 64)
    got = aabb.union(*(torch.from_numpy(x) for x in (lo_a, hi_a, lo_b, hi_b)))
    want = jaabb.union(lo_a, hi_a, lo_b, hi_b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    sa = aabb.surface_area(torch.from_numpy(lo_a), torch.from_numpy(hi_a)).numpy()
    np.testing.assert_array_equal(sa, np.asarray(jaabb.surface_area(lo_a, hi_a)))
    assert (sa >= 0).all()
