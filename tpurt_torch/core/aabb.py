"""Axis-aligned box helpers (slab method) on tensors, the counterpart of
``tpurt/core/aabb.py``.  No render path calls them (the traversal kernel and
``kernels/packc.py`` have their own box tests); they complete the port's
module list and are held to ``tpurt``'s by ``tests/test_torch_aabb.py``."""
from __future__ import annotations

import torch

from tpurt_torch import constants as C


def ray_aabb(o, inv_d, lo, hi, t_min=C.T_MIN, t_max=C.T_MAX):
    """Slab test.  ``o``/``inv_d``: (..., 3) ray origin and 1/direction;
    ``lo``/``hi``: (..., 3) box corners (broadcast against the rays).

    Returns (hit: bool tensor, t_near).  An axis-parallel ray takes ±inf in
    inv_d; IEEE arithmetic then keeps the test right unless an origin lies on
    that axis's slab plane, where 0·inf is NaN and the ray misses (NaN
    propagates through minimum and maximum, as in ``tpurt``)."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tnear = torch.minimum(t0, t1).amax(-1)
    tfar = torch.maximum(t0, t1).amin(-1)
    tnear = torch.maximum(tnear, tnear.new_tensor(t_min))
    tfar = torch.minimum(tfar, tfar.new_tensor(t_max))
    return tnear <= tfar, tnear


def union(lo_a, hi_a, lo_b, hi_b):
    """The smallest box holding both boxes: (lo, hi)."""
    return torch.minimum(lo_a, lo_b), torch.maximum(hi_a, hi_b)


def surface_area(lo, hi):
    """Surface area of boxes (..., 3); an inverted extent counts as 0."""
    d = (hi - lo).clamp_min(0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])
