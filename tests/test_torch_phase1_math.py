"""The phase-1 body's arithmetic on the CPU (csrc/phase1_math.cuh and its
plain version in tpurt_torch/kernels/megakernel.py): the exact FMA the plain
version computes where the kernels write out __fmaf_rn, and the early
rejections of the kernels' triangle and sphere tests, each against the
formula without it, bit for bit.  No JAX here, so the card tests
(tests/test_torch_cuda.py) take their FMA cases from this file.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

from tpurt_torch import constants as C
from tpurt_torch.kernels import megakernel as MK
from tpurt_torch.kernels import pack as PK
from tpurt_torch.kernels.pack import pack_scene
from tpurt_torch.scene import configs

import torch_one_thread  # noqa: F401  (one PyTorch thread)

F32 = np.float32


def _f32(bits):
    return np.asarray(bits, dtype=np.uint32).view(F32)


def fma_cases(n: int, seed: int):
    """(a, b, c) float32 arrays: random triples whose exponents span the
    whole range, and triples built to be hard: signed zeros, subnormal
    inputs and products, exact ties between two floats, near ties, a·b ≈ −c
    cancellation, and wide exponent gaps between a·b and c."""
    rng = np.random.default_rng(seed)
    out = []
    # any finite float32: random sign, exponent and mantissa
    sign = rng.integers(0, 2, (3, n), dtype=np.uint32) << np.uint32(31)
    expo = rng.integers(0, 255, (3, n), dtype=np.uint32) << np.uint32(23)
    out.append(_f32(sign | expo | rng.integers(0, 2 ** 23, (3, n), dtype=np.uint32)))
    # moderate magnitudes, where the kernels live
    out.append((rng.standard_normal((3, n)) * 10.0 ** rng.integers(-6, 7, (3, n))).astype(F32))
    # signed zeros against zeros, subnormals and normals
    z = np.array([0.0, -0.0], F32)
    sub = _f32([1, 0x80000001, 0x007FFFFF, 0x807FFFFF, 0x00400000])
    small = np.array([1.0, -1.0, 1e-20, -3e-30, 2.0 ** -75], F32)
    pool = np.concatenate([z, sub, small])
    grid = np.array(np.meshgrid(pool, pool, pool)).reshape(3, -1)
    out.append(grid.astype(F32))
    # exact ties: a·b = (2j + 1)·ulp(c)/2, and the floats either side of them
    c = (rng.standard_normal(n) * 10.0 ** rng.integers(-30, 30, n)).astype(F32)
    ulp = np.spacing(np.abs(c)).astype(np.float64)
    j = rng.integers(0, 4, n)
    a = (2 * j + 1).astype(F32)
    b = (ulp / 2.0).astype(F32)
    for bb in (b, np.nextafter(b, F32(np.inf)), np.nextafter(b, F32(-np.inf))):
        sign = np.where(rng.random(n) < 0.5, -1, 1).astype(F32)
        out.append(np.stack([a * sign, bb, c]))
    # cancellation: c = -fl(a·b), nudged by a few ulps
    a = rng.standard_normal(n).astype(F32)
    b = rng.standard_normal(n).astype(F32)
    c = -(a * b)
    k = rng.integers(-3, 4, n)
    c = np.where(k > 0, np.nextafter(c, F32(np.inf)), np.where(k < 0, np.nextafter(c, F32(-np.inf)), c))
    out.append(np.stack([a, b, c.astype(F32)]))
    # wide exponent gaps: a·b far above or far below c
    big = (rng.standard_normal((2, n)) * 1e18).astype(F32)
    tiny = (rng.standard_normal(n) * 1e-30).astype(F32)
    out.append(np.stack([big[0], big[1], tiny]))
    out.append(np.stack([tiny, (rng.standard_normal(n) * 1e-10).astype(F32), big[0]]))
    # products in the subnormal range
    out.append(np.stack([(rng.standard_normal(n) * 1e-22).astype(F32),
                         (rng.standard_normal(n) * 1e-22).astype(F32),
                         (rng.standard_normal(n) * 1e-44).astype(F32)]))
    a, b, c = np.concatenate(out, axis=1)
    return a, b, c


def nearest_f32(a, b, c) -> np.ndarray:
    """The float32 nearest the exact a·b + c (ties to even), with IEEE's sign
    of an exact zero, from fractions.Fraction."""
    out = np.empty(a.shape, F32)
    top = Fraction(2) ** 128 - Fraction(2) ** 103  # at and above: inf
    for i, (x, y, z) in enumerate(zip(a.tolist(), b.tolist(), c.tolist())):
        exact = Fraction(x) * Fraction(y) + Fraction(z)
        if exact == 0:
            prod_neg = (np.signbit(F32(x)) != np.signbit(F32(y)))
            both_neg = (x * y == 0.0) and prod_neg and np.signbit(F32(z))
            out[i] = F32(-0.0) if both_neg else F32(0.0)
            continue
        if abs(exact) >= top:
            out[i] = F32(np.inf) if exact > 0 else F32(-np.inf)
            continue
        guess = F32(float(exact))
        best = None
        for cand in (np.nextafter(guess, F32(-np.inf)), guess, np.nextafter(guess, F32(np.inf))):
            if not np.isfinite(cand):
                continue
            gap = abs(Fraction(float(cand)) - exact)
            even = int(np.asarray(cand).view(np.uint32)) % 2 == 0
            key = (gap, not even)
            if best is None or key < best[0]:
                best = (key, cand)
        out[i] = best[1]
    return out


def _bits(x):
    return np.asarray(x, F32).view(np.uint32)


def test_fma_is_the_nearest_float_of_the_exact_value():
    a, b, c = fma_cases(400, 0)
    got = MK._fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = nearest_f32(a, b, c)
    bad = np.flatnonzero(_bits(got) != _bits(want))
    assert bad.size == 0, [(a[i], b[i], c[i], got[i], want[i]) for i in bad[:5]]
    # the cases reach what they are for
    assert (np.abs(got) < np.finfo(F32).tiny).sum() > 50
    with np.errstate(over="ignore", invalid="ignore"):
        unfused = a * b + c
    assert (_bits(got) != _bits(unfused)).sum() > 100  # where fma and a·b + c part


def test_fma_takes_numbers_and_broadcasts():
    f = torch.tensor([[1.0, 2.0, 3.0]])
    o = torch.tensor([[0.5], [0.25]])
    got = MK._fma(f, o, 1e-3)
    want = f.double() * o.double() + float(np.float32(1e-3))
    assert got.dtype == torch.float32 and got.shape == (2, 3)
    assert torch.equal(got, want.float())


def test_fma_gradient_is_that_of_a_times_b_plus_c():
    gen = torch.Generator().manual_seed(1)
    a = torch.randn(5, 1, generator=gen, requires_grad=True)
    b = torch.randn(4, generator=gen, requires_grad=True)
    c = torch.randn(5, 4, generator=gen, requires_grad=True)
    g = torch.randn(5, 4, generator=gen)
    MK._fma(a, b, c).backward(g)
    assert torch.equal(a.grad, (g * b.detach()).sum(1, keepdim=True))
    assert torch.equal(b.grad, (g * a.detach()).sum(0))
    assert torch.equal(c.grad, g)
    # a Python number in the middle, and inputs that need no gradient
    x = torch.randn(3, generator=gen, requires_grad=True)
    y = torch.randn(3, generator=gen)
    MK._fma(x, 2.0, y).sum().backward()
    assert torch.equal(x.grad, torch.full((3,), 2.0))


# ---------------------------------------------------------------------------
# the early rejections (phase1_math.cuh: p1_tri_t, p1_sph_t), formula by
# formula and on rays
# ---------------------------------------------------------------------------
def _tri_decision(no, ndd, uo, ud, vo, vd, fused):
    """The triangle test without a rejection, from its forms' values: t where
    it hits, else T_NONE (megakernel.py:_tri_t, or _p1_tri_t when fused)."""
    good = ndd.abs() >= C.MT_DET_EPS
    t = -no / torch.where(good, ndd, 1.0)
    if fused:
        u, v = MK._fma(t, ud, uo), MK._fma(t, vd, vo)
    else:
        u, v = uo + t * ud, vo + t * vd
    hit = good & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > C.T_MIN) & (t < C.T_MAX)
    return torch.where(hit, t, C.T_NONE), t


def _sqrt(x):
    """The correctly rounded float32 square root, as the kernels' sqrtf and
    PyTorch's on the card: through float64, whose rounding back to float32
    is exact for a square root.  (PyTorch's on this CPU is off by an ulp or
    more on some inputs.)"""
    return torch.from_numpy(np.sqrt(x.numpy().astype(np.float64)).astype(F32))


def _roots(b, c, fused):
    """The sphere test without a rejection, from b and c: the nearest root in
    (T_MIN, T_MAX), else T_NONE (megakernel.py:_sph_t, or _p1_sph_t when
    fused)."""
    disc = MK._fma(b, b, -c) if fused else b * b - c
    has = disc > 0.0
    sq = _sqrt(torch.where(has, disc, 1.0))
    t0, t1 = -b - sq, -b + sq
    return torch.where(has & (t0 > C.T_MIN) & (t0 < C.T_MAX), t0,
                       torch.where(has & (t1 > C.T_MIN) & (t1 < C.T_MAX), t1, C.T_NONE)), has


def _signed(rng, n, lo, hi):
    """n float32 of random sign and magnitude 10^[lo, hi); inf above the
    float32 range."""
    with np.errstate(over="ignore"):
        return (np.where(rng.random(n) < 0.5, -1.0, 1.0)
                * 10.0 ** rng.uniform(lo, hi, n)).astype(F32)


@pytest.mark.parametrize("fused", [False, True])
def test_triangle_rejections_keep_every_bit_of_the_formula(fused):
    rng = np.random.default_rng(3)
    n = 200_000
    no = _signed(rng, n, -45, 3)
    ndd = _signed(rng, n, -12, 1)   # grazing: |n·d| around MT_DET_EPS
    # products that underflow to zero, zeros, NaN
    no[:1000] = _signed(rng, 1000, -44, -38)
    ndd[:1000] = _signed(rng, 1000, -9, -7)
    no[1000:1100], ndd[1100:1200] = 0.0, 0.0
    no[1200:1210], ndd[1210:1220] = np.nan, np.nan
    rest = [torch.from_numpy(rng.uniform(-2, 2, n).astype(F32)) for _ in range(4)]
    no_t, ndd_t = torch.from_numpy(no), torch.from_numpy(ndd)
    assert int(((no_t * ndd_t) == 0).sum()) > 500  # underflow and zeros reached
    t_old, t = _tri_decision(no_t, ndd_t, *rest, fused)
    sign_reject = ~(no_t * ndd_t < 0.0) | ~(ndd_t.abs() >= C.MT_DET_EPS)
    assert torch.equal(t_old[sign_reject], torch.full_like(t_old[sign_reject], C.T_NONE))
    assert int(sign_reject.sum()) > n // 3 and int((~sign_reject & (t_old < C.T_NONE)).sum()) > 0
    # beyond tmax: the caller's t < tmax sees the same with and without
    tmax = torch.from_numpy(rng.uniform(0, 3, n).astype(F32))
    range_reject = ~((t > C.T_MIN) & (t < C.T_MAX) & (t < tmax))
    kernel = torch.where(sign_reject | range_reject, C.T_NONE, t_old)
    assert torch.equal(kernel < tmax, t_old < tmax)
    assert torch.equal(kernel[kernel < C.T_NONE], t_old[kernel < C.T_NONE])


@pytest.mark.parametrize("fused", [False, True])
def test_sphere_rejection_keeps_every_bit_of_the_formula(fused):
    rng = np.random.default_rng(4)
    n = 200_000
    b = torch.from_numpy(_signed(rng, n, -25, 21))   # b·b under- and overflows at the ends
    c = torch.from_numpy(_signed(rng, n, -45, 40))
    near = torch.from_numpy(rng.uniform(0.999, 1.001, n).astype(F32))
    c[: n // 4] = (b[: n // 4] * b[: n // 4]) * near[: n // 4]   # grazing: disc near 0
    t_old, has = _roots(b, c, fused)
    reject = (b > 0.0) & (c > 0.0)
    assert int((reject & has).sum()) > n // 10
    assert torch.equal(t_old[reject], torch.full_like(t_old[reject], C.T_NONE))
    assert int((~reject & (t_old < C.T_NONE)).sum()) > 0


def _rays(packed, n, seed):
    """Origins and unit directions: random ones, origins on the scene's
    surfaces leaving them (as shadow and reflection rays do), directions
    grazing the floor's plane and tangent to the spheres, and rays that
    point away from every primitive."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (n, 3))
    d = rng.standard_normal((n, 3))
    k = n // 4
    o[:k, 1] = rng.choice([0.0, 1e-3, -1e-3, 1e-7], k)           # on or near the floor
    d[k:2 * k, 1] = rng.choice([0.0, 1e-9, -1e-9, 1e-6], k)      # grazing the floor
    sph = packed.sph_forms[:, 1, :3].numpy().astype(np.float64)
    r2 = (sph * sph).sum(1) - packed.sph_forms[:, 0, 3].numpy()
    which = rng.integers(0, len(sph), k)
    axis = d[2 * k:3 * k] / np.linalg.norm(d[2 * k:3 * k], axis=1, keepdims=True)
    side = np.cross(axis, rng.standard_normal((k, 3)))
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    o[2 * k:3 * k] = sph[which] + side * np.sqrt(r2[which])[:, None] - 3.0 * axis
    d[2 * k:3 * k] = axis                                         # tangent to a sphere
    d[3 * k:] = o[3 * k:] - np.array([0.0, -50.0, 0.0])             # away from the scene
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (tuple(torch.from_numpy(o[:, i].astype(F32)) for i in range(3)),
            tuple(torch.from_numpy(d[:, i].astype(F32)) for i in range(3)))


def test_rejections_on_rays_of_config_3():
    scene, _ = configs.config3_spheres(8, 8, device="cpu")
    packed = pack_scene(scene)
    o, d = _rays(packed, 40_000, 5)
    # triangles: the sign rejection never drops a hit of either formula
    tf = packed.tri_forms
    no, ndd = MK._p1_form_o(tf[:, 0], o), MK._p1_form_d(tf[:, 0], d)
    sign_reject = ~(no * ndd < 0.0) | ~(ndd.abs() >= C.MT_DET_EPS)
    t_tri, _, _ = MK._p1_tri_t(packed, o, d)
    assert bool((t_tri[sign_reject] == C.T_NONE).all())
    no_u, ndd_u = MK._form_o(tf[:, 0], o), MK._form_d(tf[:, 0], d)
    t_plain, _, _ = MK._tri_t(packed, o, d)
    assert bool((t_plain[~(no_u * ndd_u < 0.0) | ~(ndd_u.abs() >= C.MT_DET_EPS)]
                 == C.T_NONE).all())
    assert 0 < int(sign_reject.sum()) < sign_reject.numel()
    # spheres: b > 0 and c > 0 leave no root in range
    sf = packed.sph_forms
    cols = tuple(x[:, None] for x in o), tuple(x[:, None] for x in d)
    b, c = MK._p1_sph_terms(sf[:, 0], sf[:, 1], *cols, MK._p1_dot(o, o)[:, None],
                            MK._p1_dot(o, d)[:, None])
    t_sph, _ = _roots(b, c, fused=True)
    reject = (b > 0.0) & (c > 0.0)
    assert bool((t_sph[reject] == C.T_NONE).all())
    assert 0 < int(reject.sum()) < reject.numel()
    # the kernel's loops on these values: closest hit with the best so far
    # as each test's tmax, and any-hit with the spheres first, each with its
    # early exits, against the plain versions' minimum and any()
    tmax = torch.from_numpy(np.random.default_rng(6).uniform(0, 8, o[0].numel()).astype(F32))
    best = torch.full_like(tmax, C.T_NONE)
    for t in (*t_tri.unbind(1), *t_sph.unbind(1)):
        best = torch.where(t < best, t, best)
    assert torch.equal(best, torch.minimum(t_tri.min(1).values, t_sph.min(1).values))
    blocked = torch.zeros_like(tmax, dtype=torch.bool)
    for t in (*t_sph.unbind(1), *t_tri.unbind(1)):
        blocked = blocked | (~blocked & (t < tmax))
    assert torch.equal(blocked, ((t_tri < tmax[:, None]).any(1)
                                 | (t_sph < tmax[:, None]).any(1)))


def _sphere_rays(case, n_rays):
    """A sphere seen from the book's camera (configs.rtiow_final_spheres) and
    rays from the eye that hit it: ("small") one of radius 0.2 eleven units
    from the origin, up to 0.95 of its radius off its centre; ("ground") the
    ground of radius 1000, out to 60 units from the eye, near its horizon."""
    eye = np.array([13.0, 2.0, 3.0])
    rng = np.random.default_rng(9)
    if case == "small":
        c, r = np.array([-8.5, 0.2, -6.3]), 0.2
        axis = (c - eye) / np.linalg.norm(c - eye)
        side = np.cross(axis, rng.standard_normal((n_rays, 3)))
        side /= np.linalg.norm(side, axis=1, keepdims=True)
        aim = c + side * r * np.sqrt(rng.uniform(0.0, 0.95, (n_rays, 1)))
    else:
        c, r = np.array([0.0, -1000.0, 0.0]), 1000.0
        ang = rng.uniform(0.0, 2.0 * np.pi, n_rays)
        dist = rng.uniform(1.0, 60.0, n_rays)
        x, z = eye[0] + dist * np.cos(ang), eye[2] + dist * np.sin(ang)
        aim = np.stack([x, c[1] + np.sqrt(r * r - x * x - z * z), z], 1)   # on the ground
    d = aim - eye
    return eye, c, r, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(F32)


@pytest.mark.parametrize("case,other", [("small", "forms"), ("ground", "local")])
def test_a_winning_spheres_root_is_the_better_rounded_one(case, other):
    """The winner's t (_closest) and its adjoint (_SphereRoot) take b and
    disc from _p1_sph_quadratic, which picks the better rounded of the forms
    (c = o.o + fc(o), whose summands are |o|^2 and |2 c.o|) and o - c (l.l,
    good to a few ulps of r (r + 4 |oc|)).  Against float64 on the same
    float32 inputs, ray by ray: t within a few ulps of its size, and dt/dc =
    n/(n.d), dt/dr = r/(n.d) (n = p - c, chained from the forms' cotangents
    as pack_scene chains them) within 1e-4, where the other way is off by
    more: a sphere of radius 0.2 eleven units out loses ~1e-3 of its root and
    a few % of its derivatives in the forms; the ground, whose c.c - r^2 is
    exactly 0, as much in l.l."""
    from tpurt_torch.scene.scene import Camera, build_scene

    n_rays = 4000
    eye, c, r, d32 = _sphere_rays(case, n_rays)
    scene = build_scene(spheres=[(tuple(c), r, 0)], camera=Camera.make(eye, c, device="cpu"),
                        device="cpu")
    packed = pack_scene(scene)
    o = tuple(torch.full((n_rays,), float(F32(x))) for x in eye)
    d = tuple(torch.from_numpy(d32[:, k].copy()) for k in range(3))
    # float64 on the float32 inputs
    dd, c64, r64 = d32.astype(np.float64), F32(c).astype(np.float64), float(F32(r))
    oc = eye - c64
    b64 = dd @ oc
    t64 = -b64 - np.sqrt(r64 * r64 - ((oc - b64[:, None] * dd) ** 2).sum(1))
    n = oc + t64[:, None] * dd
    ndd = (n * dd).sum(1)

    t, _, _, idx = MK._closest(packed, o, d)
    assert bool((idx == packed.n_tris).all())
    assert np.abs(t.double().numpy() - t64).max() < 4e-6 * np.abs(t64).max()

    def adjoint_gap(b, disc):
        """The largest relative gap, over the rays, of dt/dc and dt/dr from
        _SphereRoot's cotangents of the forms (chained as pack_scene's)."""
        fc, fd = (packed.sph_forms[0, k].expand(n_rays, 4).clone().requires_grad_(True)
                  for k in range(2))
        MK._SphereRoot.apply(fc, fd, *o, *d, b, disc, torch.ones(n_rays, dtype=torch.bool)) \
            .sum().backward()
        gc, gd = fc.grad.double().numpy(), fd.grad.double().numpy()
        dc = -2.0 * gc[:, :3] + 2.0 * c64 * gc[:, 3:] + gd[:, :3]
        dr = -2.0 * r64 * gc[:, 3]
        want_c, want_r = n / ndd[:, None], r64 / ndd
        return max((np.abs(dc - want_c).max(1) / np.abs(want_c).max(1)).max(),
                   (np.abs(dr - want_r) / np.abs(want_r)).max())

    with torch.no_grad():
        fc, fd = packed.sph_forms[torch.zeros(n_rays, dtype=torch.long)].unbind(1)
        a = packed.attrs[torch.full((n_rays,), packed.n_tris)]
        picked = MK._p1_sph_quadratic(fc, fd, a, o, d)
        bf, cterm = MK._p1_sph_terms(fc, fd, o, d, MK._p1_dot(o, o), MK._p1_dot(o, d))
        oc32 = MK._sub(o, tuple(a[:, PK.A_CENTER + k] for k in range(3)))
        bl = MK._p1_dot(oc32, d)
        ll = MK._p1_axpy(oc32, d, -bl)
        ways = {"forms": (bf, MK._fma(bf, bf, -cterm)),
                "local": (bl, MK._fma(a[:, PK.A_RADIUS], a[:, PK.A_RADIUS], -MK._p1_dot(ll, ll)))}
    assert adjoint_gap(*picked) < 1e-4
    assert adjoint_gap(*ways[other]) > 1e-3
