"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Each test skips where PyTorch sees no card.  The card's machine has no JAX,
so run this file there without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import dataclasses
import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpurt_torch
from tpurt_torch.dist import (heartbeat, render_and_grad_sharded, render_resumable,
                              render_sharded, spawn_ranks)
from tpurt_torch.dist import shard as SH
from tpurt_torch.dist import scene_shard as SSH
from tpurt_torch.dist.train import make_train_step, render_and_grad_scene_sharded
from tpurt_torch.kernels import build
from tpurt_torch.kernels import megabwd as MB
from tpurt_torch.kernels import megakernel as MK
from tpurt_torch.kernels import pack as PK
from tpurt_torch.kernels import probes as PR
from tpurt_torch.kernels import segsum as SS
from tpurt_torch.kernels import shade as SH
from tpurt_torch.kernels import traversal as TV
from tpurt_torch.kernels.pack import pack_scene
from tpurt_torch.kernels.packc import pack_clusters
from tpurt_torch.core.types import RenderConfig
from tpurt_torch.core import geom
from tpurt_torch.render import RenderPlan, cap_depth
from tpurt_torch.scene import configs, meshes
from tpurt_torch.scene.scene import Camera, build_scene
from tpurt_torch.shading import deferred as TD
from tpurt_torch.utils import load_png, save_png
from tpurt_torch.tools.probe_segsum import ABT_CASES, ZERO_CASES, sum_gap, synthetic_stream
from test_torch_phase1_math import fma_cases
import torch_one_thread  # noqa: F401  (one PyTorch thread)

pytestmark = pytest.mark.cuda

ATOL = 2e-4  # the port's colour bar (tests/test_kernels.py)
GRAD_RTOL = 2e-3  # of max|g| of each cotangent table (tests/test_kernels.py)

SIZES = [
    (1, 24, 24, 0, 24),
    (2, 24, 24, 0, 24),
    (3, 24, 24, 0, 24),
    (3, 40, 56, 0, 40),
    (3, 40, 56, 13, 9),   # a slab of rows: the pixel offset
    (3, 33, 47, 0, 33),   # n_pix not a multiple of the block size
    ("rtiow", 24, 36, 0, 24),   # 487 spheres and a pad triangle: the records route
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize("k,h,w,row0,nrows", SIZES)
def test_kernel_matches_plain_version(cuda, k, h, w, row0, nrows):
    scene, cfg = configs.ALL_CONFIGS[k](h, w, device=cuda)
    packed = pack_scene(scene)
    n_pix = nrows * w
    col_k, occ_k = MK.megakernel_fwd_cuda(packed, cfg, row0 * w, n_pix)
    col_r, occ_r = MK.tile_color_reference(packed, cfg, row0 * w, n_pix)
    torch.cuda.synchronize()
    assert col_k.shape == (3, n_pix) and occ_k.shape == (cfg.max_depth + 1, n_pix)
    torch.testing.assert_close(col_k, col_r, atol=ATOL, rtol=0)
    assert torch.equal(occ_k, occ_r)


def _helper(op, a, b, c=None):
    """Op `op` of the kernels' phase1_helpers on rows a, b (n, 4) and c (n,)."""
    a, b = (x.contiguous().cuda() for x in (a, b))
    c = torch.zeros(a.shape[0], device=a.device) if c is None else c
    c = c.contiguous().cuda()
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        build.check(build.load().tpurt_phase1_helpers(op, a.data_ptr(), b.data_ptr(),
                                                      c.data_ptr(), out.data_ptr(),
                                                      a.shape[0], stream), "phase1_helpers")
    torch.cuda.synchronize()
    return out.cpu()


def _pad4(*cols):
    return torch.stack([*cols] + [torch.zeros_like(cols[0])] * (4 - len(cols)), 1)


def test_fma_helpers_of_the_kernel_equal_the_plain_versions(cuda):
    a, b, c = (torch.from_numpy(x) for x in fma_cases(2000, 7))
    # one fma, as __fmaf_rn: the plain version's exact _fma, bit for bit
    got = _helper(0, _pad4(a), _pad4(b), c)[:, 0]
    want = MK._fma(a, b, c)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the helpers built from it, on rows of moderate values; the plain
    # versions on the card, whose rsqrt is the kernel's
    gen = torch.Generator().manual_seed(8)
    f = (torch.randn(4096, 4, generator=gen)
         * 10.0 ** torch.randint(-3, 4, (4096, 4), generator=gen)).cuda()
    o = (torch.randn(4096, 4, generator=gen) * 4.0).cuda()
    rows = tuple(o[:, k] for k in range(3))
    checks = {1: MK._p1_row_o(f, rows),
              2: MK._p1_dot(tuple(f[:, k] for k in range(3)), rows),
              3: torch.stack(MK._p1_normalize(tuple(f[:, k] for k in range(3))), 1),
              5: torch.stack(MK._p1_reflect(tuple(f[:, k] for k in range(3)),
                                            MK._p1_normalize(rows)), 1)}
    for op, want in checks.items():
        b_rows = o if op != 5 else _pad4(*MK._p1_normalize(rows))
        got = _helper(op, f, b_rows)
        got = got[:, 0] if want.dim() == 1 else got[:, :3]
        assert torch.equal(got, want.cpu()), (op, float((got - want.cpu()).abs().max()))


def test_specular_power_of_the_kernel_equals_the_plain_version_on_the_card(cuda):
    # p1_pow = exp2f(y log2f(x)) against torch.exp2(y torch.log2(x)) computed
    # on the card, over the specular term's range: x in (0, 1], y the
    # shininess
    gen = torch.Generator().manual_seed(9)
    x = torch.rand(1 << 16, generator=gen).clamp_min(1e-30)
    x[:64] = torch.tensor([1.0, 0.5, 1e-38, 1e-45] * 16)
    y = torch.rand(1 << 16, generator=gen) * 200.0
    got = _helper(4, _pad4(x), _pad4(y))[:, 0]
    want = MK._p1_pow(x.cuda(), y.cuda()).cpu()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_render_goes_through_the_kernel(cuda):
    scene, cfg = configs.config3_spheres(24, 24, device=cuda)
    MK.reset_launches()
    img = tpurt_torch.render(scene, cfg)
    torch.cuda.synchronize()
    assert {k: n for k, n in MK.launches.items() if n} == {"megakernel_fwd": 1}
    cpu_scene, _ = configs.config3_spheres(24, 24, device="cpu")
    torch.testing.assert_close(img.cpu(), tpurt_torch.render(cpu_scene, cfg),
                               atol=ATOL, rtol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    scene, cfg = configs.config3_spheres(8, 8, device=cuda)
    packed = pack_scene(scene)
    packed.attrs = packed.attrs.double()
    with pytest.raises(ValueError, match="attrs"):
        MK.megakernel_fwd_cuda(packed, cfg, 0, 64)
    packed = pack_scene(scene)
    packed.tri_forms = packed.tri_forms.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        MK.megakernel_fwd_cuda(packed, cfg, 0, 64)


def _scene(k, h, w, device):
    build = configs.smooth_box if k == "smooth" else configs.ALL_CONFIGS[k]
    return build(h, w, device=device)


def _rand(shape, seed, device):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.rand(shape, generator=gen).to(device)


def _assert_tables_close(got, want):
    for name in ("globals", "tri_forms", "sph_forms", "attrs"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        bar = GRAD_RTOL * float(b.abs().max()) + 1e-12
        assert float((a - b).abs().max()) <= bar, (name, float((a - b).abs().max()), bar)


@pytest.mark.parametrize("k,h,w,row0,nrows", SIZES + [("smooth", 32, 40, 0, 32)])
def test_backward_kernel_matches_plain_version(cuda, k, h, w, row0, nrows):
    scene, cfg = _scene(k, h, w, cuda)
    packed = pack_scene(scene)
    off, n_pix = row0 * w, nrows * w
    _, occ = MK.megakernel_fwd_cuda(packed, cfg, off, n_pix)
    g = _rand((3, n_pix), 1, cuda) - 0.5
    got = MK.megakernel_bwd_cuda(packed, cfg, off, n_pix, occ, g)
    want = MK.tile_color_vjp_reference(packed, cfg, off, n_pix, occ, g)
    torch.cuda.synchronize()
    _assert_tables_close(got, want)


@pytest.mark.parametrize("which", ["fused", "hand"])
@pytest.mark.parametrize("k,h,w,row0,nrows", SIZES + [("smooth", 32, 40, 0, 32)])
def test_l2_kernels_match_plain_version(cuda, which, k, h, w, row0, nrows):
    scene, cfg = _scene(k, h, w, cuda)
    packed = pack_scene(scene)
    off, n_pix = row0 * w, nrows * w
    target = _rand((3, n_pix), 2, cuda)
    kernel, plain = {"fused": (MK.l2_fused_cuda, MK.l2_fused_reference),
                     "hand": (MB.hand_l2_cuda, MB.hand_l2_reference)}[which]
    sq_k, got = kernel(packed, cfg, off, n_pix, target)
    sq_r, want = plain(packed, cfg, off, n_pix, target)
    torch.cuda.synchronize()
    assert sq_k.shape == (n_pix,)
    torch.testing.assert_close(sq_k.sum(), sq_r.sum(), rtol=1e-5, atol=0)
    _assert_tables_close(got, want)


def test_tables_beyond_shared_memory_take_the_records_route(cuda, monkeypatch):
    scene, cfg = configs.config3_spheres(24, 24, device=cuda)
    packed = pack_scene(scene)
    target = _rand((3, 576), 3, cuda)
    limits = MK._shared_limits(cuda.index or 0)
    assert MK.takes_fixed_order(MK.table_floats(packed), cfg.max_depth + 1, *limits)
    _, fixed = MB.hand_l2_cuda(packed, cfg, 0, 576, target)
    _, want = MB.hand_l2_reference(packed, cfg, 0, 576, target)
    monkeypatch.setattr(MK, "takes_fixed_order", lambda *args: False)
    SS.reset_launches()
    _, got = MB.hand_l2_cuda(packed, cfg, 0, 576, target)
    _, again = MB.hand_l2_cuda(packed, cfg, 0, 576, target)
    torch.cuda.synchronize()
    assert SS.launches["sorted_segsum"] == 2       # the records summed by K8
    _assert_tables_close(got, want)
    _assert_tables_close(got, fixed)
    _assert_same_bits((None, got), (None, again))


@pytest.mark.parametrize("which", ["bwd", "fused", "hand"])
def test_records_route_in_slabs_of_rows(cuda, which, monkeypatch):
    scene, cfg = configs.config3_spheres(40, 56, device=cuda)
    packed = pack_scene(scene)
    monkeypatch.setattr(MK, "takes_fixed_order", lambda *args: False)
    whole = _backward(which, packed, cfg, 0, 40 * 56)
    # 3 depths a row: the records of 7 rows a slab, the last slab 5 rows
    monkeypatch.setattr(MK, "RECORD_SCRATCH_LIMIT", MK.records_bytes(7 * 56, 3))
    assert MK.slab_pixels(40 * 56, 56, 3) == 7 * 56
    slabs = _backward(which, packed, cfg, 0, 40 * 56)
    again = _backward(which, packed, cfg, 0, 40 * 56)
    want = _backward(which, packed, cfg, 0, 40 * 56, reference=True)
    torch.cuda.synchronize()
    _assert_tables_close(slabs[1], want[1])
    _assert_tables_close(whole[1], want[1])
    _assert_same_bits(slabs, again)
    assert slabs[0] is None or torch.equal(slabs[0], whole[0])    # the same squares


def _map_reference(keys, vals, packed):
    """index_add_ of each record's 32 values into the four packed cotangent
    tensors, slot by slot as the kernel's winner_addr names them, flattened
    in the table's order [globals | tri_forms | sph_forms | attrs]."""
    T, S = packed.n_tris, packed.n_spheres
    tri = torch.zeros((T, 12), dtype=torch.float64)
    sph = torch.zeros((S, 8), dtype=torch.float64)
    attrs = torch.zeros((T + S, PK.ACOLS), dtype=torch.float64)
    for key, v in zip(keys.tolist(), vals.double()):
        if key >= T + S:
            continue
        attrs[key, PK.A_KA:PK.A_REFL + 1] += v[:11]           # ka kd ks shin refl
        if key < T:
            attrs[key, PK.A_N0:PK.A_N2 + 3] += v[11:20]       # three vertex normals
            tri[key] += v[20:32]                              # the three form rows
        else:
            attrs[key, PK.A_CENTER:PK.A_CENTER + 3] += v[11:14]
            sph[key - T] += v[20:28]                          # the two form rows
    glob = torch.zeros(packed.globals.numel(), dtype=torch.float64)
    return torch.cat([glob, tri.reshape(-1), sph.reshape(-1), attrs.reshape(-1)])


@pytest.mark.parametrize("name", [1, 2, 3, "smooth"])
def test_record_sums_land_at_their_table_addresses(cuda, name):
    make = configs.smooth_box if name == "smooth" else configs.ALL_CONFIGS[name]
    scene, _ = make(8, 8, device=cuda)
    packed = pack_scene(scene)
    T, S, L = packed.n_tris, packed.n_spheres, packed.n_lights
    n = MK.table_floats(packed)
    src, dst = MK.record_map(T, S, L, cuda)
    # every address at most once, and only past the globals
    assert dst.unique().numel() == dst.numel() and int(dst.min()) >= packed.globals.numel()
    assert int(dst.max()) < n and dst.numel() == 32 * T + 22 * S
    rng = np.random.default_rng(len(str(name)) + n)
    m = 3000
    keys = torch.from_numpy(rng.integers(0, T + S + 1, m).astype(np.int32))  # T + S: no record
    vals = torch.from_numpy(rng.standard_normal((m, MK.RECORD_FLOATS)).astype(np.float32))
    got = MK.records_into(torch.zeros(n, device=cuda), keys.to(cuda), vals.to(cuda), T, S, L)
    want = _map_reference(keys, vals, packed)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert not got[:packed.globals.numel()].any()


_L2_KERNELS = {
    "fused": (MK.l2_fused_cuda, MK.l2_fused_reference),
    "hand": (MB.hand_l2_cuda, MB.hand_l2_reference),
}


def _backward(which, packed, cfg, off, n_pix, reference=False):
    """(sq or None, cotangents) of one backward kernel, or of its plain version."""
    if which == "bwd":
        _, occ = MK.megakernel_fwd_cuda(packed, cfg, off, n_pix)
        g = _rand((3, n_pix), 1, packed.globals.device) - 0.5
        fn = MK.tile_color_vjp_reference if reference else MK.megakernel_bwd_cuda
        return None, fn(packed, cfg, off, n_pix, occ, g)
    target = _rand((3, n_pix), 2, packed.globals.device)
    return _L2_KERNELS[which][int(reference)](packed, cfg, off, n_pix, target)


def _assert_same_bits(a, b):
    (sq_a, got_a), (sq_b, got_b) = a, b
    assert sq_a is None or torch.equal(sq_a, sq_b)
    for name in ("globals", "tri_forms", "sph_forms", "attrs"):
        assert torch.equal(getattr(got_a, name), getattr(got_b, name)), name


@pytest.mark.parametrize("which", ["bwd", "fused", "hand"])
@pytest.mark.parametrize("k,h,w,row0,nrows", SIZES + [("smooth", 32, 40, 0, 32)])
def test_backward_kernels_repeat_bit_for_bit(cuda, which, k, h, w, row0, nrows):
    scene, cfg = _scene(k, h, w, cuda)
    packed = pack_scene(scene)
    off, n_pix = row0 * w, nrows * w
    first = _backward(which, packed, cfg, off, n_pix)
    again = _backward(which, packed, cfg, off, n_pix)
    torch.cuda.synchronize()
    _assert_same_bits(first, again)


def _spheres_and_box(n_spheres, device):
    """The smooth box with n_spheres more small spheres on a grid in front of
    it, at 24x32 and depth 2: a table of 634 + 43 n_spheres floats."""
    verts, tris = meshes.box((-1, -1, -1), (1, 1, 1))
    small = [((-1.2 + 0.5 * (i % 8), -0.6 + 0.5 * (i // 8), 1.6), 0.15, i % 2)
             for i in range(n_spheres)]
    scene = build_scene(
        vertices=verts, triangles=tris, spheres=[((1.6, 0.2, 0.3), 0.6, 1)] + small,
        materials=[
            {"ka": 0.1, "kd": (0.7, 0.6, 0.5), "ks": 0.4, "shininess": 20.0,
             "reflectivity": 0.3},
            {"ka": 0.05, "kd": (0.2, 0.3, 0.7), "ks": 0.6, "reflectivity": 0.4},
        ],
        lights=[((3.0, 4.0, 5.0), (1.0, 1.0, 1.0)), ((-4.0, 2.0, 3.0), (0.4, 0.4, 0.5))],
        camera=Camera.make((2.5, 2.0, 4.0), (0.3, 0.0, 0.0), device=device),
        smooth=True, device=device)
    return scene, RenderConfig(width=32, height=24, max_depth=2, shadows=True)


@pytest.mark.parametrize("which", ["bwd", "fused", "hand"])
@pytest.mark.parametrize("above", [False, True])
def test_largest_fixed_order_table_and_one_above(cuda, which, above):
    limits = MK._shared_limits(cuda.index or 0)
    largest = MK.fixed_order_limit(3, *limits)
    n_spheres = (largest - 634) // 43 + int(above)
    scene, cfg = _spheres_and_box(n_spheres, cuda)
    packed = pack_scene(scene)
    n = MK.table_floats(packed)
    assert n == 634 + 43 * n_spheres and (n > largest) == above and n + 43 > largest
    assert MK.takes_fixed_order(n, cfg.max_depth + 1, *limits) == (not above)
    n_pix = cfg.height * cfg.width
    got = _backward(which, packed, cfg, 0, n_pix)
    again = _backward(which, packed, cfg, 0, n_pix)
    want = _backward(which, packed, cfg, 0, n_pix, reference=True)
    torch.cuda.synchronize()
    _assert_tables_close(got[1], want[1])
    _assert_same_bits(got, again)       # both routes: a fixed order


def test_shared_memory_rule_matches_the_kernels(cuda):
    lib = build.load()
    for n, depths, fixed in ((111, 1, True), (250, 3, True), (1662, 1, True),
                             (368_640, 16, False), (0, 16, False)):
        assert lib.tpurt_phase1_shared_bytes(n, depths, int(fixed)) == \
            MK.phase1_shared_bytes(n, depths, fixed)
    index = cuda.index or 0
    per_sm, per_block, reserved = MK._shared_limits(index)
    assert per_block <= per_sm and reserved >= 0
    # config 3's table keeps the blocks the kernels ask for, one wave of them
    for kernel in ("megakernel_bwd", "l2_fused", "l2_hand"):
        assert MK._blocks_per_sm(kernel, index, 250, 3, False) >= MK.MIN_BLOCKS


def test_render_and_grad_launches_forward_and_backward(cuda):
    scene, cfg = configs.config3_spheres(24, 24, device=cuda)
    target = _rand((24, 24, 3), 4, cuda)
    MK.reset_launches()
    (loss, img), grads = tpurt_torch.render_and_grad(
        scene, lambda im: (im - target).abs().sum(), cfg)
    torch.cuda.synchronize()
    assert {k: n for k, n in MK.launches.items() if n} == {
        "megakernel_fwd": 1, "megakernel_bwd": 1}
    assert torch.isfinite(grads.sph_center).all() and grads.sph_center.abs().max() > 0
    assert grads.triangles is None


def test_train_step_goes_through_the_hand_kernel(cuda):
    scene, cfg = configs.config3_spheres(24, 24, device=cuda)
    moved, _ = configs.config3_spheres(24, 24, device=cuda)
    moved.sph_center = moved.sph_center + torch.tensor([0.05, 0.0, -0.03], device=cuda)
    target = tpurt_torch.render(moved, cfg)
    step = make_train_step(cfg)
    MK.reset_launches()
    losses = []
    for _ in range(3):
        scene, loss = step(scene, target, 0.05)
        losses.append(float(loss))
    assert {k: n for k, n in MK.launches.items() if n} == {"l2_hand": 3}
    assert losses[-1] < losses[0]
    MK.reset_launches()
    MK.l2_loss_and_grad(scene, target, cfg, hand=False)
    assert {k: n for k, n in MK.launches.items() if n} == {"l2_fused": 1}


def test_backward_wrappers_reject_what_the_kernels_do_not_take(cuda):
    scene, cfg = configs.config3_spheres(8, 8, device=cuda)
    packed = pack_scene(scene)
    _, occ = MK.megakernel_fwd_cuda(packed, cfg, 0, 64)
    g = torch.zeros((3, 64), device=cuda)
    with pytest.raises(ValueError, match="g:"):
        MK.megakernel_bwd_cuda(packed, cfg, 0, 64, occ, g.double())
    with pytest.raises(ValueError, match="occ:"):
        MK.megakernel_bwd_cuda(packed, cfg, 0, 64, occ[:2], g)
    with pytest.raises(ValueError, match="target"):
        MB.hand_l2_cuda(packed, cfg, 0, 64, g.t().contiguous().t())
    with pytest.raises(ValueError, match="target:"):
        MK.l2_fused_cuda(packed, cfg, 0, 64, g.cpu())
    deep = cfg.replace(max_depth=MK.MAX_DEPTHS)
    with pytest.raises(ValueError, match="max_depth"):
        MB.hand_l2_cuda(packed, deep, 0, 64, g)
    cpu_packed = pack_scene(configs.config3_spheres(8, 8, device="cpu")[0])
    with pytest.raises(ValueError, match="card"):
        MB.hand_l2_cuda(cpu_packed, cfg, 0, 64, g)


# ---------------------------------------------------------------------------
# the traversal kernel (csrc/traversal.cu) against its plain versions
# ---------------------------------------------------------------------------
CLUSTERED = [
    ("spheres", 32, 32),    # config 3: one cluster, resident spheres, depth 2
    ("spheres", 33, 47),    # n_pix not a multiple of the block size
    ("mesh", 32, 32),       # config 4 at subdiv 3: 11 clusters
    ("textured", 24, 32),   # config 5, 2 blobs at subdiv 3: 21 clusters
    ("mirror", 24, 32),     # the same with a reflective blob: depth 1 is live
    ("padded", 24, 32),     # config 4 at subdiv 2: a cluster of 66 triangles and 62 pads
]


def _clustered(name, h, w, device):
    """(scene, cfg, packed) of a small clustered scene."""
    if name == "spheres":
        scene, cfg = configs.config3_spheres(h, w, device=device)
    elif name in ("mesh", "padded"):
        scene, cfg = configs.config4_bunny(h, w, subdiv=3 if name == "mesh" else 2,
                                           device=device)
    else:
        scene, cfg = configs.config5_multimesh(h, w, n_blobs=2, subdiv=3, device=device)
        if name == "mirror":
            scene.materials.reflectivity[1] = 0.25
    plan = tpurt_torch.prepare(scene, cfg, accel="bvh")
    assert plan.kind == "clusters"
    return scene, cfg, plan, pack_clusters(scene, plan.tri_ids, plan.tree)


def _assert_records_equal(got, want):
    for name, a, b in zip(("ids", "occ", "tbest"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.equal(a, b), (name, int((a != b).sum()))


@pytest.mark.parametrize("name,h,w", CLUSTERED)
def test_trace_records_matches_plain_version(cuda, name, h, w):
    _, cfg, _, packed = _clustered(name, h, w, cuda)
    got = TV.trace_records_cuda(packed, cfg, 0, h)
    want = TV.trace_records_reference(packed, cfg, 0, h)
    torch.cuda.synchronize()
    assert got[0].shape == (cfg.max_depth + 1, h * w)
    _assert_records_equal(got[:3], want[:3])
    assert int((got[0][0] >= 0).sum()) > 0


def test_trace_records_slab_of_rows(cuda):
    _, cfg, _, packed = _clustered("mesh", 40, 56, cuda)
    whole = TV.trace_records_cuda(packed, cfg, 0, 40)
    slab = TV.trace_records_cuda(packed, cfg, 13, 9)
    _assert_records_equal(slab[:3], [x[:, 13 * 56:22 * 56] for x in whole[:3]])


@pytest.mark.parametrize("name", ["spheres", "mesh", "textured"])
def test_trace_bounce_matches_plain_version(cuda, name):
    scene, cfg, _, packed = _clustered(name, 8, 8, cuda)
    gen = torch.Generator(device="cpu").manual_seed(5)
    n = 1500
    lo, hi = packed.aabb_lo.amin(0).cpu(), packed.aabb_hi.amax(0).cpu()
    lo, hi = lo.clamp_min(-4.0), hi.clamp_max(4.0)
    o = (lo + (hi - lo) * torch.rand((n, 3), generator=gen) + torch.tensor([0.0, 1.0, 0.0]))
    target = lo + (hi - lo) * torch.rand((n, 3), generator=gen)
    d = torch.nn.functional.normalize(target - o, dim=1)
    alive = torch.rand(n, generator=gen) < 0.8
    o, d, alive = o.to(cuda), d.contiguous().to(cuda), alive.to(cuda)
    for n_live in (None, 1000):
        got = TV.trace_bounce_cuda(packed, cfg, o, d, alive, n_live)
        want = TV.trace_bounce_reference(packed, cfg, o, d, alive, n_live)
        torch.cuda.synchronize()
        _assert_records_equal(got[:3], want[:3])
        assert int((got[0] >= 0).sum()) > 0
    assert int((got[0][1000:] >= 0).sum()) == 0


@pytest.mark.parametrize("name", ["spheres", "mesh", "textured"])
def test_trace_shadows_matches_plain_version(cuda, name):
    scene, cfg, _, packed = _clustered(name, 24, 32, cuda)
    ids, occ, _, _ = TV.trace_records_cuda(packed, cfg, 0, 24, max_depth=0)
    o, d = TV._camera_rays(packed, cfg, 0, 24 * 32)
    p_off, _, _, p = TV._continue_rays(packed, o, d, ids[0])
    alive = ids[0] >= 0
    got, _ = TV.trace_shadows_cuda(packed, cfg, p.contiguous(), p_off.contiguous(), alive)
    want, _ = TV.trace_shadows_reference(packed, cfg, p, p_off, alive)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int((got != 0).sum()) > 0
    # the hit points are the kernel's arithmetic in PyTorch's operations, whose
    # sqrt and division may round apart from the kernel's in the last bit, so
    # against the in-kernel shadows a shadow-edge lane may differ
    assert int((got != occ[0]).sum()) <= 2


def test_traversal_counts_and_repeatability(cuda):
    scene, cfg, plan, packed = _clustered("mesh", 32, 32, cuda)
    a = TV.trace_records_cuda(packed, cfg, 0, 32)
    _assert_records_equal(a[:3], TV.trace_records_cuda(packed, cfg, 0, 32)[:3])
    b = TV.trace_records_cuda(packed, cfg, 0, 32, count=True)
    _assert_records_equal(a[:3], b[:3])   # no atomics in the records
    assert a[3] is None
    stats = dict(zip(TV.STAT_NAMES, b[3].tolist()))
    assert stats["rays"] >= 32 * 32 and stats["tri_tests"] > 0 and stats["nodes"] > 0
    assert stats["sph_tests"] == 0        # mesh-only: the pad sphere is not resident
    # the group boxes cull: fewer than the 128 slots of every cluster entered
    assert stats["group_tests"] == 8 * stats["clusters"]
    assert stats["tri_tests"] < 128 * stats["clusters"] / 2
    again = TV.traversal_stats(scene, cfg, plan.tri_ids, tree=plan.tree)
    assert again.tolist() == b[3].tolist()


def test_traversal_stack_depth_guard(cuda):
    _, cfg, _, packed = _clustered("mesh", 8, 8, cuda)
    assert packed.stack <= TV.MAX_STACK
    packed.stack = TV.MAX_STACK + 1
    with pytest.raises(ValueError, match="stack"):
        TV.trace_records_cuda(packed, cfg, 0, 8)


def _bounce_and_shadows_equal(packed, cfg, o, d):
    """K6 and K7 over rays o, d against their plain versions, bit for bit;
    the shadow rays start at o.  Returns K6's ids."""
    alive = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    got = TV.trace_bounce_cuda(packed, cfg, o, d, alive)
    _assert_records_equal(got[:3], TV.trace_bounce_reference(packed, cfg, o, d, alive)[:3])
    occ, _ = TV.trace_shadows_cuda(packed, cfg, o, o, alive)
    assert torch.equal(occ, TV.trace_shadows_reference(packed, cfg, o, o, alive)[0])
    torch.cuda.synchronize()
    return got[0]


@pytest.mark.parametrize("name", ["mesh", "textured", "padded"])
def test_traversal_axis_parallel_rays(cuda, name):
    """inv = ±inf on two axes: rays along the axes, from points on the
    planes of group boxes' faces (a slab test of (0 - 0) · inf) and from
    inside the clusters."""
    _, cfg, _, packed = _clustered(name, 8, 8, cuda)
    gen = torch.Generator(device="cpu").manual_seed(7)
    boxes = packed.group_boxes[torch.isfinite(packed.group_boxes[:, 0, 0])].cpu()
    pick = boxes[torch.randint(0, boxes.shape[0], (1200,), generator=gen)]
    t = torch.rand((1200, 3), generator=gen)
    o = pick[:, 0, :3] + (pick[:, 1, :3] - pick[:, 0, :3]) * t
    face = torch.randint(0, 3, (1200,), generator=gen)
    side = torch.randint(0, 2, (1200,), generator=gen)
    o[torch.arange(1200), face] = pick[torch.arange(1200), side, face]
    axis = torch.randint(0, 3, (1200,), generator=gen)
    d = torch.zeros((1200, 3))
    d[torch.arange(1200), axis] = torch.where(torch.rand(1200, generator=gen) < 0.5, -1.0, 1.0)
    ids = _bounce_and_shadows_equal(packed, cfg, o.to(cuda), d.to(cuda))
    assert int((ids >= 0).sum()) > 100


@pytest.mark.parametrize("name", ["mesh", "textured", "padded"])
def test_traversal_rays_from_group_faces_and_inside_clusters(cuda, name):
    """Origins on group box faces and at triangle centroids (inside their
    cluster and group), random directions."""
    scene, cfg, _, packed = _clustered(name, 8, 8, cuda)
    gen = torch.Generator(device="cpu").manual_seed(8)
    boxes = packed.group_boxes[torch.isfinite(packed.group_boxes[:, 0, 0])].cpu()
    pick = boxes[torch.randint(0, boxes.shape[0], (1000,), generator=gen)]
    o = pick[:, 0, :3] + (pick[:, 1, :3] - pick[:, 0, :3]) * torch.rand((1000, 3), generator=gen)
    face = torch.randint(0, 3, (1000,), generator=gen)
    o[torch.arange(1000), face] = pick[torch.arange(1000), 0, face]
    tri = scene.triangles.long().cpu()[torch.randint(0, scene.n_tris, (1000,), generator=gen)]
    cent = scene.vertices.cpu()[tri].mean(1)
    o = torch.cat([o, cent])
    d = torch.nn.functional.normalize(torch.randn((2000, 3), generator=gen), dim=1)
    ids = _bounce_and_shadows_equal(packed, cfg, o.contiguous().to(cuda), d.contiguous().to(cuda))
    assert int((ids >= 0).sum()) > 500


@pytest.mark.parametrize("copies_first", [False, True])
def test_trace_records_ties_across_groups(cuda, copies_first):
    """Every triangle twice, the copy in another group of the same cluster:
    each hit is a tie at equal t, which the smaller id wins whichever group
    the kernel visits first."""
    from tpurt_torch.scene.scene import Camera, build_scene

    v, t = [], []
    for i in range(8):
        for j in range(8):
            qv, qt = meshes.quad((i, 0, j), (i, 0, j + 1), (i + 1, 0, j + 1), (i + 1, 0, j))
            t.append(qt + len(v) * 4)
            v.append(qv)
    verts, tris = np.concatenate(v) - np.float32([4, 0, 4]), np.concatenate(t)
    tris = np.concatenate([tris, tris])            # triangle k + 128 repeats k
    scene = build_scene(
        vertices=verts, triangles=tris, materials=[{"ka": 0.1, "kd": (0.5, 0.5, 0.5)}],
        lights=[((1.0, 4.0, 2.0), (1.0, 1.0, 1.0))],
        camera=Camera.make((0.0, 3.0, 5.0), (0.0, 0.0, 0.0), fov_y=np.pi / 4, device=cuda),
        device=cuda)
    cfg = RenderConfig(width=40, height=32, max_depth=0, shadows=True)
    plan = tpurt_torch.prepare(scene, cfg, accel="bvh")
    # slots sorted by id: originals fill groups 0-3 of a cluster, copies 4-7
    order = torch.argsort(plan.tri_ids.long() * (-1 if copies_first else 1), dim=1, stable=True)
    packed = pack_clusters(scene, plan.tri_ids, dataclasses.replace(plan.tree, slot_order=order))
    got = TV.trace_records_cuda(packed, cfg, 0, 32)
    _assert_records_equal(got[:3], TV.trace_records_reference(packed, cfg, 0, 32)[:3])
    hit = got[0][0] >= 0
    assert int(hit.sum()) > 500 and int((got[0][0][hit] >= 128).sum()) == 0


def test_trace_records_slab_not_a_multiple_of_the_tile(cuda):
    """Rows 5..11 of a 30 x 50 frame: 7 rows and 50 columns cut the 8 x 4
    tiles of a warp on both axes."""
    _, cfg, _, packed = _clustered("textured", 30, 50, cuda)
    got = TV.trace_records_cuda(packed, cfg, 5, 7)
    _assert_records_equal(got[:3], TV.trace_records_reference(packed, cfg, 5, 7)[:3])
    assert got[0].shape == (cfg.max_depth + 1, 7 * 50)


def test_traversal_wrappers_reject_what_the_kernel_does_not_take(cuda):
    _, cfg, _, packed = _clustered("mesh", 8, 8, cuda)
    o = torch.zeros((4, 3), device=cuda)
    alive = torch.ones(4, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="d:"):
        TV.trace_bounce_cuda(packed, cfg, o, o.double(), alive)
    with pytest.raises(ValueError, match="p_off"):
        TV.trace_shadows_cuda(packed, cfg, o, o[:, :2], alive)
    packed.boxes = packed.boxes.double()
    with pytest.raises(ValueError, match="boxes"):
        TV.trace_records_cuda(packed, cfg, 0, 8)
    _, _, _, cpu_packed = _clustered("mesh", 8, 8, "cpu")
    with pytest.raises(ValueError, match="card"):
        TV.trace_records_cuda(cpu_packed, cfg, 0, 8)


@pytest.mark.parametrize("name", ["spheres", "mesh", "mirror"])
def test_clustered_render_goes_through_the_kernel(cuda, name, monkeypatch):
    monkeypatch.setattr(TV, "SHADOW_REBIN_MIN_CLUSTERS", 0 if name == "mirror" else 2048)
    scene, cfg, plan, _ = _clustered(name, 24, 32, cuda)
    TV.reset_launches()
    img = tpurt_torch.render(scene, cfg, plan=plan)
    torch.cuda.synchronize()
    want = {"spheres": {"trace_records": 1, "trace_bounce": 2},
            "mesh": {"trace_records": 1},
            "mirror": {"trace_records": 1, "trace_bounce": 1, "trace_shadows": 2}}[name]
    assert {k: n for k, n in TV.launches.items() if n} == want
    ref = tpurt_torch.render(scene, cfg, accel="none")
    assert int(((img - ref).abs() > ATOL).any(-1).sum()) <= 2
    multi = tpurt_torch.render(scene, cfg.replace(wavefront=False), plan=plan)
    assert int(((img - multi).abs() > 1e-6).any(-1).sum()) <= 2


# ---------------------------------------------------------------------------
# deferred shading: K11 (csrc/shade.cu) against the PyTorch replay
# (shading/deferred.py:_shade_bundle), its plain version
# ---------------------------------------------------------------------------
#: case -> (scene and config at h x w on a device, h, w, config overrides)
SHADE_CASES = {
    "config1": (lambda h, w, dev: configs.config1_sphere(h, w, device=dev), 24, 24, {}),
    "config2": (lambda h, w, dev: configs.config2_cornell(h, w, device=dev), 24, 24, {}),
    "config3": (lambda h, w, dev: configs.config3_spheres(h, w, device=dev), 24, 24, {}),
    "config3-depth0-no-shadows": (lambda h, w, dev: configs.config3_spheres(h, w, device=dev),
                                  32, 40, {"max_depth": 0, "shadows": False}),
    "config4": (lambda h, w, dev: configs.config4_bunny(h, w, subdiv=3, device=dev), 24, 32, {}),
    "config4-no-shadows": (lambda h, w, dev: configs.config4_bunny(h, w, subdiv=3, device=dev),
                           24, 32, {"shadows": False}),
    "config5": (lambda h, w, dev: configs.config5_multimesh(h, w, n_blobs=2, subdiv=3,
                                                            device=dev), 24, 32, {}),
    "config5-mirror": (lambda h, w, dev: _mirror5(h, w, dev), 40, 56, {}),
    "rtiow": (lambda h, w, dev: configs.rtiow_final_spheres(h, w, device=dev), 24, 36, {}),
    "every-lane-misses": (lambda h, w, dev: _looking_away(h, w, dev), 24, 24, {}),
}
#: what each case holds: flat or smooth, textured, real spheres, the depths
#: shaded, shadows (the case list covers each of them)
SHADE_KINDS = {
    "config1": ("flat", False, True, 0, False), "config2": ("flat", False, False, 0, True),
    "config3": ("flat", False, True, 2, True),
    "config3-depth0-no-shadows": ("flat", False, True, 0, False),
    "config4": ("smooth", False, False, 0, True), "config4-no-shadows": ("smooth", False, False, 0, False),
    "config5": ("smooth", True, False, 0, True), "config5-mirror": ("smooth", True, False, 1, True),
    "rtiow": ("flat", False, True, 2, True), "every-lane-misses": ("flat", False, True, 0, False),
}
#: K11 and the replay run the same float32 operations in the same order with
#: the same CUDA functions, so every pixel is expected to agree bit for bit
SHADE_ATOL = 0.0


def _mirror5(h, w, dev):
    scene, cfg = configs.config5_multimesh(h, w, n_blobs=2, subdiv=3, device=dev)
    scene.materials.reflectivity[1] = 0.25
    return scene, cfg


def _looking_away(h, w, dev):
    scene, cfg = configs.config1_sphere(h, w, device=dev)
    cam = Camera.make((0.0, 0.0, 5.0), (0.0, 0.0, 10.0), device=dev)
    return dataclasses.replace(scene, camera=cam), cfg


def _shade_inputs(name, dev):
    """(scene, cfg, records, o, d) of a case: the records of its clusters plan
    as render() traces them (the plan's depth cap applied)."""
    make, h, w, over = SHADE_CASES[name]
    scene, cfg = make(h, w, dev)
    cfg = cfg.replace(**over)
    plan = tpurt_torch.prepare(scene, cfg, accel="bvh")
    assert plan.kind == "clusters"
    cfg = cap_depth(cfg, plan)
    packed = pack_clusters(scene, plan.tri_ids, plan.tree)
    ids, occ = TV.records_rows(scene, cfg, packed, 0, h)
    recs = TD.records_from_ids(ids, occ, scene.n_tris)
    o, d = geom.generate_rays(scene.camera, h, w)
    return scene, cfg, recs, o.reshape(-1, 3), d.reshape(-1, 3)


def test_shade_cases_cover_every_kind():
    kinds = list(zip(*SHADE_KINDS.values()))
    assert set(SHADE_KINDS) == set(SHADE_CASES)
    assert set(kinds[0]) == {"flat", "smooth"} and set(kinds[1]) == {False, True}
    assert set(kinds[2]) == {False, True} and {0, 2} <= set(kinds[3])
    assert set(kinds[4]) == {False, True}


@pytest.mark.parametrize("name", list(SHADE_CASES))
def test_shade_kernel_matches_the_replay(cuda, name):
    scene, cfg, recs, o, d = _shade_inputs(name, cuda)
    smooth, textured, spheres, depth, shadows = SHADE_KINDS[name]
    assert (scene.smooth, scene.textured, scene.n_real_spheres > 0) == (
        smooth == "smooth", textured, spheres)
    assert (cfg.max_depth, cfg.shadows) == (depth, shadows)
    hits = recs.prim >= 0
    if name == "every-lane-misses":
        assert not bool(hits.any())
    else:
        # config 1 and the RTIOW scene show no triangle but their pad
        assert bool(hits[0].any()) and bool((hits[0] & recs.is_tri[0]).any()) != (
            name in ("config1", "rtiow"))
        if depth:
            assert bool(hits[depth].any())      # the deepest bounce is shaded
    before = SH.LAUNCHES
    got = SH.shade_records_cuda(scene, o, d, recs.prim, recs.is_tri, recs.occ,
                                cfg.max_depth, cfg.shadows)
    assert SH.LAUNCHES == before + 1
    want = TD._shade_bundle(scene, o, d, (recs.prim, recs.is_tri, recs.occ), cfg.max_depth,
                            cfg.shadows)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got - want).abs()
    off = int((got != want).any(-1).sum())
    print(f"{name}: {off} of {got.shape[0]} pixels off, max|d| {float(diff.max()):.3g}")
    assert float(diff.max()) <= SHADE_ATOL, (off, float(diff.max()))
    assert float(want.std()) > 0.01 or name == "every-lane-misses"


def test_shade_from_records_takes_the_kernel_without_gradients(cuda):
    scene, cfg, recs, o, d = _shade_inputs("config5", cuda)
    before = SH.LAUNCHES
    img = TD.shade_from_records(scene, o, d, recs, cfg.max_depth, cfg.shadows)
    assert SH.LAUNCHES == before + 1
    live = o.clone().requires_grad_(True)
    with torch.enable_grad():
        img_grad = TD.shade_from_records(scene, live, d, recs, cfg.max_depth, cfg.shadows)
    assert SH.LAUNCHES == before + 1 and img_grad.requires_grad
    assert float((img - img_grad.detach()).abs().max()) <= SHADE_ATOL
    tpurt_torch.render(scene, cfg)
    assert SH.LAUNCHES == before + 2
    tpurt_torch.render_and_grad(scene, lambda im: im.sum(), cfg)
    assert SH.LAUNCHES == before + 2


def test_shade_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    scene, cfg, recs, o, d = _shade_inputs("config3", cuda)
    args = (recs.prim, recs.is_tri, recs.occ, cfg.max_depth, cfg.shadows)
    with pytest.raises(ValueError, match="is on cpu"):
        SH.shade_records_cuda(scene, o, d.cpu(), *args)
    with pytest.raises(TypeError, match="occ must be torch.int32"):
        SH.shade_records_cuda(scene, o, d, recs.prim, recs.is_tri, recs.occ.long(),
                              cfg.max_depth, cfg.shadows)
    with pytest.raises(ValueError, match="vertices must be contiguous"):
        SH.shade_records_cuda(dataclasses.replace(
            scene, vertices=scene.vertices.t().contiguous().t()), o, d, *args)


# ---------------------------------------------------------------------------
# the sorted segment sum (csrc/segsum.cu) and the probe kernels
# (csrc/probes.cu) against their plain versions
# ---------------------------------------------------------------------------
def _assert_sums_close(got, want, idx, upd, n_rows):
    """Two sums of the same updates in another order: the bar of
    tests/test_grad.py:331, widened on rows that sum a great many updates, and
    again where `want` is index_add_'s f32 sum by atomics (probe_segsum.sum_gap)."""
    assert sum_gap(got, want, idx, upd, n_rows, serial_f32=want.dtype == torch.float32) <= 1.0


def _sorted_stream(kind, n, n_rows, width, seed, device):
    idx, upd = synthetic_stream(kind, n, n_rows, width, seed, device)
    idx, order = torch.sort(idx, stable=True)
    return idx, upd[order].contiguous()


@pytest.mark.parametrize("width", [1, 3, 6, 8, 11, 16, 32])
@pytest.mark.parametrize("kind", ["uniform", "dominant", "out_of_range", "sparse"])
def test_sorted_segsum_matches_plain_version(cuda, kind, width):
    n, n_rows = 200003, 4099          # 391 chunks, then 2, then 1: three passes
    idx, upd = _sorted_stream(kind, n, n_rows, width, 7, cuda)
    got = SS.sorted_segsum_cuda(idx, upd, n_rows)
    want = SS.sorted_segsum_reference(idx, upd, n_rows)
    exact = SS.sorted_segsum_reference(idx, upd.double(), n_rows)
    torch.cuda.synchronize()
    assert got.shape == (n_rows, width) and got.dtype == torch.float32
    _assert_sums_close(got, want, idx, upd, n_rows)
    _assert_sums_close(got, exact, idx, upd, n_rows)
    # no atomics: the same bits on every launch
    assert torch.equal(got, SS.sorted_segsum_cuda(idx, upd, n_rows))
    # the unsorted stream with its sorting positions: the same sums, bit for bit
    raw_idx, raw_upd = synthetic_stream(kind, n, n_rows, width, 7, cuda)
    order = torch.sort(raw_idx, stable=True)[1]
    assert torch.equal(got, SS.sorted_segsum_cuda(idx, raw_upd, n_rows, order))
    assert torch.equal(got, SS.segsum_rows(raw_idx, raw_upd, n_rows))


@pytest.mark.parametrize("n", [0, 1, 2, 511, 512, 513, 1031, 262145])
def test_sorted_segsum_at_any_length(cuda, n):
    for kind, n_rows in (("out_of_range", 37), ("uniform", 70001)):
        idx, upd = _sorted_stream(kind, n, n_rows, 5, n, cuda)
        got = SS.sorted_segsum_cuda(idx, upd, n_rows)
        torch.cuda.synchronize()
        _assert_sums_close(got, SS.sorted_segsum_reference(idx, upd, n_rows), idx, upd, n_rows)


def test_sorted_segsum_on_the_material_stream_shape(cuda):
    # a million updates of width 11 into 2 rows, half of them on one: a run
    # far longer than a tile, across blocks
    idx, upd = _sorted_stream("dominant", 1 << 20, 2, 11, 5, cuda)
    got = SS.sorted_segsum_cuda(idx, upd, 2)
    want = SS.sorted_segsum_reference(idx, upd, 2)
    exact = SS.sorted_segsum_reference(idx, upd.double(), 2)
    torch.cuda.synchronize()
    _assert_sums_close(got, want, idx, upd, 2)
    _assert_sums_close(got, exact, idx, upd, 2)
    assert torch.equal(got, SS.sorted_segsum_cuda(idx, upd, 2))


def test_sorted_segsum_one_row_and_nonfinite_updates(cuda):
    n = 100000
    upd = torch.ones((n, 3), device=cuda)
    idx = torch.full((n,), 5, dtype=torch.int32, device=cuda)
    got = SS.sorted_segsum_cuda(idx, upd, 9)
    assert torch.equal(got[5], torch.full((3,), float(n), device=cuda))   # exact in f32
    assert not got[:5].any() and not got[6:].any()
    # NaN and Inf reach their own row only; out-of-range rows are never read
    idx = torch.tensor([-3, 0, 0, 2, 2, 7, 9], dtype=torch.int32, device=cuda)
    upd = torch.tensor([[float("nan")], [1.0], [float("inf")], [2.0], [float("nan")], [4.0],
                        [float("nan")]], device=cuda)
    got = SS.sorted_segsum_cuda(idx, upd, 8)[:, 0]
    assert torch.isinf(got[0]) and torch.isnan(got[2]) and got[7] == 4.0
    assert not got[[1, 3, 4, 5, 6]].any()
    assert SS.sorted_segsum_cuda(idx[:0], upd[:0], 0).shape == (0, 1)


def test_segsum_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    idx, upd = _sorted_stream("uniform", 64, 9, 3, 0, cuda)
    with pytest.raises(ValueError, match="float32"):
        SS.sorted_segsum(idx, upd.double(), 9)
    with pytest.raises(ValueError, match="columns"):
        SS.sorted_segsum(idx, torch.zeros((64, SS.MAX_WIDTH + 1), device=cuda), 9)
    with pytest.raises(ValueError, match="contiguous"):
        SS.sorted_segsum(idx, upd.t().contiguous().t(), 9)
    with pytest.raises(ValueError, match="int32"):
        SS.sorted_segsum(idx.long(), upd, 9)
    with pytest.raises(ValueError, match="order"):
        SS.sorted_segsum(idx, upd, 9, torch.arange(64, dtype=torch.int32, device=cuda))


def test_gather_rows_forward_is_exact_at_every_width(cuda):
    gen = torch.Generator(device="cpu").manual_seed(2)
    for width in (3, 4, 6, 8, 11, 12):      # 4, 8, 12: rows of a multiple of 16 bytes
        table = torch.randn((1000, width), generator=gen).to(cuda)
        idx = torch.randint(0, 1000, (5000, 3), generator=gen).to(cuda)
        live = torch.ones(5000, dtype=torch.bool, device=cuda)
        assert torch.equal(TD.gather_rows(table, idx, live), table[idx])
        assert torch.equal(TD.gather_rows(table, idx[:, 0], live), table[idx[:, 0]])


@pytest.mark.parametrize("name", ["mesh", "textured"])
def test_clustered_backward_goes_through_the_segment_sum(cuda, name, monkeypatch):
    scene, cfg, plan, _ = _clustered(name, 48, 64, cuda)

    def grads():
        return tpurt_torch.render_and_grad(scene, lambda im: (im ** 2).sum(), cfg, plan=plan)[1]

    SS.reset_launches()
    TV.reset_launches()
    g = grads()
    torch.cuda.synchronize()
    per_run = 3 if name == "textured" else 2    # vertex table, material table, texels
    assert SS.launches == {"sorted_segsum": per_run, "sorted_segsum_reference": 0}
    assert {k: n for k, n in TV.launches.items() if n} == {"trace_records": 1}

    def leaves(gr):
        return {**{k: getattr(gr, k) for k in ("vertices", "vnormals", "uvs", "textures")},
                "kd": gr.materials.kd, "shininess": gr.materials.shininess}

    again = grads()
    for leaf, a in leaves(g).items():
        assert torch.equal(a, leaves(again)[leaf]), leaf      # bit for bit
    monkeypatch.setattr(TD, "gather_rows", TD.gather_rows_reference)
    plain = grads()
    assert SS.launches["sorted_segsum"] == 2 * per_run        # the plain route launched none
    for leaf, a in leaves(g).items():
        b = leaves(plain)[leaf]
        assert torch.isfinite(a).all()
        # the bar of tests/test_traversal.py:89: sums over pixels in two orders
        assert float((a - b).abs().max()) <= 2e-4 * (float(b.abs().max()) + 1e-6), leaf
    assert float(g.vertices.abs().max()) > 0 and float(g.vnormals.abs().max()) > 0
    assert (float(g.uvs.abs().max()) > 0) == (name == "textured")


def test_clustered_train_step_goes_through_the_segment_sum(cuda):
    scene, cfg, plan, _ = _clustered("mesh", 48, 64, cuda)
    moved = dataclasses.replace(scene, vertices=scene.vertices + 0.03)
    target = tpurt_torch.render(moved, cfg, plan=plan)
    step = make_train_step(cfg, plan=plan)
    SS.reset_launches()
    losses = []
    cur = scene
    for _ in range(4):
        cur, loss = step(cur, target, 0.05)
        losses.append(float(loss))
    assert SS.launches == {"sorted_segsum": 8, "sorted_segsum_reference": 0}
    assert losses[-1] < losses[0] and not torch.equal(cur.vertices, scene.vertices)


def test_clustered_backward_sends_the_sphere_table_through_the_segment_sum(cuda, monkeypatch):
    scene, cfg, plan, _ = _clustered("spheres", 32, 48, cuda)
    widths = []
    segsum_rows = TD.segsum_rows

    def recorder(idx, upd, n_rows):
        widths.append((upd.shape[1], n_rows))
        return segsum_rows(idx, upd, n_rows)

    def grads():
        return tpurt_torch.render_and_grad(scene, lambda im: (im ** 2).sum(), cfg, plan=plan)[1]

    monkeypatch.setattr(TD, "segsum_rows", recorder)
    SS.reset_launches()
    g = grads()
    torch.cuda.synchronize()
    # a live depth sends the vertex table (3 wide), the material table (11)
    # and the sphere table [centre | radius] (4 wide, 3 rows) through K8
    assert widths.count((4, scene.n_spheres)) == cfg.max_depth + 1 == 3
    assert SS.launches == {"sorted_segsum": len(widths), "sorted_segsum_reference": 0}
    monkeypatch.setattr(TD, "gather_rows", TD.gather_rows_reference)
    plain = grads()
    assert SS.launches["sorted_segsum"] == len(widths)       # the plain route launched none
    for leaf in ("sph_center", "sph_radius", "vertices"):
        a, b = getattr(g, leaf), getattr(plain, leaf)
        assert torch.isfinite(a).all() and float(b.abs().max()) > 0, leaf
        # the bar of tests/test_traversal.py:89: sums over pixels in two orders
        assert float((a - b).abs().max()) <= 2e-4 * float(b.abs().max()), leaf


def test_probe_kernels_match_plain_versions(cuda):
    gen = torch.Generator(device="cpu").manual_seed(0)
    for m, n, k in ABT_CASES:
        a = torch.randn((m, k), generator=gen).to(cuda).bfloat16()
        b = torch.randn((n, k), generator=gen).to(cuda).bfloat16()
        got, again, want = PR.abt_cuda(a, b), PR.abt_cuda(a, b), PR.abt_reference(a, b)
        # exact products, f32 sums in two orders
        assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max()), (m, n, k)
        assert torch.equal(got, again), (m, n, k)     # a fixed order: the same bits
    for nb, br, w in ZERO_CASES:
        got = PR.zeros_blocks_cuda(nb, br, w, cuda)
        assert got.is_cuda and torch.equal(got, PR.zeros_blocks_reference(nb, br, w, cuda))
        assert torch.equal(PR.zeros_blocks(nb, br, w), got)


def test_abt_takes_element_loads_off_16_bytes(cuda):
    gen = torch.Generator(device="cpu").manual_seed(1)
    a = torch.randn((8, 65), generator=gen).to(cuda).bfloat16()
    b = torch.randn((16, 65), generator=gen).to(cuda).bfloat16()
    # k % 8 == 0 but 2 bytes off a 16-byte boundary: the launcher picks
    # element loads
    a_off = a.reshape(-1)[1:8 * 64 + 1].view(8, 64)
    b_off = b.reshape(-1)[1:16 * 64 + 1].view(16, 64)
    assert a_off.data_ptr() % 16 and b_off.data_ptr() % 16 and a_off.is_contiguous()
    got, want = PR.abt_cuda(a_off, b_off), PR.abt_reference(a_off, b_off)
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


def test_probe_tool_runs_on_the_card(cuda, capsys):
    from tpurt_torch.tools import probe_segsum

    probe_segsum.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 + 1 + 2 + 5 + 4 and all("probes:" in l for l in lines[1:])


# ---------------------------------------------------------------------------
# the C++ builders, the uniform grid and .obj import on the card
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def config4_full():
    """Config 4 at full size (81,922 triangles) on the card, 1024x1024."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return configs.config4_bunny(1024, 1024, device="cuda")


def test_native_builders_on_full_config4(cuda, config4_full):
    from tpurt_torch.accel.native import build_clusters_native, build_grid_native

    scene, _ = config4_full
    verts, tris = scene.vertices.cpu().numpy(), scene.triangles.cpu().numpy()
    T = tris.shape[0]
    clusters = build_clusters_native(verts, tris)
    assert clusters.tri_ids.shape == (-(-T // 128), 128)
    ids = clusters.tri_ids
    pad = np.zeros(ids.shape, bool)
    pad[:, 1:] = ids[:, 1:] == ids[:, :1]
    # every triangle in exactly one cluster, pads apart
    assert np.array_equal(np.sort(ids[~pad]), np.arange(T))
    grid = build_grid_native(verts, tris)
    assert set(np.unique(grid.tri_ids).tolist()) == set(range(T))
    assert grid.tri_ids.shape[0] > clusters.tri_ids.shape[0]
    assert (grid.aabb_lo <= grid.aabb_hi).all()


def test_trace_records_on_grid_blocks_matches_plain_version(cuda, config4_full):
    scene, cfg = config4_full
    plan = tpurt_torch.prepare(scene, cfg, accel="grid")
    packed = pack_clusters(scene, plan.tri_ids, plan.tree)
    h, w = cfg.height, cfg.width
    got = TV.trace_records_cuda(packed, cfg, 0, h, max_depth=0)
    pix = torch.randperm(h * w, generator=torch.Generator().manual_seed(2))[:2048].cuda()
    o, d = TV._camera_rays(packed, cfg, 0, h * w)
    alive = torch.ones(pix.numel(), dtype=torch.bool, device=cuda)
    want = TV.trace_bounce_reference(packed, cfg, o[pix].contiguous(), d[pix].contiguous(),
                                     alive)
    torch.cuda.synchronize()
    _assert_records_equal(tuple(x[0][pix] for x in got[:3]), want[:3])
    assert int((want[0] >= 0).sum()) > 0


def test_render_and_grad_on_grid_plan_matches_clusters_plan(cuda):
    scene, cfg = configs.config4_bunny(96, 128, subdiv=5, device=cuda)
    target = tpurt_torch.render(dataclasses.replace(scene, vertices=scene.vertices * 1.01), cfg)
    out = {}
    for accel in ("grid", "bvh"):
        plan = tpurt_torch.prepare(scene, cfg, accel=accel)
        TV.reset_launches()
        SS.reset_launches()
        out[accel] = tpurt_torch.render_and_grad(
            scene, lambda im: ((im - target) ** 2).sum(), cfg, plan=plan)
        torch.cuda.synchronize()
        assert {k: n for k, n in TV.launches.items() if n} == {"trace_records": 1}
        assert SS.launches == {"sorted_segsum": 2, "sorted_segsum_reference": 0}
    (_, img_g), g_grid = out["grid"]
    (_, img_c), g_clus = out["bvh"]
    torch.testing.assert_close(img_g, img_c, atol=ATOL, rtol=0)
    theirs = dict(MK.scene_float_leaves(g_clus))
    for path, a in MK.scene_float_leaves(g_grid):
        b = theirs[path]
        assert torch.isfinite(a).all(), path
        assert float((a - b).abs().max()) <= 2e-4 * float(b.abs().max()), path


def test_obj_round_trip_on_the_card(cuda, tmp_path):
    from tpurt_torch.scene import obj as OBJ

    scene, cfg = configs.config4_bunny(64, 64, subdiv=4, device=cuda)
    path = str(tmp_path / "c4.obj")
    OBJ.save_obj(path, scene.vertices.cpu().numpy(), scene.triangles.cpu().numpy())
    lights = list(zip(scene.light_pos.tolist(), scene.light_color.tolist()))
    mats = [{"ka": 0.08, "kd": (0.75, 0.65, 0.5), "ks": 0.25, "shininess": 32.0}]
    loaded = OBJ.scene_from_obj(path, materials=mats, lights=lights, camera=scene.camera,
                                device=cuda)
    assert loaded.vertices.device.type == "cuda"
    assert torch.equal(loaded.vertices, scene.vertices)
    assert torch.equal(loaded.triangles, scene.triangles)
    direct = build_scene(vertices=scene.vertices.cpu().numpy(),
                         triangles=scene.triangles.cpu().numpy(), materials=mats,
                         lights=lights, camera=scene.camera, smooth=True, device=cuda)
    TV.reset_launches()
    img = tpurt_torch.render(loaded, cfg)
    torch.cuda.synchronize()
    assert {k: n for k, n in TV.launches.items() if n} == {"trace_records": 1}
    assert torch.equal(img, tpurt_torch.render(direct, cfg))


def _dist_rank(mesh, out_dir):
    """A rank's image of config 3 and config 4 (its clusters plan), its
    gradients of sum(image²) on config 3 twice, its launches, its card, a
    heartbeat, and config 3 rendered in chunks of 8 rows that crashes after
    2 chunks and resumes."""
    scene, cfg = configs.config3_spheres(40, 56, device=mesh.device)
    s4, c4 = configs.config4_bunny(48, 48, subdiv=3, device=mesh.device)
    plan4 = tpurt_torch.prepare(s4, c4, accel="bvh")
    MK.reset_launches()
    TV.reset_launches()
    img = render_sharded(scene, cfg, mesh)
    img4 = render_sharded(s4, c4, mesh, plan=plan4)
    runs = [render_and_grad_sharded(scene, lambda im: (im ** 2).sum(), cfg, mesh)[1]
            for _ in range(2)]
    torch.cuda.synchronize()
    launches = {k: n for mod in (MK, TV) for k, n in mod.launches.items() if n}
    crashed = None
    try:
        render_resumable(scene, cfg, out_dir, chunk_rows=8, mesh=mesh, _fail_after=2)
    except RuntimeError as e:
        crashed = str(e)
    return {"image": img.cpu(), "image4": img4.cpu(), "launches": launches,
            "grads": [{".".join(p): t.cpu() for p, t in MK.scene_float_leaves(g)}
                      for g in runs],
            "card": (str(mesh.device), torch.cuda.current_device()),
            "heartbeat": heartbeat(mesh), "crashed": crashed,
            "resumed": render_resumable(scene, cfg, out_dir, chunk_rows=8, mesh=mesh)}


@pytest.mark.parametrize("world,backend", [
    (1, "nccl"), (2, "gloo"),
    pytest.param(None, "nccl", id="every-card-nccl",
                 marks=pytest.mark.skipif(torch.cuda.device_count() < 2,
                                          reason="needs two cards or more"))])
def test_render_sharded_on_the_card(cuda, tmp_path, world, backend):
    """World 1 over NCCL, two ranks over gloo on one card, and one rank a card
    over NCCL: the images equal render()'s bit for bit, each rank launches K1
    and K2 on its rows on its own card, the gradients meet the single
    device's bar and repeat bit for bit, and the resumable render's chunk
    manifest (broadcast from rank 0) resumes to render()'s image."""
    world = world or torch.cuda.device_count()
    results = spawn_ranks(_dist_rank, world, backend, str(tmp_path), device="cuda",
                          timeout_s=300)
    scene, cfg = configs.config3_spheres(40, 56, device=cuda)
    s4, c4 = configs.config4_bunny(48, 48, subdiv=3, device=cuda)
    want = tpurt_torch.render(scene, cfg).cpu()
    want4 = tpurt_torch.render(s4, c4, plan=tpurt_torch.prepare(s4, c4, accel="bvh")).cpu()
    _, g = tpurt_torch.render_and_grad(scene, lambda im: (im ** 2).sum(), cfg)
    assert np.array_equal(results[0]["resumed"], want.numpy())
    assert all(r["resumed"] is None for r in results[1:])
    for rank, r in enumerate(results):
        card = rank % torch.cuda.device_count()
        assert r["card"] == (f"cuda:{card}", card)
        assert r["heartbeat"] > 0.0
        assert r["crashed"] == "injected failure after 2 chunks"
        assert torch.equal(r["image"], want) and torch.equal(r["image4"], want4)
        assert r["launches"] == {"megakernel_fwd": 3, "megakernel_bwd": 2,
                                 "trace_records": 1}
        first, again = r["grads"]
        for path, b in MK.scene_float_leaves(g):
            k = ".".join(path)
            assert torch.equal(first[k], again[k]), k
            assert torch.equal(first[k], results[0]["grads"][0][k]), k
            top = float(b.abs().max())
            assert float((first[k] - b.cpu()).abs().max()) <= GRAD_RTOL * top + 1e-12, k


@pytest.mark.skipif(torch.cuda.device_count() < 2, reason="needs two cards or more")
def test_multihost_render_one_process_a_card(cuda, tmp_path):
    """multihost-render as one process a card over NCCL on 127.0.0.1: process
    0's PNG equals render()'s."""
    n = torch.cuda.device_count()
    out, ref = str(tmp_path / "mh.png"), str(tmp_path / "r.png")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpurt_torch.cli", "multihost-render", "--config", "3",
         "--res", "40x56", "--device", "cuda", "--backend", "nccl",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
         "--process-id", str(i), "--out", out],
        cwd=Path(__file__).resolve().parents[1], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(n)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * n, [e[-2000:] for _, e in outs]
    assert json.loads(outs[0][0].splitlines()[-1]) == {"out": out, "devices": n}
    scene, cfg = configs.config3_spheres(40, 56, device=cuda)
    save_png(ref, tpurt_torch.render(scene, cfg))
    assert np.array_equal(load_png(out), load_png(ref))


def _ring_rank(mesh):
    """A rank's ring image, records and launches on config 4 (48x48, subdiv
    3, one bounce, shadows) and config 3 (40x56 through a clusters plan,
    reflective spheres, two bounces), and its gradients of sum(image²) twice."""
    out = {}
    for name, (scene, cfg) in _ring_cases(mesh.device).items():
        plan = tpurt_torch.prepare(scene, cfg, accel="bvh")
        scene2, parts = SSH.prepare_scene_sharded(scene, plan.tri_ids, mesh.size)
        MK.reset_launches()
        TV.reset_launches()
        SS.reset_launches()
        img = SSH.render_scene_sharded_prepared(scene2, cfg, parts, mesh)
        runs = [render_and_grad_scene_sharded(scene2, lambda im: (im ** 2).sum(), cfg, parts,
                                              mesh)[1] for _ in range(2)]
        torch.cuda.synchronize()
        launches = {k: n for mod in (MK, TV, SS) for k, n in mod.launches.items() if n}
        ids, occ = SSH.ring_records(scene2, cfg, parts, mesh)
        out[name] = {"image": img.cpu(), "ids": ids.cpu(), "occ": occ.cpu(),
                     "rows": SH.rank_rows(cfg.height, mesh), "launches": launches,
                     "grads": [{".".join(p): t.cpu() for p, t in MK.scene_float_leaves(g)}
                               for g in runs]}
    return out


def _ring_cases(dev):
    s4, c4 = configs.config4_bunny(48, 48, subdiv=3, device=dev)
    s3, c3 = configs.config3_spheres(40, 56, device=dev)
    return {"c4": (s4, c4.replace(max_depth=1)), "c3": (s3, c3)}


@pytest.mark.parametrize("world,backend", [
    (1, "nccl"), (2, "gloo"),
    pytest.param(None, "nccl", id="every-card-nccl",
                 marks=pytest.mark.skipif(torch.cuda.device_count() < 2,
                                          reason="needs two cards or more"))])
def test_ring_on_the_card(cuda, monkeypatch, world, backend):
    """The sharded scene's ring: world 1 over NCCL, two ranks over gloo on one
    card (host copies around the ring), and one rank a card over NCCL
    (batch_isend_irecv of CUDA tensors).  The image equals the replicated
    render of the renumbered scene whose shadows come from K7 at the
    kernel's hit points, bit for bit, as do the ids and the occlusion bits;
    the ranks launch K6, K7 and K8 and no plain version; the gradients meet
    the render_and_grad bars and repeat bit for bit on every rank."""
    world = world or torch.cuda.device_count()
    results = spawn_ranks(_ring_rank, world, backend, device="cuda", timeout_s=300)
    # the reference's shadows through K7 at the kernel's hit points
    monkeypatch.setattr(TV, "SHADOW_REBIN_MIN_CLUSTERS", 0)
    for name, (scene, cfg) in _ring_cases(cuda).items():
        plan = tpurt_torch.prepare(scene, cfg, accel="bvh")
        scene2, tri_ids2 = SSH.renumber_by_clusters(scene, plan.tri_ids)
        want = TV.render_rows_clustered(scene2, cfg, tri_ids2, 0, cfg.height).cpu()
        ids, occ = TV.records_rows(scene2, cfg, pack_clusters(scene2, tri_ids2), 0, cfg.height)
        _, g = tpurt_torch.render_and_grad(scene2, lambda im: (im ** 2).sum(), cfg,
                                           plan=RenderPlan(kind="clusters", tri_ids=tri_ids2))
        first = results[0][name]["grads"][0]
        for r in results:
            got = r[name]
            lo, hi = got["rows"]
            cols = slice(lo * cfg.width, hi * cfg.width)
            assert torch.equal(got["image"], want), name
            assert torch.equal(got["ids"], ids[:, cols].cpu()), name
            assert torch.equal(got["occ"], occ[:, cols].cpu()), name
            assert set(got["launches"]) <= {"trace_bounce", "trace_shadows", "sorted_segsum"}
            assert got["launches"].get("sorted_segsum", 0) > 0
            for run in got["grads"]:
                for k, v in run.items():
                    assert torch.equal(v, first[k]), (name, k)
        assert sum(r[name]["launches"].get("trace_bounce", 0) for r in results) > 0
        assert sum(r[name]["launches"].get("trace_shadows", 0) for r in results) > 0
        for path, b in MK.scene_float_leaves(g):
            k = ".".join(path)
            a, top = b.cpu(), float(b.abs().max())
            if k in ("light_color", "sph_center", "vertices"):
                np.testing.assert_allclose(first[k].numpy(), a.numpy(), rtol=1e-4,
                                           atol=1e-5 * max(1.0, top), err_msg=k)
            else:
                assert float((first[k] - a).abs().max()) <= GRAD_RTOL * top + 1e-12, k


def test_dryrun_multichip_on_the_card(cuda):
    """The graft entry's dry run, two ranks over gloo on one card: one train
    step on each of its three paths, the ring's image bit-equal to the
    replicated render whose shadows come from K7 at the kernel's hit
    points."""
    from tpurt_torch.entry import dryrun_multichip

    losses = dryrun_multichip(2, "gloo")
    assert set(losses) == {"phase1", "clusters", "ring"}
    assert all(np.isfinite(v) for v in losses.values())


@pytest.mark.parametrize("config,mode,want", [
    (3, "fwd", {"megakernel_fwd"}),
    (3, "fwdbwd", {"l2_hand", "megakernel_fwd"}),
    (4, "fwdbwd", {"trace_records", "sorted_segsum"}),
])
def test_bench_on_the_card(cuda, capsys, config, mode, want):
    """The benchmark command (tools/bench.py) at a small size: bench.py's
    JSON line and the route's kernels, no plain version (K4 for phase-1
    fwdbwd, K1 for the forward alone, K5 and K8 on clusters)."""
    from tpurt_torch.tools import bench

    record, launches = bench.main(["--config", str(config), "--mode", mode, "--res", "64x96",
                                   "--iters", "2", "--warmup", "1"])
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line == record and set(launches) == want
    assert record["ms_per_frame"] > 0 and record["value"] > 0
    scene, cfg = configs.ALL_CONFIGS[config](64, 96)
    assert record["rays_nominal"] == bench.count_rays(cfg, scene)
    if config == 3:
        assert record["rays_traced"] == record["rays_nominal"]
    else:
        assert 0 < record["rays_traced"] <= record["rays_nominal"]
    assert ("ms_per_frame_fwd" in record) == (mode == "fwdbwd")
