"""Tile-parallel rows over torch.distributed (tpurt_torch.dist.shard and the
mesh train step), on gloo ranks on the CPU, where the kernels' plain
versions run; the bars of tests/test_dist.py:13-67.

One spawn a world size runs every check of that world (each rank returns
plain CPU tensors).  The ranks import this module afresh, so JAX is imported
only inside the fixtures that need it: a rank must not load JAX.  tpurt's
own sharded renders are not called: its single-device render, held to the
single-device port, is the reference (ROADMAP, test-time budget)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import tpurt_torch
from tpurt_torch.bridge import leaves_as_numpy
from tpurt_torch.dist import (make_train_step, render_and_grad_sharded, render_sharded,
                              spawn_ranks)
from tpurt_torch.dist.shard import rank_rows, rows_per_device
from tpurt_torch.kernels import megakernel as TMK
from tpurt_torch.kernels import segsum as TSS
from tpurt_torch.kernels import traversal as TTV
from tpurt_torch.kernels.packc import pack_clusters
from tpurt_torch.render import cap_depth
from tpurt_torch.scene import configs

import torch_one_thread  # noqa: F401  (one PyTorch thread)

ATOL = 2e-4          # the bar of tests/test_kernels.py, against tpurt
GRAD_RTOL = 2e-3     # of each leaf's max|g|
# name: (config, height, width); config 3 at 34 rows splits 9, 9, 9, 7 over 4
RENDERS = {"c1": (1, 24, 24), "c3-ragged": (3, 34, 32), "c1-empty-rank": (1, 3, 24)}
WORLD_RENDERS = {1: ("c1",), 2: ("c1",), 4: ("c1", "c3-ragged", "c1-empty-rank")}
C4 = dict(height=32, width=32, subdiv=3)
TRAIN_STEPS, TRAIN_LR = 5, 0.5


def _scene(name, device="cpu"):
    k, h, w = RENDERS[name]
    return configs.ALL_CONFIGS[k](h, w, device=device)


def _sum(img):
    return img.sum()


def _launches():
    return {k: n for mod in (TMK, TTV, TSS) for k, n in mod.launches.items() if n}


def _reset():
    for mod in (TMK, TTV, TSS):
        mod.reset_launches()


def _grads(g):
    return {k: torch.from_numpy(v) for k, v in leaves_as_numpy(g).items()}


def _renders_rank(mesh, names):
    """Each named render over the mesh, with this rank's launches and, on
    the case with an empty rank, its gradients of sum(image)."""
    out = {}
    for name in names:
        scene, cfg = _scene(name)
        _reset()
        img = render_sharded(scene, cfg, mesh)
        out[name] = {"image": img, "launches": _launches(), "rows": rank_rows(cfg.height, mesh)}
    if "c1-empty-rank" in names:
        scene, cfg = _scene("c1-empty-rank")
        _reset()
        (_, _), g = render_and_grad_sharded(scene, _sum, cfg, mesh)
        out["c1-empty-rank"]["grad_launches"] = _launches()
        out["c1-empty-rank"]["grads"] = _grads(g)
    return out


def _target(scene, cfg):
    """The render of the scene with its light dimmed: recoverable by SGD."""
    return tpurt_torch.render(dataclasses.replace(scene, light_color=scene.light_color * 0.5),
                              cfg)


def _world2_rank(mesh):
    """The two-rank checks: the light's and every leaf's gradient on config
    2, config 4's clusters plan (image, records of the rank's window against
    the whole frame's, vertex gradient), the mesh train step and its repeat."""
    out = {}
    scene, cfg = configs.config2_cornell(16, 16, device="cpu")
    (_, img), g = render_and_grad_sharded(scene, _sum, cfg, mesh)
    out["c2"] = {"image": img, "grads": _grads(g)}

    scene, cfg = configs.config4_bunny(C4["height"], C4["width"], subdiv=C4["subdiv"],
                                       device="cpu")
    plan = tpurt_torch.prepare(scene, cfg, accel="bvh")
    _reset()
    img = render_sharded(scene, cfg, mesh, plan=plan)
    launches = _launches()
    capped = cap_depth(cfg, plan)
    packed = pack_clusters(scene, plan.tri_ids, plan.tree)
    lo, hi = rank_rows(cfg.height, mesh)
    ids_w, occ_w = TTV.records_rows(scene, capped, packed, lo, hi - lo)
    ids_f, occ_f = TTV.records_rows(scene, capped, packed, 0, cfg.height)
    cols = slice(lo * cfg.width, hi * cfg.width)
    (_, _), g = render_and_grad_sharded(scene, _sum, cfg, mesh, plan=plan)
    (_, _), g2 = render_and_grad_sharded(scene, _sum, cfg, mesh, plan=plan)
    out["c4"] = {"image": img, "launches": launches, "vertices": g.vertices,
                 "vertices_again": g2.vertices,
                 "ids_equal": torch.equal(ids_w, ids_f[:, cols]),
                 "occ_equal": torch.equal(occ_w, occ_f[:, cols])}

    scene, cfg = configs.config1_sphere(16, 16, device="cpu")
    target = _target(scene, cfg)
    step = make_train_step(cfg, mesh=mesh)
    losses, s = [], scene
    for _ in range(TRAIN_STEPS):
        s, loss = step(s, target, TRAIN_LR)
        losses.append(float(loss))
    out["train"] = losses

    scene, cfg = configs.config3_spheres(16, 16, device="cpu")
    step = make_train_step(cfg, mesh=mesh, plan=tpurt_torch.prepare(scene, cfg))
    target = torch.zeros((16, 16, 3))
    _reset()
    runs = [_grads(step(scene, target, 0.01)[0]) for _ in range(2)]
    out["repeat"] = {"runs": runs, "launches": _launches()}
    return out


@pytest.fixture(scope="module")
def worlds():
    """{world: [rank results]} of the renders of WORLD_RENDERS."""
    return {n: spawn_ranks(_renders_rank, n, "gloo", names, device="cpu", timeout_s=300)
            for n, names in WORLD_RENDERS.items()}


@pytest.fixture(scope="module")
def world2():
    return spawn_ranks(_world2_rank, 2, "gloo", device="cpu", timeout_s=300)


@pytest.fixture(scope="module")
def tpurt_images():
    """tpurt's single-device render of each case (interpret mode)."""
    import tpurt.render as jrender
    from tpurt.scene import configs as jconfigs

    out = {}
    for name, (k, h, w) in RENDERS.items():
        js, jcfg = jconfigs.ALL_CONFIGS[k](h, w)
        out[name] = np.asarray(jrender.render(js, jcfg))
    return out


CASES = [(n, name) for n, names in WORLD_RENDERS.items() for name in names]


@pytest.mark.parametrize("n,name", CASES)
def test_sharded_render_equals_single_device(worlds, n, name):
    """Bit for bit: each pixel is computed as the single-device render
    computes it, whatever the rank's window."""
    scene, cfg = _scene(name)
    ref = tpurt_torch.render(scene, cfg)
    for rank, result in enumerate(worlds[n]):
        assert torch.equal(result[name]["image"], ref), (n, name, rank)


@pytest.mark.parametrize("n,name", CASES)
def test_sharded_render_matches_tpurt(worlds, tpurt_images, n, name):
    np.testing.assert_allclose(worlds[n][0][name]["image"].numpy(), tpurt_images[name],
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("n,name", CASES)
def test_each_rank_renders_its_rows_only(worlds, n, name):
    """Ranks take ceil(H/n) rows clamped to the image; a rank whose window
    is empty launches nothing."""
    _, h, _ = RENDERS[name]
    per = rows_per_device(h, n)
    for rank, result in enumerate(worlds[n]):
        lo, hi = result[name]["rows"]
        assert (lo, hi) == (min(rank * per, h), min(rank * per + per, h))
        want = {"tile_color_reference": 1} if hi > lo else {}
        assert result[name]["launches"] == want, (rank, lo, hi)


def test_ragged_split_is_nine_nine_nine_seven(worlds):
    assert [r["c3-ragged"]["rows"] for r in worlds[4]] == [(0, 9), (9, 18), (18, 27), (27, 34)]


def test_empty_rank_joins_the_gradient_sum_with_zeros(worlds):
    """Config 1 at 3 rows over 4 ranks: rank 3 renders nothing and
    differentiates nothing, the sum still equals the single-device
    gradients, and every rank holds the same bits."""
    results = worlds[4]
    assert results[3]["c1-empty-rank"]["grad_launches"] == {}
    assert results[0]["c1-empty-rank"]["grad_launches"] == {
        "tile_color_reference": 1, "tile_color_vjp_reference": 1}
    scene, cfg = _scene("c1-empty-rank")
    (_, _), g = tpurt_torch.render_and_grad(scene, _sum, cfg)
    want = _grads(g)
    for r in results[1:]:
        for k, v in r["c1-empty-rank"]["grads"].items():
            assert torch.equal(v, results[0]["c1-empty-rank"]["grads"][k]), k
    got = results[0]["c1-empty-rank"]["grads"]
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0,
                                   atol=GRAD_RTOL * float(want[k].abs().max()) + 1e-12)


def test_sharded_light_color_grad_matches_single_device(world2):
    """tests/test_dist.py:49's bar on the gradient of sum(render_sharded)."""
    scene, cfg = configs.config2_cornell(16, 16, device="cpu")
    (_, img), g = tpurt_torch.render_and_grad(scene, _sum, cfg)
    for r in world2:
        assert torch.equal(r["c2"]["image"], img)
        np.testing.assert_allclose(r["c2"]["grads"]["light_color"].numpy(),
                                   g.light_color.numpy(), rtol=1e-5, atol=1e-5)


def test_sharded_grads_match_tpurt(world2):
    import jax
    import jax.numpy as jnp

    import tpurt.render as jrender
    from tpurt.scene import configs as jconfigs

    js, jcfg = jconfigs.config2_cornell(16, 16)
    gj = jax.grad(lambda s: jnp.sum(jrender.render(s, jcfg)), allow_int=True)(js)
    got = world2[0]["c2"]["grads"]
    for k in got:   # every float leaf of the scene
        a = np.asarray(functools.reduce(getattr, k.split("."), gj))
        b = got[k].numpy()
        assert np.isfinite(b).all(), k
        np.testing.assert_allclose(b, a, rtol=0, atol=GRAD_RTOL * (np.abs(a).max() + 1e-6),
                                   err_msg=k)


def test_clustered_rows_equal_the_whole_frame(world2):
    """Config 4 through accel="bvh" over 2 ranks: re-binning the wavefront
    within a rank's window gives the whole frame's records, the image equals
    the single-device one, each rank launches its own traversal."""
    scene, cfg = configs.config4_bunny(C4["height"], C4["width"], subdiv=C4["subdiv"],
                                       device="cpu")
    plan = tpurt_torch.prepare(scene, cfg, accel="bvh")
    ref = tpurt_torch.render(scene, cfg, plan=plan)
    for r in world2:
        assert r["c4"]["ids_equal"] and r["c4"]["occ_equal"]
        assert torch.equal(r["c4"]["image"], ref)
        assert r["c4"]["launches"].get("trace_records_reference", 0) >= 1
        assert "tile_color_reference" not in r["c4"]["launches"]


def test_clustered_vertex_grad_matches_single_device(world2):
    scene, cfg = configs.config4_bunny(C4["height"], C4["width"], subdiv=C4["subdiv"],
                                       device="cpu")
    plan = tpurt_torch.prepare(scene, cfg, accel="bvh")
    (_, _), g = tpurt_torch.render_and_grad(scene, _sum, cfg, plan=plan)
    want = g.vertices
    for r in world2:
        got = r["c4"]["vertices"]
        assert torch.isfinite(got).all() and float(got.abs().max()) > 0.0
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=GRAD_RTOL * float(want.abs().max()))
        assert torch.equal(got, r["c4"]["vertices_again"])
    assert torch.equal(world2[0]["c4"]["vertices"], world2[1]["c4"]["vertices"])


def test_mesh_train_step_reduces_loss(world2):
    """tests/test_dist.py:52-67: 5 steps towards the image of the dimmed
    light lower the loss, on both ranks alike."""
    losses = world2[0]["train"]
    assert world2[1]["train"] == losses
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_two_rank_step_repeats_bit_for_bit(world2):
    """Two runs of the mesh step from one scene: the same bits on each rank
    and across ranks (gradients summed in rank order).  The step on a
    phase-1 plan runs the forward and the replay backward, never the fused
    L2 kernel."""
    for r in world2:
        a, b = r["repeat"]["runs"]
        for k in a:
            assert torch.equal(a[k], b[k]), k
            assert torch.equal(a[k], world2[0]["repeat"]["runs"][0][k]), k
        assert r["repeat"]["launches"] == {"tile_color_reference": 2,
                                           "tile_color_vjp_reference": 2}


def test_sharded_render_rejects_a_scene_on_another_device():
    from tpurt_torch.dist.shard import Mesh

    scene, cfg = configs.config1_sphere(4, 4, device="cpu")
    mesh = Mesh(rank=0, size=1, device=torch.device("meta"), backend="gloo")
    with pytest.raises(ValueError, match="renders on meta"):
        render_sharded(scene, cfg, mesh)


@pytest.mark.parametrize("h,n", [(24, 1), (24, 2), (34, 4), (3, 4), (1080, 16)])
def test_rows_per_device_covers_the_window(h, n):
    from tpurt_torch.dist.shard import Mesh

    windows = [rank_rows(h, Mesh(rank=r, size=n, device=torch.device("cpu"), backend="gloo"))
               for r in range(n)]
    assert windows[0][0] == 0 and windows[-1][1] == h
    assert all(a[1] == b[0] for a, b in zip(windows, windows[1:]))
    assert max(hi - lo for lo, hi in windows) == rows_per_device(h, n) == -(-h // n)


def test_render_rows_without_a_plan_raises_on_a_textured_scene():
    """As tpurt/dist/shard.py:62-72: a scene the phase-1 kernels do not take
    needs a plan, or the oracle asked for by name."""
    from tpurt_torch.dist.shard import render_rows
    from tpurt_torch.render import RenderPlan

    scene, cfg = configs.config5_multimesh(8, 8, n_blobs=1, subdiv=1, device="cpu")
    with pytest.raises(ValueError, match="needs a prepared acceleration plan"):
        render_rows(scene, cfg, 0, 8)
    oracle = render_rows(scene, cfg, 2, 4, plan=RenderPlan(kind="oracle"))
    whole = tpurt_torch.render(scene, cfg, plan=RenderPlan(kind="oracle"))
    torch.testing.assert_close(oracle, whole[2:6], rtol=0, atol=ATOL)
    clustered = render_rows(scene, cfg, 2, 4, plan=tpurt_torch.prepare(scene, cfg))
    torch.testing.assert_close(clustered, whole[2:6], rtol=0, atol=ATOL)
