"""The sharded scene and its ring (tpurt_torch.dist.scene_shard, the ring
train step) on gloo ranks on the CPU, where the kernels' plain versions run;
the bars of tests/test_dist.py:85-178, held against the port's replicated
clustered render of the renumbered scene (and, in
test_torch_scene_shard_tpurt.py, against tpurt's).

One spawn a world size runs every check of that world (each rank returns
plain CPU tensors).  The ranks import this module afresh, so JAX is
imported only inside the test that compares the host parts with tpurt's:
a rank must not load JAX.  tpurt's own ring render is interpret-mode Pallas under
shard_map and is not called."""
import dataclasses

import numpy as np
import pytest
import torch

import tpurt_torch
from tpurt_torch.bridge import leaves_as_numpy
from tpurt_torch.dist import (make_ring_train_step, prepare_scene_sharded,
                              render_and_grad_scene_sharded, render_scene_sharded,
                              render_scene_sharded_prepared, renumber_by_clusters, spawn_ranks)
from tpurt_torch.dist import scene_shard as SSH
from tpurt_torch.dist import shard as SH
from tpurt_torch.dist.shard import Mesh, rank_rows
from tpurt_torch.kernels import packc as PC
from tpurt_torch.kernels import segsum as TSS
from tpurt_torch.kernels import traversal as TTV
from tpurt_torch.render import RenderPlan
from tpurt_torch.scene import configs

import torch_one_thread  # noqa: F401  (one PyTorch thread)

GRAD_RTOL = 2e-3     # of each leaf's max|g|: the port's bar
# tests/test_dist.py:171-178, tpurt's bar for the ring's gradients
TPURT_LEAVES, TPURT_RTOL, TPURT_ATOL = ("light_color", "sph_center", "vertices"), 1e-4, 1e-5
# name: (config, height, width, max_depth, shadows, extra constructor args)
CASES = {
    "c4": (4, 8, 8, 0, True, {"subdiv": 2}),           # tests/test_dist.py:85
    "c3": (3, 8, 8, 1, True, {}),                      # reflective spheres, 1 cluster
    "c5": (5, 8, 8, 1, True, {"n_blobs": 1, "subdiv": 1}),   # textured, smooth
    "c4-empty": (4, 3, 8, 0, True, {"subdiv": 2}),     # 3 rows over 4 ranks
}
WORLD_CASES = {1: ("c4", "c3"), 2: ("c4", "c3", "c5"), 4: ("c4", "c3", "c4-empty")}
TRAIN_STEPS, TRAIN_LR = 3, 0.5


def _case(name, device="cpu"):
    k, h, w, depth, shadows, kw = CASES[name]
    scene, cfg = configs.ALL_CONFIGS[k](h, w, device=device, **kw)
    cfg = cfg.replace(max_depth=depth, shadows=shadows)
    plan = tpurt_torch.prepare(scene, cfg, accel="bvh")
    return scene, cfg, plan


def _sq(img):
    return (img ** 2).sum()


def _grads(g):
    return {k: torch.from_numpy(v) for k, v in leaves_as_numpy(g).items()}


def _launches():
    return {k: n for mod in (TTV, TSS) for k, n in mod.launches.items() if n}


def _reset():
    for mod in (TTV, TSS):
        mod.reset_launches()
    SH.reset_ring_stats()


def _world_rank(mesh, names):
    """Each case's ring image, this rank's records and launches, and its
    gradients of sum(image²) twice; at world 2 the ring train step."""
    out = {}
    for name in names:
        scene, cfg, plan = _case(name)
        scene2, parts = prepare_scene_sharded(scene, plan.tri_ids, mesh.size)
        _reset()
        img = render_scene_sharded_prepared(scene2, cfg, parts, mesh)
        launches, shifts = _launches(), dict(SH.ring_stats)
        ids, occ = SSH.ring_records(scene2, cfg, parts, mesh)
        runs = [_grads(render_and_grad_scene_sharded(scene2, _sq, cfg, parts, mesh)[1])
                for _ in range(2)]
        out[name] = {"image": img, "ids": ids, "occ": occ, "launches": launches,
                     "shifts": shifts["shifts"], "rows": rank_rows(cfg.height, mesh),
                     "grads": runs}
    if mesh.size == 2:
        scene, cfg, plan = _case("c3")
        scene2, parts = prepare_scene_sharded(scene, plan.tri_ids, mesh.size)
        target = tpurt_torch.render(
            dataclasses.replace(scene2, light_color=scene2.light_color * 0.5), cfg)
        step = make_ring_train_step(cfg, mesh, parts)
        losses, s = [], scene2
        for _ in range(TRAIN_STEPS):
            s, loss = step(s, target, TRAIN_LR)
            losses.append(float(loss))
        out["train"] = losses
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * mesh.rank
        there = SH.ring_shift([x], mesh)[0]
        out["shift"] = (there, SH.ring_shift([there], mesh, back=True)[0])
    return out


def _mismatch_rank(mesh, other):
    """Rank 0 takes a ring step that rank 1 does not: rank 1 returns at once
    ("gone") or waits in another collective ("elsewhere")."""
    if mesh.rank == 0:
        SH.ring_shift([torch.zeros(4)], mesh)
    elif other == "elsewhere":
        SH._all_gather(torch.zeros(2), mesh)
    return mesh.rank


@pytest.mark.parametrize("other", ["gone", "elsewhere"])
def test_a_ring_step_that_one_rank_skips_is_an_error(other):
    """A rank that leaves makes the step raise in the other rank, which
    spawn_ranks raises; a rank stuck in another collective is stopped at
    spawn_ranks' time limit (and, without one, at
    launch.COLLECTIVE_TIMEOUT_S): neither hangs."""
    from torch.multiprocessing import ProcessRaisedException

    error = ProcessRaisedException if other == "gone" else TimeoutError
    with pytest.raises(error):
        spawn_ranks(_mismatch_rank, 2, "gloo", other, device="cpu", timeout_s=6)


@pytest.fixture(scope="module")
def worlds():
    """{world: [rank results]} of WORLD_CASES."""
    return {n: spawn_ranks(_world_rank, n, "gloo", names, device="cpu", timeout_s=300)
            for n, names in WORLD_CASES.items()}


@pytest.fixture(scope="module")
def replicated():
    """{case: (image, ids, occ, grads)}: the port's replicated clustered
    render of the renumbered scene, its records and render_and_grad."""
    out = {}
    for name in CASES:
        scene, cfg, plan = _case(name)
        scene2, tri_ids2 = renumber_by_clusters(scene, plan.tri_ids)
        img = TTV.render_rows_clustered(scene2, cfg, tri_ids2, 0, cfg.height)
        packed = PC.pack_clusters(scene2, tri_ids2)
        ids, occ = TTV.records_rows(scene2, cfg, packed, 0, cfg.height)
        (_, _), g = tpurt_torch.render_and_grad(
            scene2, _sq, cfg, plan=RenderPlan(kind="clusters", tri_ids=tri_ids2))
        out[name] = (img, ids, occ, _grads(g))
    return out


WORLD_CASE_IDS = [(n, name) for n, names in WORLD_CASES.items() for name in names]


@pytest.mark.parametrize("n,name", WORLD_CASE_IDS)
def test_ring_image_equals_the_replicated_render(worlds, replicated, n, name):
    """Bit for bit, on every rank, against render_rows_clustered of the
    renumbered scene."""
    for rank, r in enumerate(worlds[n]):
        assert torch.equal(r[name]["image"], replicated[name][0]), (n, name, rank)


@pytest.mark.parametrize("n,name", WORLD_CASE_IDS)
def test_ring_records_equal_the_replicated_records(worlds, replicated, n, name):
    """ids and occlusion bits of each rank's window against records_rows of
    the whole frame (the in-kernel shadows of the plain versions, which
    compute any-hit as the ring's K7 does)."""
    _, _, w, *_ = CASES[name]
    _, ids, occ, _ = replicated[name]
    for r in worlds[n]:
        lo, hi = r[name]["rows"]
        cols = slice(lo * w, hi * w)
        assert torch.equal(r[name]["ids"], ids[:, cols]), (n, name, lo, hi)
        assert torch.equal(r[name]["occ"], occ[:, cols]), (n, name, lo, hi)
    assert int((ids >= 0).sum()) > 0 and int((occ > 0).sum()) > 0


@pytest.mark.parametrize("n,name", WORLD_CASE_IDS)
def test_ring_grads_match_render_and_grad(worlds, replicated, n, name):
    """tpurt's bar on the light, the spheres and the vertices; the port's
    bar on every other float leaf."""
    want = replicated[name][3]
    got = worlds[n][0][name]["grads"][0]
    assert got.keys() == want.keys()
    for k, a in want.items():
        b = got[k]
        assert torch.isfinite(b).all(), k
        top = float(a.abs().max())
        if k in TPURT_LEAVES:
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=TPURT_RTOL,
                                       atol=TPURT_ATOL * max(1.0, top), err_msg=k)
        else:
            torch.testing.assert_close(b, a, rtol=0, atol=GRAD_RTOL * top + 1e-12, msg=k)
    assert float(got["vertices"].abs().max()) > 0.0


@pytest.mark.parametrize("n,name", WORLD_CASE_IDS)
def test_ring_grads_repeat_bit_for_bit_on_every_rank(worlds, n, name):
    first = worlds[n][0][name]["grads"][0]
    for r in worlds[n]:
        for run in r[name]["grads"]:
            for k, v in run.items():
                assert torch.equal(v, first[k]), (n, name, k)


@pytest.mark.parametrize("n,name", WORLD_CASE_IDS)
def test_every_rank_takes_every_ring_step(worlds, n, name):
    """The same rotations on every rank, an empty window included: per
    bounce and shadow pass n shifts, and the shading slice's n − 1; world 1
    shifts nothing.  The traversal runs the kernel's modes 1 and 2 (their
    plain versions here), never mode 0."""
    shifts = {r[name]["shifts"] for r in worlds[n]}
    assert len(shifts) == 1
    shifts = shifts.pop()
    if n == 1:
        assert shifts == 0
    else:   # two passes at depth 0 (closest hit, shadows) at least
        assert shifts >= 3 * n - 1 and (shifts - (n - 1)) % n == 0, shifts
    for r in worlds[n]:
        launched = r[name]["launches"]
        assert "trace_records_reference" not in launched
        assert set(launched) <= {"trace_bounce_reference", "trace_shadows_reference"}
    assert any(r[name]["launches"].get("trace_bounce_reference") for r in worlds[n])


def test_empty_rank_joins_the_ring(worlds):
    """Config 4 at 3 rows over 4 ranks: rank 3 owns no pixel, sends dead
    rays, and still rotates its slice and carries the others' cotangents."""
    r3 = worlds[4][3]["c4-empty"]
    assert r3["rows"] == (3, 3) and r3["ids"].shape == (1, 0)
    assert r3["shifts"] == worlds[4][0]["c4-empty"]["shifts"] > 0


def test_ring_train_step_lowers_the_loss(worlds):
    losses = worlds[2][0]["train"]
    assert worlds[2][1]["train"] == losses
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_ring_shift_sends_to_the_next_rank_and_back(worlds):
    for rank, r in enumerate(worlds[2]):
        there, back = r["shift"]
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        assert torch.equal(there, x + 10 * (1 - rank))
        assert torch.equal(back, x + 10 * rank)


@pytest.mark.parametrize("name,n", [("c4", 2), ("c4", 4), ("c3", 2), ("c3", 4)])
def test_host_parts_equal_tpurt(name, n):
    """renumber_by_clusters and shard_scene_clusters against tpurt's on the
    same scene and cluster topology."""
    import jax.numpy as jnp

    from tpurt.dist import scene_shard as JSH
    from tpurt.scene import configs as jconfigs

    k, h, w, _, _, kw = CASES[name]
    scene, _, plan = _case(name)
    js, _ = jconfigs.ALL_CONFIGS[k](h, w, **kw)
    np.testing.assert_array_equal(np.asarray(js.triangles), scene.triangles.numpy())
    tri_ids = plan.tri_ids.numpy()
    js2, jt2 = JSH.renumber_by_clusters(js, jnp.asarray(tri_ids))
    scene2, t2 = renumber_by_clusters(scene, plan.tri_ids)
    np.testing.assert_array_equal(np.asarray(jt2), t2.numpy())
    np.testing.assert_array_equal(np.asarray(js2.triangles), scene2.triangles.numpy())
    np.testing.assert_array_equal(np.asarray(js2.tri_mat), scene2.tri_mat.numpy())
    want = JSH.shard_scene_clusters(js2, jt2, n)
    got = SSH.shard_scene_clusters(scene2, t2, n)
    for a, b in zip(want[:-1], got[:-1]):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert want[-1] == got[-1]
    # renumbering twice is the identity
    again, t3 = renumber_by_clusters(scene2, t2)
    assert torch.equal(again.triangles, scene2.triangles) and torch.equal(t3, t2)


def _packed_bytes(packed):
    """Bytes of the packing that scale with the clusters, and of the rest."""
    per_cluster = sum(t.numel() * t.element_size() for t in (
        packed.tri_forms, packed.tri_attrs, packed.aabb_lo, packed.aabb_hi, packed.boxes,
        packed.children, packed.wide_boxes, packed.wide_children, packed.group_boxes))
    fixed = sum(t.numel() * t.element_size()
                for t in (packed.sph_forms, packed.sph_attrs, packed.globals))
    return per_cluster, fixed


@pytest.mark.parametrize("name,n", [("c4", 2), ("c4", 4), ("c3", 4), ("c5", 2)])
def test_shard_bytes_and_forms(name, n):
    """tests/test_dist.py:134-144's bounds; a rank's packed clusters at most
    1/n of the replicated packing's plus one cluster's; and each shard's
    triangle forms equal the replicated packing's bit for bit (a triangle's
    forms depend only on its three vertices), on which the ring's bit
    equality rests."""
    scene, _, plan = _case(name)
    scene2, parts = prepare_scene_sharded(scene, plan.tri_ids, n)
    tloc, tri_sh, cnts, widx, T_global = (parts.tloc, parts.tri_sh, parts.cnts, parts.widx,
                                          parts.T_global)
    n_clusters = plan.tri_ids.shape[0]
    assert T_global == scene.n_tris
    assert tloc.shape[1] == -(-n_clusters // n)
    assert tri_sh.shape[1] <= -(-scene.n_tris // n) + 128
    assert int(cnts.sum()) == scene.n_tris
    assert int(tri_sh.max()) < widx.shape[1] and int(tri_sh.min()) >= 0
    assert torch.equal(parts.tri_ids, renumber_by_clusters(scene, plan.tri_ids)[1])
    whole = PC.pack_clusters(scene2, parts.tri_ids)
    rep, fixed = _packed_bytes(whole)
    one_cluster = rep / n_clusters
    slot_of = torch.zeros(scene.n_tris, dtype=torch.long)
    slot_of[whole.tri_attrs[:, PC.R_GID].long()] = torch.arange(whole.n_slots)
    for r in range(n):
        mesh = Mesh(rank=r, size=n, device=torch.device("cpu"), backend="gloo")
        res = SSH._resident(scene2, parts, mesh)
        loc, loc_fixed = _packed_bytes(res.packed)
        assert loc_fixed == fixed and loc <= rep / n + one_cluster, (r, loc, rep)
        gid = res.packed.tri_attrs[:, PC.R_GID].long() + res.t0
        assert torch.equal(res.packed.tri_forms, whole.tri_forms[slot_of[gid]]), r


def test_render_scene_sharded_renumbers_first(tmp_path):
    """World 1 in this process: render_scene_sharded equals the replicated
    render of the renumbered scene, and the ring train step refuses a mesh
    that is not a Mesh; parts cut for another world size raise."""
    import torch.distributed as dist

    from tpurt_torch.dist import init_ranks, make_mesh

    scene, cfg, plan = _case("c4")
    scene2, tri_ids2 = renumber_by_clusters(scene, plan.tri_ids)
    init_ranks("gloo", 0, 1, dist.FileStore(str(tmp_path / "store"), 1))
    try:
        mesh = make_mesh("cpu")
        img = render_scene_sharded(scene, cfg, plan.tri_ids, mesh)
    finally:
        dist.destroy_process_group()
    assert torch.equal(img, TTV.render_rows_clustered(scene2, cfg, tri_ids2, 0, cfg.height))
    _, parts = prepare_scene_sharded(scene, plan.tri_ids, 2)
    with pytest.raises(ValueError, match="cut 2 shards for a mesh of 1"):
        render_scene_sharded_prepared(scene2, cfg, parts, mesh)
    with pytest.raises(TypeError, match="Mesh"):
        make_ring_train_step(cfg, object(), parts)


def test_cli_render_scene_shard_writes_the_renumbered_render(tmp_path):
    """render --scene-shard 2 --backend gloo on config 3, whose own plan is
    phase-1 (so the command plans clusters with accel="bvh"): two spawned
    ranks, rank 0 writes the PNG and prints tpurt's JSON line with plan
    "ring-2"; the PNG equals render() of the renumbered scene on that
    plan."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    from tpurt_torch.utils import load_png, save_png

    out, ref = tmp_path / "ring.png", tmp_path / "ref.png"
    proc = subprocess.run(
        [sys.executable, "-m", "tpurt_torch.cli", "render", "--config", "3", "--res", "12x16",
         "--scene-shard", "2", "--backend", "gloo", "--device", "cpu", "--out", str(out)],
        cwd=Path(__file__).resolve().parents[1], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.splitlines()[-1])
    assert (line["plan"], line["h"], line["w"], line["out"]) == ("ring-2", 12, 16, str(out))
    scene, cfg = configs.config3_spheres(12, 16, device="cpu")
    plan = tpurt_torch.prepare(scene, cfg, accel="bvh")
    scene2, _ = renumber_by_clusters(scene, plan.tri_ids)
    save_png(ref, tpurt_torch.render(scene2, cfg, plan=tpurt_torch.prepare(scene2, cfg,
                                                                        accel="bvh")))
    np.testing.assert_array_equal(load_png(out, np.uint8), load_png(ref, np.uint8))
