"""The two routes of deferred shading on the CPU: the rule that sends a call
to K11 (kernels/shade.py) or to the PyTorch replay, the replay's gradients
under render_and_grad, the counters ``shade.pixels`` and ``shade.fused``,
and the checks of K11's wrapper.  The kernel itself runs only on a card
(tests/test_torch_cuda.py holds it to the replay there)."""
import dataclasses
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpurt_torch
from tpurt_torch import trace
from tpurt_torch.core import geom
from tpurt_torch.kernels import shade as SH
from tpurt_torch.kernels import traversal as TV
from tpurt_torch.kernels.megakernel import scene_float_leaves
from tpurt_torch.kernels.packc import pack_clusters
from tpurt_torch.scene import configs
from tpurt_torch.shading import deferred as TD

import torch_one_thread  # noqa: F401  (one PyTorch thread)

H, W = 24, 24


@pytest.fixture(scope="module")
def case():
    """Config 3 through its clusters plan (spheres, a floor, depth 2): the
    scene, config, plan, records and rays of a small frame."""
    scene, cfg = configs.config3_spheres(H, W, device="cpu")
    plan = tpurt_torch.prepare(scene, cfg, accel="bvh")
    packed = pack_clusters(scene, plan.tri_ids, plan.tree)
    ids, occ = TV.records_rows(scene, cfg, packed, 0, H)
    recs = TD.records_from_ids(ids, occ, scene.n_tris)
    o, d = geom.generate_rays(scene.camera, H, W)
    return scene, cfg, plan, recs, o.reshape(-1, 3), d.reshape(-1, 3)


def _on_card(requires_grad=False):
    """A stand-in for rays on a card: what takes_kernel reads of them."""
    return types.SimpleNamespace(is_cuda=True, requires_grad=requires_grad)


def _with_live_kd(scene):
    kd = scene.materials.kd.clone().requires_grad_(True)
    return dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, kd=kd))


#: (rays, scene, corner_fn, grad mode) of a call -> whether K11 takes it
ROUTES = {
    "card, no grad mode": (lambda c, s: (_on_card(), s, None, False), True),
    "card, grad mode, no leaf live": (lambda c, s: (_on_card(), s, None, True), True),
    "card, a live leaf, no grad mode": (lambda c, s: (_on_card(), _with_live_kd(s), None,
                                                      False), True),
    "card, a live leaf": (lambda c, s: (_on_card(), _with_live_kd(s), None, True), False),
    "card, live rays": (lambda c, s: (_on_card(True), s, None, True), False),
    "card, corner_fn": (lambda c, s: (_on_card(), s, lambda p, t: None, False), False),
    "cpu, no grad mode": (lambda c, s: (c, s, None, False), False),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_takes_kernel_only_on_a_card_without_gradients(case, name):
    scene, _, _, _, o, _ = case
    make, want = ROUTES[name]
    rays, sc, corner_fn, grad = make(o, scene)
    with torch.set_grad_enabled(grad):
        assert TD.takes_kernel(sc, rays, rays, corner_fn) is want


def test_wants_grad_reads_every_leaf_the_shading_reads(case):
    scene = case[0]
    leaves = TD.shading_leaves(scene)
    floats = [t for _, t in scene_float_leaves(scene)]
    # every float leaf but the camera's, which reaches the shading through o, d
    assert len(leaves) == len(floats) - 4
    assert all(any(t is f for f in floats) for t in leaves)
    o = case[4]
    for k in range(len(leaves)):
        live = [t.clone().requires_grad_(j == k) for j, t in enumerate(leaves)]
        sc = dataclasses.replace(
            scene, vertices=live[0], vnormals=live[1], uvs=live[2], sph_center=live[3],
            sph_radius=live[4], textures=live[10], light_pos=live[11], light_color=live[12],
            ambient=live[13], materials=dataclasses.replace(
                scene.materials, ka=live[5], kd=live[6], ks=live[7], shininess=live[8],
                reflectivity=live[9]))
        assert TD.wants_grad(sc, o, o), k


#: scene -> the float leaves that do not move its image: config 3 is flat and
#: untextured; config 5 has no sphere but the pad, and no material reflects
GRAD_SCENES = {
    "config3": (lambda: configs.config3_spheres(H, W, device="cpu"),
                {("vnormals",), ("uvs",), ("textures",)}),
    "config5": (lambda: configs.config5_multimesh(H, 32, n_blobs=2, subdiv=2, device="cpu"),
                {("sph_center",), ("sph_radius",), ("materials", "reflectivity")}),
}


def test_the_grad_scenes_move_every_leaf_between_them():
    still = [fixed for _, fixed in GRAD_SCENES.values()]
    assert not set.intersection(*still)


@pytest.mark.parametrize("name", list(GRAD_SCENES))
def test_render_and_grad_differentiates_every_leaf_through_the_replay(name, monkeypatch):
    make, still = GRAD_SCENES[name]
    scene, cfg = make()
    plan = tpurt_torch.prepare(scene, cfg, accel="bvh")
    assert plan.kind == "clusters"
    calls = []
    replay = TD._shade_bundle

    def spy(*args, **kw):
        calls.append(torch.is_grad_enabled())
        return replay(*args, **kw)

    monkeypatch.setattr(TD, "_shade_bundle", spy)
    _, grads = tpurt_torch.render_and_grad(scene, lambda im: (im ** 2).sum(), cfg, plan=plan)
    assert calls == [True]
    got = dict(scene_float_leaves(grads))
    for path, leaf in scene_float_leaves(scene):
        g = got[path]
        assert g.shape == leaf.shape and torch.isfinite(g).all(), path
        assert (float(g.abs().max()) > 0) == (path not in still), path


@pytest.mark.parametrize("traced", [False, True])
def test_shade_counters_count_only_while_a_profiler_records(case, traced):
    scene, cfg, _, recs, o, d = case
    assert {"shade.pixels", "shade.fused"} <= set(trace.COUNTERS)
    trace.reset()
    try:
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                TD.shade_from_records(scene, o, d, recs, cfg.max_depth, cfg.shadows)
        else:
            TD.shade_from_records(scene, o, d, recs, cfg.max_depth, cfg.shadows)
        counts = trace.snapshot()
    finally:
        trace.reset()
    # on the CPU every pixel takes the replay
    assert counts["shade.pixels"] == (H * W if traced else 0)
    assert counts["shade.fused"] == 0


def _bad_inputs(case, what):
    scene, cfg, _, recs, o, d = case
    args = dict(scene=scene, o=o, d=d, prim=recs.prim, is_tri=recs.is_tri, occ=recs.occ,
                max_depth=cfg.max_depth, shadows=cfg.shadows)
    if what == "o float64":
        args["o"] = o.double()
    elif what == "prim int64":
        args["prim"] = recs.prim.long()
    elif what == "is_tri int32":
        args["is_tri"] = recs.is_tri.int()
    elif what == "kd float64":
        args["scene"] = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, kd=scene.materials.kd.double()))
    elif what == "d transposed":
        args["d"] = d.t().contiguous().t()
    elif what == "too few depths":
        args["max_depth"] = recs.prim.shape[0]
    return args


@pytest.mark.parametrize("what,error,match", [
    ("cpu", ValueError, "on a card"),
    ("o float64", TypeError, "o must be torch.float32"),
    ("prim int64", TypeError, "prim must be torch.int32"),
    ("is_tri int32", TypeError, "is_tri must be torch.bool"),
    ("kd float64", TypeError, "kd must be torch.float32"),
    ("d transposed", ValueError, "d must be contiguous"),
    ("too few depths", ValueError, "depths of records"),
])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case, what, error, match):
    before = SH.LAUNCHES
    with pytest.raises(error, match=match):
        SH.shade_records_cuda(**_bad_inputs(case, what))
    assert SH.LAUNCHES == before
