"""The sharded scene and its ring (``tpurt_torch.dist.scene_shard``) on one
card: two ranks over gloo at full width, held to the replicated render of
the renumbered scene, and the cost of the ring.

    python3 -m tpurt_torch.tools.ring_check --backend gloo

Config 4 at 1024×1024 (subdiv 6) and config 5 at 1080×1920 (983,042
triangles, textured), each at its config's max depth with shadows.  The
parent process builds the references on the card:
  - the replicated ``render_rows_clustered`` of the renumbered scene with its
    shadows from the kernel's any-hit mode over the kernel's hit points
    (``traversal.SHADOW_REBIN_MIN_CLUSTERS`` set to 0 here: the route whose
    occlusion the ring computes), and the default route's records;
  - ``render_and_grad`` of the renumbered scene with that L2 loss.
Each rank renders on the ring and takes 3 ring train steps of each config
(L2 against the image of the scene changed as ``TRAIN`` says)
(the main path, alone between the counters' reset and their reading), then
returns its window's records, its gradients twice, its times, the kernels'
modes 1 and 2 against their plain versions on the packets of a ring step
>= 1 (another rank's rays, compacted, with their live count, as the ring
hands them to the kernel; a sample of the live lanes, and every dead lane)
and, on rank 0, the whole image.  Checked:
  - the ring's image equals the K7-route render bit for bit, its ids equal
    both routes', its occlusion bits equal the K7 route's; the lanes where
    they differ from the default (in-kernel) route are counted;
  - the gradients: light, sphere and vertex leaves within tpurt's bar
    (tests/test_dist.py:171-178), every other float leaf within 2e-3 of its
    max|g|; two runs and both ranks bit for bit;
  - the 3 steps lower the loss;
  - K6's ids and K7's bits on every rank's sample equal the plain versions';
  - the ranks launched K6, K7 and K8 and no plain version.
Printed: ms/frame and ms/step (host clock to ``torch.cuda.synchronize``),
the bytes each ring pass sends a rank, and the ring's share of a frame (the
host-clock seconds inside ``shard.ring_shift``).  Any failure raises.
``run`` is ``chip_smoke.py``'s phase 17; the last line of ``main`` is one
JSON object of the numbers printed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import torch

import tpurt_torch
from tpurt_torch.accel import native
from tpurt_torch.dist import scene_shard as SSH
from tpurt_torch.dist import shard
from tpurt_torch.dist.launch import spawn_ranks
from tpurt_torch.dist.train import make_ring_train_step, render_and_grad_scene_sharded
from tpurt_torch.kernels import build
from tpurt_torch.kernels import megakernel as MK
from tpurt_torch.kernels import segsum as SS
from tpurt_torch.kernels import traversal as TV
from tpurt_torch.kernels.packc import pack_clusters
from tpurt_torch.render import RenderPlan
from tpurt_torch.scene import configs

#: (config, height, width, constructor arguments) of each case at full width
FULL = {"config 4": (4, 1024, 1024, {}), "config 5": (5, 1080, 1920, {})}
STEPS = 3
#: each case's L2 target and learning rate.  Config 4: its mesh moved (every
#: vertex but the floor's four corners), as tools/dist_check.py trains it.
#: Config 5: its lights at half strength, and a small rate: the step moves
#: every float leaf, the camera's too, and the textured floor's checks turn
#: a camera step of 1e-2 into a higher loss (on the CPU at 90x160 and
#: 270x480; 3e-4 lowers it)
TRAIN = {"config 4": ("moved", (0.04, 0.02, -0.03), 1.0),
         "config 5": ("dimmed", 0.5, 3e-4)}
GRAD_RTOL = 2e-3              # of each leaf's max|g|: the port's bar
TPURT_LEAVES, TPURT_RTOL, TPURT_ATOL = ("light_color", "sph_center", "vertices"), 1e-4, 1e-5
TIMED = 5                     # timed calls of each measurement
SAMPLE = 4096                 # live lanes of a ring packet the plain versions trace
KERNELS = ("trace_bounce", "trace_shadows", "sorted_segsum")


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def host_ms(fn, dev, iters=TIMED, warm=1):
    """Median host-clock ms of fn() up to a synchronize, after `warm` calls."""
    for _ in range(warm):
        fn()
    _sync(dev)
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def reset_launches():
    for mod in (MK, TV, SS):
        mod.reset_launches()


def launches():
    return {k: n for mod in (MK, TV, SS) for k, n in mod.launches.items() if n}


def cases(dev, n, full=FULL):
    """{name: (renumbered scene, config, its n shards' parts, target)}: each
    config through prepare(accel="bvh") and prepare_scene_sharded, and the
    image of the scene changed as TRAIN says, the target of an L2 loss."""
    out = {}
    for name, (k, h, w, kw) in full.items():
        scene, cfg = configs.ALL_CONFIGS[k](h, w, device=dev, **kw)
        plan = tpurt_torch.prepare(scene, cfg, accel="bvh")
        if plan.kind != "clusters":
            raise RuntimeError(f"{name} planned as {plan.kind}")
        scene2, parts = SSH.prepare_scene_sharded(scene, plan.tri_ids, n)
        kind, how, _ = TRAIN[name]
        if kind == "moved":
            blob = torch.ones((scene2.vertices.shape[0], 1), device=dev)
            blob[-4:] = 0.0
            changed = dataclasses.replace(
                scene2, vertices=scene2.vertices + blob * torch.tensor(how, device=dev))
        else:
            changed = dataclasses.replace(scene2, light_color=scene2.light_color * how)
        target = TV.render_rows_clustered(changed, cfg, parts.tri_ids.to(dev), 0, h).detach()
        out[name] = (scene2, cfg, parts, target)
    return out


def l2(target):
    return lambda img: torch.mean((img - target) ** 2)


def grads_of(g):
    return {".".join(p): t.detach().cpu() for p, t in MK.scene_float_leaves(g)}


def _gap(got, want):
    """(ids off, t off) of a kernel's (ids, t) against its plain version's."""
    ids_off = int((got[0] != want[0]).sum())
    both = (got[0] >= 0) & (got[0] == want[0])
    t_err = float((got[1] - want[1])[both].abs().max()) if bool(both.any()) else 0.0
    return ids_off, t_err


def _sample(n_live, n, dev):
    """n lanes spread evenly over [0, n_live)."""
    return torch.linspace(0, n_live - 1, min(n, n_live), device=dev).long()


def shard_parity(scene2, cfg, parts, mesh, n=SAMPLE):
    """K6 and K7 at the first ring step >= 1 that calls them on this rank's
    shard, against their plain versions on n of the packet's live lanes:
    K6's ids differing and its largest |t| error (closest hit with shadows
    off, as the ring runs it), K7's occlusion bits differing, and the lanes
    at or past the live count that either kernel marked.  A ring render of
    its own: every rank calls it."""
    SSH.tap = {}
    try:
        SSH.ring_records(scene2, cfg, parts, mesh)
        calls = SSH.tap
    finally:
        SSH.tap = None
    out = {}
    if "closest" in calls:
        c = calls["closest"]
        pick = _sample(c["n_live"], n, c["o"].device)
        plain = TV.trace_bounce_reference(c["packed"], cfg, c["o"][pick], c["d"][pick],
                                          c["alive"][pick], shadows=False)
        ids_off, t_err = _gap((c["ids"][pick], c["t"][pick]), (plain[0], plain[2]))
        out.update(k6_rays=int(c["ids"].shape[0]), k6_live=c["n_live"],
                   k6_sample=int(pick.numel()), k6_hits=int((plain[0] >= 0).sum()),
                   k6_ids_off=ids_off, k6_t_err=t_err,
                   k6_dead_set=int((c["ids"][c["n_live"]:] >= 0).sum()))
    if "shadows" in calls:
        c = calls["shadows"]
        pick = _sample(c["n_live"], n, c["p"].device)
        plain, _ = TV.trace_shadows_reference(c["packed"], cfg, c["p"][pick], c["p_off"][pick],
                                              c["alive"][pick])
        out.update(k7_rays=int(c["occ"].shape[0]), k7_live=c["n_live"],
                   k7_sample=int(pick.numel()), k7_occluded=int((plain != 0).sum()),
                   k7_occ_off=int((c["occ"][pick] != plain).sum()),
                   k7_dead_set=int((c["occ"][c["n_live"]:] != 0).sum()))
    return out


def rank_body(mesh, full):
    """Everything one rank does; returns plain CPU values (rank 0 also the
    images)."""
    dev = mesh.device
    cs = cases(dev, mesh.size, full)
    prepared = {name: (scene2, parts) for name, (scene2, _, parts, _) in cs.items()}
    steps = {name: make_ring_train_step(cs[name][1], mesh, parts)
             for name, (_, parts) in prepared.items()}

    # the main path, alone between the counters' reset and their reading
    reset_launches()
    images, losses = {}, {}
    for name, (scene2, parts) in prepared.items():
        cfg, target = cs[name][1], cs[name][3]
        images[name] = SSH.render_scene_sharded_prepared(scene2, cfg, parts, mesh)
        s, losses[name] = scene2, []
        for _ in range(STEPS):
            s, loss = steps[name](s, target, TRAIN[name][2])
            losses[name].append(float(loss))
    _sync(dev)
    counts = launches()

    out = {"rank": mesh.rank, "launches": counts, "losses": losses, "records": {},
           "grads": {}, "varying": {}, "times": {}}
    for name, (scene2, parts) in prepared.items():
        cfg, target = cs[name][1], cs[name][3]
        ids, occ = SSH.ring_records(scene2, cfg, parts, mesh)
        out["records"][name] = (ids.cpu(), occ.cpu(), shard.rank_rows(cfg.height, mesh))
        runs = [grads_of(render_and_grad_scene_sharded(scene2, l2(target), cfg, parts,
                                                       mesh)[1]) for _ in range(2)]
        out["varying"][name] = [k for k in runs[0] if not torch.equal(runs[0][k], runs[1][k])]
        frame_ms = host_ms(lambda: SSH.render_scene_sharded_prepared(scene2, cfg, parts,
                                                                     mesh), dev)
        step_ms = host_ms(lambda: steps[name](scene2, target, TRAIN[name][2]), dev)
        # one frame's ring traffic and the host-clock seconds inside the shifts
        shard.reset_ring_stats()
        _sync(dev)
        t0 = time.perf_counter()
        SSH.render_scene_sharded_prepared(scene2, cfg, parts, mesh)
        _sync(dev)
        one = (time.perf_counter() - t0) * 1e3
        ring = dict(shard.ring_stats)
        P = shard.rows_per_device(cfg.height, mesh.size) * cfg.width
        W = 3 + 3 * scene2.smooth + 2 * scene2.textured
        out["times"][name] = {
            "frame_ms": frame_ms, "step_ms": step_ms, "one_frame_ms": one,
            "ring_ms": ring["seconds"] * 1e3, "ring_share": ring["seconds"] * 1e3 / one,
            "shifts": ring["shifts"], "frame_bytes": ring["bytes"],
            "closest_pass_bytes": mesh.size * P * (4 * SSH._NF + 8),
            "shadow_pass_bytes": mesh.size * P * (4 * 6 + 8),
            "slice_bytes": (mesh.size - 1) * parts.t_max * 3 * W * 4}
        out["grads"][name] = runs[0]
        out.setdefault("parity", {})[name] = shard_parity(scene2, cfg, parts, mesh)
        if mesh.rank == 0:
            out.setdefault("images", {})[name] = images[name].cpu()
    return out


def references(cs):
    """{name: (K7-route image, ids, K7-route occ, default-route occ, default
    image, grads)} of the replicated render of each renumbered scene."""
    out = {}
    for name, (scene2, cfg, parts, target) in cs.items():
        tri_ids2 = parts.tri_ids.to(scene2.vertices.device)
        packed = pack_clusters(scene2, tri_ids2)
        ids_d, occ_d = TV.records_rows(scene2, cfg, packed, 0, cfg.height)
        img_d = TV.render_rows_clustered(scene2, cfg, tri_ids2, 0, cfg.height)
        gate = TV.SHADOW_REBIN_MIN_CLUSTERS
        TV.SHADOW_REBIN_MIN_CLUSTERS = 0      # shadows from K7 at the kernel's hit points
        try:
            ids_k, occ_k = TV.records_rows(scene2, cfg, packed, 0, cfg.height)
            img_k = TV.render_rows_clustered(scene2, cfg, tri_ids2, 0, cfg.height)
        finally:
            TV.SHADOW_REBIN_MIN_CLUSTERS = gate
        if not torch.equal(ids_d, ids_k):
            raise RuntimeError(f"{name}: the two shadow routes' ids differ")
        (_, _), g = tpurt_torch.render_and_grad(
            scene2, l2(target), cfg, plan=RenderPlan(kind="clusters", tri_ids=tri_ids2))
        out[name] = (img_k.cpu(), ids_k.cpu(), occ_k.cpu(), occ_d.cpu(), img_d.cpu(),
                     grads_of(g))
    return out


def grad_gaps(got, want):
    """{leaf: share of the bar used} (<= 1 passes): tpurt's bar on its three
    leaves, the port's on the rest."""
    gaps = {}
    for k, a in want.items():
        b = got[k]
        if not torch.isfinite(b).all():
            raise RuntimeError(f"gradient of {k} is not finite")
        top = float(a.abs().max())
        if k in TPURT_LEAVES:
            allowed = TPURT_ATOL * max(1.0, top) + TPURT_RTOL * a.abs()
        else:
            allowed = torch.full_like(a, GRAD_RTOL * top + 1e-12)
        gaps[k] = float(((b - a).abs() / allowed).max()) if a.numel() else 0.0
    return gaps


def check(results, ref):
    """Hold the ranks' results to the references; returns a record."""
    record = {}
    r0 = results[0]
    for name, (img_k, ids, occ_k, occ_d, img_d, grads) in ref.items():
        img = r0["images"][name]
        if not torch.equal(img, img_k):
            raise RuntimeError(f"{name}: the ring's image differs from the replicated render "
                               f"by {float((img - img_k).abs().max())}")
        flips, occ_off = 0, 0
        for r in results:
            rid, rocc, (lo, hi) = r["records"][name]
            cols = slice(lo * img.shape[1], hi * img.shape[1])
            if not torch.equal(rid, ids[:, cols]):
                raise RuntimeError(f"{name}: rank {r['rank']}'s ids differ")
            if not torch.equal(rocc, occ_k[:, cols]):
                raise RuntimeError(f"{name}: rank {r['rank']}'s occlusion bits differ from "
                                   "K7's at the kernel's hit points")
            occ_off += int((rocc != occ_d[:, cols]).sum())
        flips = int((img != img_d).any(-1).sum())
        for r in results:
            if r["losses"][name] != r0["losses"][name]:
                raise RuntimeError(f"{name}: the ranks' losses differ")
            ls = r["losses"][name]
            if not ls[-1] < ls[0]:
                raise RuntimeError(f"{name}: the ring step did not lower the loss: {ls}")
            if r["varying"][name]:
                raise RuntimeError(f"{name}: rank {r['rank']}'s gradients differ between two "
                                   f"runs: {r['varying'][name]}")
            for k, v in r["grads"][name].items():
                if not torch.equal(v, r0["grads"][name][k]):
                    raise RuntimeError(f"{name}: the ranks' gradients of {k} differ")
        gaps = grad_gaps(r0["grads"][name], grads)
        worst = max(gaps, key=gaps.get)
        if gaps[worst] > 1.0:
            raise RuntimeError(f"{name}: the ring's gradient of {worst} is off by "
                               f"{gaps[worst]:.3g} of its bar")
        for r in results:
            par = r["parity"][name]
            if "k6_live" not in par or "k7_live" not in par:
                raise RuntimeError(f"{name}: rank {r['rank']} traced no ring step >= 1 with "
                                   f"K6 and K7: {par}")
            if any(par[k] for k in ("k6_ids_off", "k6_dead_set", "k7_occ_off", "k7_dead_set")):
                raise RuntimeError(f"{name}: K6 or K7 on rank {r['rank']}'s shard at a ring "
                                   f"step disagrees with its plain version: {par}")
        par = [r["parity"][name] for r in results]
        t = [r["times"][name] for r in results]
        record[name] = {"occ_off_default": occ_off, "pixels_off_default": flips,
                        "grad_share_of_bar": gaps, "parity": par,
                        "losses": r0["losses"][name], "times": t}
        print(f"ring: {name} at {img.shape[0]}x{img.shape[1]} over {len(results)} ranks: "
              f"image bit-equal to the replicated render with K7's shadows, ids equal, "
              f"occlusion bits equal K7's at the kernel's hit points; against the default "
              f"in-kernel shadows {occ_off} occlusion lanes and {flips} pixels differ; "
              f"gradients within their bars (largest share {worst} {gaps[worst]:.3g}), two "
              f"runs and both ranks bit for bit; losses "
              + " -> ".join(f"{x:.6g}" for x in r0["losses"][name])
              + "; at a ring step >= 1, against the plain versions on a sample of the "
              "live lanes: " + "; ".join(
                  f"rank {r['rank']} K6 {p['k6_sample']} of {p['k6_live']} live of "
                  f"{p['k6_rays']} rays ({p['k6_hits']} hit), ids off {p['k6_ids_off']}, |t| "
                  f"err {p['k6_t_err']:.3g}, K7 {p['k7_sample']} of {p['k7_live']} live hit "
                  f"points ({p['k7_occluded']} occluded), bits off {p['k7_occ_off']}; dead "
                  f"lanes set {p['k6_dead_set']}, {p['k7_dead_set']}"
                  for r, p in zip(results, par)), flush=True)
        for r, tr in zip(results, t):
            print(f"ring: {name} rank {r['rank']} (rows {r['records'][name][2]}): "
                  f"{tr['frame_ms']:.4f} ms/frame, {tr['step_ms']:.4f} ms/step (median of "
                  f"{TIMED}); one frame {tr['one_frame_ms']:.4f} ms of which "
                  f"{tr['ring_ms']:.4f} ms in {tr['shifts']} ring shifts (share "
                  f"{tr['ring_share']:.4f}), {tr['frame_bytes']} bytes sent; a closest-hit "
                  f"pass sends {tr['closest_pass_bytes']} bytes, a shadow pass "
                  f"{tr['shadow_pass_bytes']}, the shading slice's rotation "
                  f"{tr['slice_bytes']}", flush=True)
    return record


def run(device, backend, full=FULL):
    """Everything above on `device` ("cuda", or "cpu" with small `full` to
    rehearse: there the plain versions run) → (launches of the main path
    summed over the ranks, the shard parity sample's errors, a record)."""
    t_start = time.perf_counter()
    if device == "cuda":
        build.load()
    native.load()
    dev = "cuda:0" if device == "cuda" else "cpu"
    ref = references(cases(dev, 2, full))
    results = spawn_ranks(rank_body, 2, backend, full, device=device, timeout_s=900)
    record = check(results, ref)
    total = {}
    for r in results:
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    if device == "cuda":
        plain = [k for k in total if k not in KERNELS]
        if plain or any(total.get(k, 0) < 1 for k in KERNELS):
            raise RuntimeError(f"the ring's main path launched {total}")
    pars = [p for v in record.values() for p in v["parity"]]
    errs = {"trace_bounce": max(p["k6_t_err"] for p in pars),
            "trace_shadows": float(max(p["k7_occ_off"] for p in pars))}
    record["seconds"] = time.perf_counter() - t_start
    print(f"ring: main-path launches over both ranks {total}; phase "
          f"{record['seconds']:.1f} s", flush=True)
    return total, errs, record


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", required=True, choices=["nccl", "gloo"],
                    help="the two ranks' backend (one card: gloo)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this tool checks a card")
    total, errs, record = run("cuda", args.backend)
    print(json.dumps({"launches": total, "errs": errs, **record}, default=str))


if __name__ == "__main__":
    main()
