"""The benchmark command of the port: the repo root's ``bench.py`` (what
``tpurt``'s ``cli.py bench`` runs) on the card.  Stdout carries ONE JSON line
with ``bench.py``'s keys; everything else goes to stderr.

    python3 -m tpurt_torch.tools.bench                  # config 3 fwdbwd at 1080x1920
    python3 -m tpurt_torch.tools.bench --config 5 --mode fwd
    python3 -m tpurt_torch.tools.bench --mesh 1 --backend nccl
    python3 -m tpurt_torch.tools.bench --config 4 --scene-shard 2 --backend gloo
    python3 -m tpurt_torch.tools.bench --verify         # tools/verify.py

The routes (``bench.py:427-490``), each on the scene built once a process:
  fwd                  ``render(scene, cfg, plan=plan)``;
  fwdbwd on phase-1    ``megakernel.l2_loss_and_grad(scene, zeros, cfg, hand=True)``:
                       sum(img²) and every gradient in one pass of the
                       hand-adjoint kernel, ``pack_scene`` and its autograd
                       backward included, as in ``tpurt``'s step;
  any other fwdbwd     ``render_and_grad(scene, sum(img²), cfg, plan=plan)``;
  ``--mesh N``         N spawned ranks over ``--backend``: ``render_sharded``,
                       in fwdbwd ``render_and_grad_sharded`` of sum(img²);
  ``--scene-shard N``  N spawned ranks on the sharded scene's ring (a phase-1
                       plan is replaced by a "bvh" one):
                       ``render_scene_sharded_prepared``, in fwdbwd
                       ``render_and_grad_scene_sharded`` of sum(img²).
Over NCCL, N above the cards PyTorch sees exits with 2; gloo may carry
several ranks on one card.

The clock (``bench.py:492-552``): the first call timed alone ("build+first":
the kernels' nvcc build at first use included on one device; the ranks'
kernels are built once before the spawn), ``warmup - 1`` calls more, then
``iters`` calls chained with one synchronize at the end, on the host clock:
host work (the pack and its backward) is part of a call.  With ranks the
clock runs on rank 0 from a barrier before the chain to a synchronize and a
barrier after it.  In fwdbwd the forward is then timed alone the same way,
and the backward is charged with the difference (``grad_mrays_*``).

The ray counts are ``bench.py``'s: ``count_rays`` the nominal H·W·(depth+1)·
(1 + lights), ``count_rays_traced`` what the clustered path traces (the
ring reports the nominal count, as ``bench.py`` does).

On the card a plain version's launch makes the command raise: every route
runs its hand-written kernels (``main`` returns their launch counts, summed
over the ranks, beside the record).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch
import torch.distributed as dist

from tpurt_torch.accel import native
from tpurt_torch.dist.launch import spawn_ranks
from tpurt_torch.dist.scene_shard import prepare_scene_sharded, render_scene_sharded_prepared
from tpurt_torch.dist.shard import render_sharded
from tpurt_torch.dist.train import render_and_grad_scene_sharded, render_and_grad_sharded
from tpurt_torch.kernels import build
from tpurt_torch.kernels import megakernel as MK
from tpurt_torch.kernels import traversal as TV
from tpurt_torch.kernels.packc import pack_clusters
from tpurt_torch.render import cap_depth, prepare, render, render_and_grad
from tpurt_torch.scene import configs
from tpurt_torch.tools.dist_check import card, launches


def count_rays(cfg, scene) -> int:
    """Nominal Whitted ray budget (``bench.py:28-38``): pixels × depths ×
    (1 + shadow rays).  A fixed convention, so that Mrays/s ratios equal
    frame-time ratios."""
    per_bounce = 1 + (scene.n_lights if cfg.shadows else 0)
    return cfg.height * cfg.width * (cfg.max_depth + 1) * per_bounce


@torch.no_grad()
def traced_terms(cfg, scene, plan) -> tuple[list, list]:
    """Hits and live continuations (a hit on a reflective material) at each
    depth of a clusters plan's records, reduced on the device: two host
    lists of max_depth + 1 counts, under the plan's depth cap.  The records
    are the render's own (``traversal.records_rows``: the wavefront loop, or
    the single multi-bounce launch)."""
    cfgc = cap_depth(cfg, plan)
    packed = pack_clusters(scene, plan.tri_ids, plan.tree)
    ids, _ = TV.records_rows(scene, cfgc, packed, 0, cfgc.height)
    hit = ids >= 0
    T = scene.n_tris
    tid = ids.clamp(0, max(T - 1, 0)).long()
    sid = (ids - T).clamp(0, max(scene.n_spheres - 1, 0)).long()
    mat = torch.where(ids < T, scene.tri_mat[tid], scene.sph_mat[sid]).long()
    live = hit & (scene.materials.reflectivity[mat] > 0.0)
    return hit.sum(-1).tolist(), live.sum(-1).tolist()


def count_rays_traced(cfg, scene, plan) -> int:
    """Rays the path traces (``bench.py:41-87``).  Phase-1 and oracle plans
    compute every lane at every depth, so traced == nominal there.  On a
    clusters plan: the pixels (depth-0 closest hits), the live rays entering
    each later bounce, and one shadow ray a light from each hit."""
    if plan.kind != "clusters":
        return count_rays(cfg, scene)
    hits, live = traced_terms(cfg, scene, plan)
    closest = cfg.height * cfg.width + sum(live[:-1])
    shadow = sum(hits) * scene.n_lights if cap_depth(cfg, plan).shadows else 0
    return closest + shadow


def _log(*parts) -> None:
    print("[bench]", *parts, file=sys.stderr, flush=True)


def _res(s: str) -> tuple[int, int]:
    h, w = s.split("x")
    return int(h), int(w)


def _sq_sum(img):
    return (img ** 2).sum()


def _chain(fn, scene, iters, sync, barrier) -> float:
    """Seconds a call of `iters` chained calls, one synchronize at the end."""
    barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(scene)
    sync()
    barrier()
    return (time.perf_counter() - t0) / iters


def _run(mesh, args) -> dict:
    """This process's share of the benchmark: on args.device without a
    mesh, else as one rank of `mesh` on its device.  Builds the scene once,
    times the route, counts the rays; only the lead (rank 0, or the one
    process) logs and counts traced rays."""
    before = launches()
    lead = mesh is None or mesh.rank == 0
    h, w = _res(args.res)
    device = args.device if mesh is None else str(mesh.device)
    scene, cfg = configs.ALL_CONFIGS[args.config](h, w, device=device)
    if args.depth is not None:
        cfg = cfg.replace(max_depth=args.depth)
    if args.no_shadows:
        cfg = cfg.replace(shadows=False)
    if args.no_wavefront:
        cfg = cfg.replace(wavefront=False)
    plan = prepare(scene, cfg)
    if lead:
        _log(f"tris={scene.n_tris} spheres={scene.n_spheres} plan={plan.kind}")

    if args.scene_shard is not None:
        if plan.kind != "clusters":
            plan = prepare(scene, cfg, accel="bvh")
        scene, parts = prepare_scene_sharded(scene, plan.tri_ids, mesh.size)
        if lead:
            _log(f"ring of {mesh.size} ranks over {mesh.backend}")

        def fwd(s):
            return render_scene_sharded_prepared(s, cfg, parts, mesh)

        def step(s):
            return render_and_grad_scene_sharded(s, _sq_sum, cfg, parts, mesh)
    elif mesh is not None:
        if lead:
            _log(f"mesh of {mesh.size} ranks over {mesh.backend}")

        def fwd(s):
            return render_sharded(s, cfg, mesh, plan=plan)

        def step(s):
            return render_and_grad_sharded(s, _sq_sum, cfg, mesh, plan=plan)
    else:
        def fwd(s):
            return render(s, cfg, plan=plan)

        if plan.kind == "phase1":
            # sum(img²) is the L2 loss against a zero target
            zeros = torch.zeros((cfg.height, cfg.width, 3), device=scene.vertices.device)

            def step(s):
                return MK.l2_loss_and_grad(s, zeros, cfg, hand=True)

            if args.mode == "fwdbwd":
                _log("fused phase-1 L2 train kernel (hand adjoint)")
        else:
            def step(s):
                return render_and_grad(s, _sq_sum, cfg, plan=plan)

    dev = scene.vertices.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    barrier = (lambda: None) if mesh is None else dist.barrier
    fn = fwd if args.mode == "fwd" else step
    t0 = time.perf_counter()
    fn(scene)
    sync()
    if lead:
        _log(f"build+first: {time.perf_counter() - t0:.3f} s")
    for _ in range(args.warmup - 1):
        fn(scene)
        sync()
    dt = _chain(fn, scene, args.iters, sync, barrier)
    dt_fwd = None
    if args.mode == "fwdbwd":
        fwd(scene)
        sync()
        dt_fwd = _chain(fwd, scene, args.iters, sync, barrier)
    rays = count_rays(cfg, scene)
    if args.scene_shard is not None:
        # the ring renumbers the scene (plan.tri_ids indexes the original
        # order): the nominal count stands for the traced one, as in bench.py
        traced = rays
    else:
        traced = count_rays_traced(cfg, scene, plan) if lead else None
    after = launches()
    return {"seconds": dt, "seconds_fwd": dt_fwd, "rays": rays, "traced": traced,
            "launches": {k: n - before.get(k, 0) for k, n in after.items()
                         if n != before.get(k, 0)}}


def _positive(s: str) -> int:
    n = int(s)
    if n < 1:
        raise argparse.ArgumentTypeError(f"{n}: a count of ranks is at least 1")
    return n


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python3 -m tpurt_torch.tools.bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=int, default=3,
                    choices=sorted(k for k in configs.ALL_CONFIGS if isinstance(k, int)))
    ap.add_argument("--res", type=str, default="1080x1920")
    ap.add_argument("--mode", type=str, default="fwdbwd", choices=["fwd", "fwdbwd"])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--verify", action="store_true",
                    help="run the verification tier (tools/verify.py) instead")
    ap.add_argument("--depth", type=int, default=None, help="override max_depth")
    ap.add_argument("--no-shadows", action="store_true")
    ap.add_argument("--no-wavefront", action="store_true")
    ap.add_argument("--mesh", type=_positive, default=None, metavar="N",
                    help="render tile-parallel over N spawned ranks (dist.render_sharded)")
    ap.add_argument("--scene-shard", type=_positive, default=None, metavar="N",
                    help="render on the sharded scene's ring of N spawned ranks")
    ap.add_argument("--backend", type=str, default=None, choices=["nccl", "gloo"],
                    help="the ranks' backend of --mesh and --scene-shard")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default), or cpu, where the kernels' plain versions run")
    return ap


def main(argv=None):
    """Run the benchmark, print its JSON line; returns (the record, the
    kernels' and plain versions' launch counts of the run, summed over the
    ranks)."""
    args = parser().parse_args(argv)
    if args.verify:
        from tpurt_torch.tools import verify

        sys.exit(verify.main(["--device", args.device]))
    kind = torch.device(args.device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for, but torch sees no card; "
                           "pass --device cpu to run the plain versions on the CPU")
    h, w = _res(args.res)
    where = args.device + (f" ({card()})" if kind == "cuda" else "")
    _log(f"config={args.config} {h}x{w} mode={args.mode} device={where}")

    world = args.scene_shard if args.scene_shard is not None else args.mesh
    if world is None:
        result = _run(None, args)
        counts = result["launches"]
    else:
        flag = "--scene-shard" if args.scene_shard is not None else "--mesh"
        if args.backend is None:
            raise SystemExit(f"{flag} needs --backend nccl or gloo")
        if args.backend == "nccl" and kind == "cuda" and world > torch.cuda.device_count():
            _log(f"{flag} {world} > {torch.cuda.device_count()} card(s) available to NCCL")
            sys.exit(2)
        # build the kernels and the C++ builders here, not once a rank
        if kind == "cuda":
            build.load()
        native.load()
        results = spawn_ranks(_run, world, args.backend, args, device=kind)
        result = results[0]
        counts = {}
        for r in results:
            for k, n in r["launches"].items():
                counts[k] = counts.get(k, 0) + n
    if kind == "cuda":
        plain = {k: n for k, n in counts.items() if k.endswith("_reference")}
        if plain:
            raise RuntimeError(f"plain versions launched on the card: {plain}")

    dt, rays, traced = result["seconds"], result["rays"], result["traced"]
    _log(f"{dt * 1e3:.4f} ms/frame over {args.iters} chained iters; rays nominal={rays} "
         f"traced={traced}; launches {counts}")
    record = {
        "metric": f"Mrays/s/chip {args.mode} config{args.config} {h}x{w}",
        "value": traced / dt / 1e6,
        "unit": "Mrays/s (traced rays)",
        "vs_baseline": None,
        "mrays_nominal": rays / dt / 1e6,
        "rays_nominal": rays,
        "rays_traced": traced,
        "ms_per_frame": dt * 1e3,
        "mesh": args.mesh,
        "scene_shard": args.scene_shard,
    }
    if args.mode == "fwdbwd":
        dt_f = result["seconds_fwd"]
        dt_b = max(dt - dt_f, 1e-9)
        record.update(ms_per_frame_fwd=dt_f * 1e3, grad_mrays_traced=traced / dt_b / 1e6,
                      grad_mrays_nominal=rays / dt_b / 1e6)
        _log(f"fwd alone {dt_f * 1e3:.4f} ms -> bwd extra {dt_b * 1e3:.4f} ms")
    print(json.dumps(record), flush=True)
    return record, counts


if __name__ == "__main__":
    main(sys.argv[1:])
