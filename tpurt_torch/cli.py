"""Command line of the port, the counterpart of ``tpurt/cli.py``:

    python -m tpurt_torch.cli render  --config 3 --res 512x512 --out out.png
    python -m tpurt_torch.cli render  --obj mesh.obj --accel grid --out out.png
    python -m tpurt_torch.cli render  --config 5 --scene-shard 2 --backend gloo --out out.png
    python -m tpurt_torch.cli animate --config 4 --frames 24 --out frame_{:03d}.png
    python -m tpurt_torch.cli animate --config rtiow --res 1080x1920 --frames 24
    python -m tpurt_torch.cli inverse --config 2 --steps 50 --out recon.png --ckpt s.npz
    python -m tpurt_torch.cli inverse --config 2 --devices 2 --backend gloo
    python -m tpurt_torch.cli multihost-render --coordinator host:port \
        --num-processes 2 --process-id 0 --backend nccl --out out.png
    python -m tpurt_torch.cli bench   --config 3 --res 1080x1920 --mode fwdbwd

Every command runs on the card unless ``--device cpu`` is given, and prints
one JSON line a result.  ``render --scene-shard N`` spawns N ranks that
render on the sharded scene's ring (``dist/scene_shard.py``) over
``--backend``.  ``--profile DIR`` traces the command's work with
``torch.profiler`` into a Chrome trace in DIR, the port's ``tpurt.*`` spans
(``tpurt_torch/trace.py``) beside the card's kernels.  ``multihost-render``
runs one process a host (or a card), each started with its
``--process-id``; process 0 listens at ``--coordinator``.  ``bench`` runs
``tpurt_torch.tools.bench`` (the repo root's ``bench.py`` on the card) with
``tpurt``'s ``bench`` defaults: config 3 at 512x512, forward, 10 chained
iterations.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import tempfile
import time

import torch
import torch.distributed as dist

from tpurt_torch.core.types import RenderConfig
from tpurt_torch.dist.launch import init_ranks, spawn_ranks
from tpurt_torch.dist.scene_shard import prepare_scene_sharded, render_scene_sharded_prepared
from tpurt_torch.dist.shard import make_mesh, render_sharded
from tpurt_torch.dist.train import make_train_step
from tpurt_torch.render import prepare, render
from tpurt_torch.scene import configs
from tpurt_torch.scene.obj import scene_from_obj
from tpurt_torch.scene.scene import Camera
from tpurt_torch.tools import bench
from tpurt_torch.utils import save_png, save_pytree


def _config_key(s):
    """A ``--config`` value: the number of one of tpurt's configs, or the
    name of one of the port's own (``configs.ALL_CONFIGS``)."""
    return int(s) if s.isdigit() else s


def _parse_res(s):
    h, w = s.split("x")
    return int(h), int(w)


def _build_scene(args):
    h, w = _parse_res(args.res)
    if args.obj:
        return scene_from_obj(args.obj, device=args.device), RenderConfig(height=h, width=w)
    return configs.ALL_CONFIGS[args.config](h, w, device=args.device)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def _maybe_profile(dirname, device, name):
    """Trace the block with torch.profiler (the card's kernels too when the
    command runs on one) into DIR/<name>.json, a Chrome trace."""
    if not dirname:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(dirname, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(dirname, f"{name}.json"))


def _ring_render_rank(mesh, args):
    """One rank of ``render --scene-shard``: the scene renumbered and cut into
    the mesh's shards, the frame rendered on the ring; rank 0 writes the PNG.
    Returns the frame's seconds."""
    args.device = str(mesh.device)
    scene, cfg = _build_scene(args)
    if args.depth is not None:
        cfg = cfg.replace(max_depth=args.depth)
    plan = prepare(scene, cfg, accel=args.accel)
    if plan.kind != "clusters":
        plan = prepare(scene, cfg, accel="bvh")
    scene2, parts = prepare_scene_sharded(scene, plan.tri_ids, mesh.size)
    with _maybe_profile(args.profile, args.device, f"render-ring-rank{mesh.rank}"):
        t0 = time.perf_counter()
        img = render_scene_sharded_prepared(scene2, cfg, parts, mesh)
        _sync(args.device)
        dt = time.perf_counter() - t0
    if mesh.rank == 0:
        save_png(args.out, img)
    return dt


def cmd_render(args):
    if args.scene_shard:
        if args.backend is None:
            raise SystemExit("render --scene-shard needs --backend nccl or gloo")
        dt = spawn_ranks(_ring_render_rank, args.scene_shard, args.backend, args,
                         device=torch.device(args.device).type)[0]
        h, w = _parse_res(args.res)
        print(json.dumps({"out": args.out, "h": h, "w": w, "seconds": round(dt, 3),
                          "plan": f"ring-{args.scene_shard}", "device": args.device}))
        return
    scene, cfg = _build_scene(args)
    if args.depth is not None:
        cfg = cfg.replace(max_depth=args.depth)
    plan = prepare(scene, cfg, accel=args.accel)
    with _maybe_profile(args.profile, args.device, "render"):
        t0 = time.perf_counter()
        img = render(scene, cfg, plan=plan)
        _sync(args.device)
        dt = time.perf_counter() - t0
    save_png(args.out, img)
    print(json.dumps({"out": args.out, "h": cfg.height, "w": cfg.width,
                      "seconds": round(dt, 3), "plan": plan.kind, "device": args.device}))


def _inverse_run(args, mesh=None):
    """The inverse loop on this process's device, over `mesh` when given;
    returns the losses of the steps printed.  Only the lead process (rank 0,
    or the one process) writes the image and the checkpoint."""
    scene, cfg = _build_scene(args)
    plan = prepare(scene, cfg)
    target = render(scene, cfg, plan=plan)
    # perturb: dim the lights and gray the albedo
    mats = dataclasses.replace(scene.materials, kd=scene.materials.kd * 0.5 + 0.2)
    s = dataclasses.replace(scene, light_color=scene.light_color * 0.6, materials=mats)
    step = make_train_step(cfg, mesh=mesh, plan=plan)
    name = "inverse" if mesh is None else f"inverse-rank{mesh.rank}"
    losses = []
    with _maybe_profile(args.profile, args.device, name):
        for i in range(args.steps):
            s, loss = step(s, target, args.lr)
            if i % 10 == 0 or i == args.steps - 1:
                losses.append((i, float(loss)))
    if mesh is None or mesh.rank == 0:
        if args.out:
            save_png(args.out, render(s, cfg, plan=plan))
        if args.ckpt:
            save_pytree(args.ckpt, s)
    return losses


def _inverse_rank(mesh, args):
    args.device = str(mesh.device)
    return _inverse_run(args, mesh)


def cmd_inverse(args):
    """Inverse rendering: recover perturbed lights and albedos by gradient
    descent on the mean squared error against the scene's own image; with
    ``--devices N`` over N spawned ranks (``--backend``), rows split among
    them and the gradients summed in rank order."""
    if args.devices:
        if args.backend is None:
            raise SystemExit("inverse --devices needs --backend nccl or gloo")
        losses = spawn_ranks(_inverse_rank, args.devices, args.backend, args,
                             device=torch.device(args.device).type)[0]
    else:
        losses = _inverse_run(args)
    for i, loss in losses:
        print(json.dumps({"step": i, "loss": loss}))
    if args.ckpt:
        print(json.dumps({"checkpoint": args.ckpt}))


def cmd_animate(args):
    """Orbit the camera about its look-at point and render a frame each step;
    the plan is built once, only the camera changes."""
    scene, cfg = _build_scene(args)
    plan = prepare(scene, cfg)
    eye0 = scene.camera.eye.tolist()
    look = scene.camera.look_at.tolist()
    radius = math.hypot(eye0[0] - look[0], eye0[2] - look[2])
    phi0 = math.atan2(eye0[2] - look[2], eye0[0] - look[0])
    t0 = time.perf_counter()
    with _maybe_profile(args.profile, args.device, "animate"):
        for f in range(args.frames):
            phi = phi0 + math.radians(args.orbit) * f / max(args.frames, 1)
            eye = (look[0] + radius * math.cos(phi), eye0[1], look[2] + radius * math.sin(phi))
            cam = Camera.make(eye, look, fov_y=float(scene.camera.fov_y), device=args.device)
            save_png(args.out.format(f), render(dataclasses.replace(scene, camera=cam), cfg,
                                                plan=plan))
    dt = time.perf_counter() - t0
    print(json.dumps({"frames": args.frames, "seconds": round(dt, 2),
                      "fps": round(args.frames / dt, 2)}))


def cmd_multihost_render(args):
    """Render over every process of the job: each runs this same command with
    its own ``--process-id`` (one a host, or one a card), renders its rows
    and gathers the image; process 0 saves the PNG and prints the result.
    Without ``--coordinator`` the job is this one process."""
    if not args.coordinator and args.num_processes != 1:
        raise SystemExit("multihost-render over several processes needs --coordinator")
    with tempfile.TemporaryDirectory(prefix="tpurt_store_") as tmp:
        where = (f"tcp://{args.coordinator}" if args.coordinator
                 else dist.FileStore(os.path.join(tmp, "store"), 1))
        init_ranks(args.backend, args.process_id, args.num_processes, where)
        try:
            mesh = make_mesh(torch.device(args.device).type)
            args.device = str(mesh.device)
            scene, cfg = _build_scene(args)
            plan = prepare(scene, cfg)
            with _maybe_profile(args.profile, args.device, f"multihost-render-{mesh.rank}"):
                img = render_sharded(scene, cfg, mesh, plan=plan)
            if mesh.rank == 0:
                save_png(args.out, img)
                print(json.dumps({"out": args.out, "devices": mesh.size}))
        finally:
            dist.destroy_process_group()


def cmd_bench(args):
    """The benchmark harness (tools/bench.py) with this command's config,
    resolution, mode, iterations and device, as ``tpurt``'s ``bench`` hands
    them to ``bench.py``."""
    if args.obj or args.profile:
        raise SystemExit("bench takes a --config, not --obj or --profile")
    if not isinstance(args.config, int):
        raise SystemExit(f"bench takes one of tpurt's configs 1-5, not {args.config!r}")
    bench.main(["--config", str(args.config), "--res", args.res, "--mode", args.mode,
                "--iters", str(args.iters), "--device", args.device])


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpurt_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--config", type=_config_key, default=3, choices=list(configs.ALL_CONFIGS))
        sp.add_argument("--obj", type=str, default=None)
        sp.add_argument("--res", type=str, default="512x512")
        sp.add_argument("--device", type=str, default="cuda")
        sp.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="write a torch.profiler Chrome trace of the work to DIR")

    sp = sub.add_parser("render")
    common(sp)
    sp.add_argument("--out", type=str, default="out.png")
    sp.add_argument("--depth", type=int, default=None)
    sp.add_argument("--accel", type=str, default="auto", choices=["auto", "bvh", "grid"])
    sp.add_argument("--scene-shard", type=int, default=0, metavar="N",
                    help="spawn N ranks and shard the scene (clusters, triangle and "
                    "vertex rows) over them, rays passed around a ring")
    sp.add_argument("--backend", type=str, default=None, choices=["nccl", "gloo"],
                    help="the ring's backend of --scene-shard")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("inverse")
    common(sp)
    sp.add_argument("--steps", type=int, default=50)
    sp.add_argument("--lr", type=float, default=0.5)
    sp.add_argument("--devices", type=int, default=0,
                    help="run the step over N spawned ranks on this host")
    sp.add_argument("--backend", type=str, default=None, choices=["nccl", "gloo"],
                    help="the collectives' backend of --devices")
    sp.add_argument("--out", type=str, default=None)
    sp.add_argument("--ckpt", type=str, default=None)
    sp.set_defaults(fn=cmd_inverse)

    sp = sub.add_parser("animate")
    common(sp)
    sp.add_argument("--frames", type=int, default=24)
    sp.add_argument("--orbit", type=float, default=360.0,
                    help="total camera orbit in degrees")
    sp.add_argument("--out", type=str, default="frame_{:03d}.png")
    sp.set_defaults(fn=cmd_animate)

    sp = sub.add_parser("bench")
    common(sp)
    sp.add_argument("--mode", type=str, default="fwd", choices=["fwd", "fwdbwd"])
    sp.add_argument("--iters", type=int, default=10)
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("multihost-render")
    common(sp)
    sp.add_argument("--out", type=str, default="out.png")
    sp.add_argument("--coordinator", type=str, default=None, metavar="HOST:PORT",
                    help="where process 0 listens; every process names the same")
    sp.add_argument("--num-processes", type=int, default=1)
    sp.add_argument("--process-id", type=int, default=0)
    sp.add_argument("--backend", type=str, default="nccl", choices=["nccl", "gloo"])
    sp.set_defaults(fn=cmd_multihost_render)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
