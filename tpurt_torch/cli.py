"""Command line of the port, the counterpart of ``tpurt/cli.py``:

    python -m tpurt_torch.cli render  --config 3 --res 512x512 --out out.png
    python -m tpurt_torch.cli render  --obj mesh.obj --accel grid --out out.png
    python -m tpurt_torch.cli animate --config 4 --frames 24 --out frame_{:03d}.png
    python -m tpurt_torch.cli inverse --config 2 --steps 50 --out recon.png --ckpt s.npz

Every command runs on the card unless ``--device cpu`` is given, and prints
one JSON line a result.  ``bench`` and ``multihost-render`` are not ported
yet (ROADMAP.md, Queue 1 items 5 and 6) and raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import torch

from tpurt_torch.core.types import RenderConfig
from tpurt_torch.dist.train import make_train_step
from tpurt_torch.render import prepare, render
from tpurt_torch.scene import configs
from tpurt_torch.scene.obj import scene_from_obj
from tpurt_torch.scene.scene import Camera
from tpurt_torch.utils import save_png, save_pytree


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


def cmd_render(args):
    scene, cfg = _build_scene(args)
    if args.depth is not None:
        cfg = cfg.replace(max_depth=args.depth)
    plan = prepare(scene, cfg, accel=args.accel)
    t0 = time.perf_counter()
    img = render(scene, cfg, plan=plan)
    _sync(args.device)
    dt = time.perf_counter() - t0
    save_png(args.out, img)
    print(json.dumps({"out": args.out, "h": cfg.height, "w": cfg.width,
                      "seconds": round(dt, 3), "plan": plan.kind, "device": args.device}))


def cmd_inverse(args):
    """Inverse rendering: recover perturbed lights and albedos by gradient
    descent on the mean squared error against the scene's own image."""
    scene, cfg = _build_scene(args)
    plan = prepare(scene, cfg)
    target = render(scene, cfg, plan=plan)
    # perturb: dim the lights and gray the albedo
    mats = dataclasses.replace(scene.materials, kd=scene.materials.kd * 0.5 + 0.2)
    s = dataclasses.replace(scene, light_color=scene.light_color * 0.6, materials=mats)
    step = make_train_step(cfg, plan=plan)
    for i in range(args.steps):
        s, loss = step(s, target, args.lr)
        if i % 10 == 0 or i == args.steps - 1:
            print(json.dumps({"step": i, "loss": float(loss)}))
    if args.out:
        save_png(args.out, render(s, cfg, plan=plan))
    if args.ckpt:
        save_pytree(args.ckpt, s)
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
    for f in range(args.frames):
        phi = phi0 + math.radians(args.orbit) * f / max(args.frames, 1)
        eye = (look[0] + radius * math.cos(phi), eye0[1], look[2] + radius * math.sin(phi))
        cam = Camera.make(eye, look, fov_y=float(scene.camera.fov_y), device=args.device)
        save_png(args.out.format(f), render(dataclasses.replace(scene, camera=cam), cfg,
                                            plan=plan))
    dt = time.perf_counter() - t0
    print(json.dumps({"frames": args.frames, "seconds": round(dt, 2),
                      "fps": round(args.frames / dt, 2)}))


def _not_ported(item, what):
    def cmd(args):
        raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md, Queue 1 item {item})")
    return cmd


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpurt_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--config", type=int, default=3, choices=[1, 2, 3, 4, 5])
        sp.add_argument("--obj", type=str, default=None)
        sp.add_argument("--res", type=str, default="512x512")
        sp.add_argument("--device", type=str, default="cuda")

    sp = sub.add_parser("render")
    common(sp)
    sp.add_argument("--out", type=str, default="out.png")
    sp.add_argument("--depth", type=int, default=None)
    sp.add_argument("--accel", type=str, default="auto", choices=["auto", "bvh", "grid"])
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("inverse")
    common(sp)
    sp.add_argument("--steps", type=int, default=50)
    sp.add_argument("--lr", type=float, default=0.5)
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
    sp.set_defaults(fn=_not_ported(5, "the benchmark command"))

    sp = sub.add_parser("multihost-render")
    common(sp)
    sp.set_defaults(fn=_not_ported(6, "rendering across hosts"))

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
