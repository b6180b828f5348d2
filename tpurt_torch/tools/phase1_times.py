"""Time the phase-1 backward kernels on an NVIDIA card: K2 ``megakernel_bwd``,
K3 ``l2_fused`` and K4 ``l2_hand`` at config 3 1080×1920, and the config-3
train step, with the kernels' registers and stack frames from the build.

    python3 -m tpurt_torch.tools.phase1_times [--iters N] [--spheres S]

Kernels: CUDA events around each wrapper call (the kernel and what the
wrapper launches after it: ``reduce_rows``, and on a table beyond the
shared-memory route the records' sort and segment sum), median of N after
two warm-up calls, and whether two calls give the same bits.  With
``--spheres S`` the kernels take config 3 with S small spheres more
(``many_spheres``), a table beyond the shared-memory route, and the step is
not timed.  Step: ``make_train_step``'s step on the host clock up
to ``torch.cuda.synchronize()`` (median and p90 of N), and the device time of
all its kernels and of ``l2_hand`` alone (torch.profiler, mean of 20 steps).
To compare two checkouts on one card, run this file by its path with
PYTHONPATH at the other checkout, in turns on the same machine.  It uses only
entry points that the phase-1 kernels' first version had.  The last line is
one JSON object of the numbers printed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import time

import torch

import tpurt_torch
from tpurt_torch.dist.train import make_train_step
from tpurt_torch.kernels import build
from tpurt_torch.kernels import megabwd as MB
from tpurt_torch.kernels import megakernel as MK
from tpurt_torch.kernels.pack import pack_scene
from tpurt_torch.scene import configs

PHASE1 = ("megakernel_fwd", "megakernel_bwd", "l2_fused", "l2_hand", "reduce_rows")
TABLES = ("globals", "tri_forms", "sph_forms", "attrs")


def ptxas_props(log: str, fragments) -> dict:
    """{entry function: "N registers; S bytes stack frame, ..."} from an
    ``nvcc -Xptxas -v`` log, for the entry functions whose mangled name holds
    one of `fragments`."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            name = name if any(f in name for f in fragments) else None
        elif name and ("stack frame" in line or "Used" in line):
            prop = line.split(":", 1)[-1].strip() if "Used" in line else line.strip()
            out[name] = f"{out[name]}; {prop}" if name in out else prop
    return out


def device_ms(fn, iters, warm=2):
    """Median device ms of fn() between two CUDA events."""
    for _ in range(warm):
        fn()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(iters)]
    for start, end in evs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in evs)


def same_bits(a, b) -> bool:
    """Two wrapper results (sq, cotangents) or (cotangents) hold equal bits."""
    a, b = (a if isinstance(a, tuple) else (None, a)), (b if isinstance(b, tuple) else (None, b))
    return (a[0] is None or torch.equal(a[0], b[0])) and all(
        torch.equal(getattr(a[1], t), getattr(b[1], t)) for t in TABLES)


def many_spheres(h, w, n_small):
    """Config 3 with n_small spheres of radius 0.12 more, on a grid on the
    floor around the three."""
    scene, cfg = configs.config3_spheres(h, w)
    cols = math.ceil(math.sqrt(n_small * 4 / 3))
    k = torch.arange(n_small, device="cuda")
    x = -3.0 + 6.0 * (k % cols) / (cols - 1)
    z = -2.5 + 5.0 * (k // cols) / max(1, (n_small - 1) // cols)
    centre = torch.stack([x, torch.full_like(x, 0.12), z], 1).float()
    scene = dataclasses.replace(
        scene, sph_center=torch.cat([scene.sph_center, centre]),
        sph_radius=torch.cat([scene.sph_radius, torch.full((n_small,), 0.12, device="cuda")]),
        sph_mat=torch.cat([scene.sph_mat, (1 + k % 3).to(scene.sph_mat.dtype)]),
        n_real_spheres=scene.n_spheres + n_small)
    return scene, cfg


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--spheres", type=int, default=0,
                    help="small spheres added to config 3 for the kernels; skips the step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this tool times a card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(f"package: {tpurt_torch.__file__}", flush=True)
    so = build.build()
    log = (so.parent / "nvcc.log").read_text() if (so.parent / "nvcc.log").exists() else ""
    props = ptxas_props(log, PHASE1)
    for name, prop in props.items():
        print(f"build: {name}: {prop}", flush=True)
    result = {"card": card, "package": tpurt_torch.__file__, "ptxas": props}

    h, w = 1080, 1920
    n_pix = h * w
    scene, cfg = (many_spheres(h, w, args.spheres) if args.spheres
                  else configs.config3_spheres(h, w))
    packed = pack_scene(scene)
    case = f"config 3 with {args.spheres} small spheres more" if args.spheres else "config 3"
    result["case"] = {"name": case, "table_floats": MK.table_floats(packed)}
    gen = torch.Generator(device="cpu").manual_seed(0)
    g = (torch.rand((3, n_pix), generator=gen) - 0.5).cuda()
    tgt = torch.rand((3, n_pix), generator=gen).cuda()
    _, occ = MK.megakernel_fwd_cuda(packed, cfg, 0, n_pix)
    calls = {
        "megakernel_bwd": lambda: MK.megakernel_bwd_cuda(packed, cfg, 0, n_pix, occ, g),
        "l2_fused": lambda: MK.l2_fused_cuda(packed, cfg, 0, n_pix, tgt),
        "l2_hand": lambda: MB.hand_l2_cuda(packed, cfg, 0, n_pix, tgt),
    }
    for name, fn in calls.items():
        ms = device_ms(fn, args.iters)
        repeat = same_bits(fn(), fn())
        result[name] = {"ms": ms, "repeats_bit_for_bit": repeat}
        print(f"{case} at {h}x{w} ({MK.table_floats(packed)} floats): {name} {ms:.4f} ms "
              f"(CUDA events, median of {args.iters}); two calls bit-equal: {repeat}",
              flush=True)
    if args.spheres:
        print(json.dumps(result))
        return

    moved, _ = configs.config3_spheres(h, w)
    moved.sph_center = moved.sph_center + torch.tensor([0.1, 0.0, -0.06], device="cuda")
    target = tpurt_torch.render(moved, cfg)
    step = make_train_step(cfg)
    for _ in range(3):
        step(scene, target, 0.1)
    torch.cuda.synchronize()
    ms = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        step(scene, target, 0.1)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    ms.sort()
    from torch.profiler import ProfilerActivity, profile

    iters = 20
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            step(scene, target, 0.1)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if "CUDA" in str(getattr(e, "device_type", ""))]
    busy = sum(e.self_device_time_total for e in events) / iters / 1e3
    hand = sum(e.self_device_time_total for e in events if "l2_hand" in e.key) / iters / 1e3
    count = sum(e.count for e in events) / iters
    result["train_step"] = {"median": statistics.median(ms),
                            "p90": ms[math.ceil(len(ms) * 0.9) - 1],
                            "device": busy, "l2_hand_device": hand, "launches": count}
    print(f"config 3 at {h}x{w}: train step median {statistics.median(ms):.4f} ms, p90 "
          f"{result['train_step']['p90']:.4f} ms (n={len(ms)}, host clock to synchronize); "
          f"device {busy:.4f} ms in {count:.0f} launches, of which l2_hand {hand:.4f} ms "
          f"(torch.profiler, mean of {iters})", flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
