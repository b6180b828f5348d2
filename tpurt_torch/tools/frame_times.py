"""Time the clustered render path on an NVIDIA card: ms a frame of
``tpurt_torch.render`` on config 4 at 1024×1024 and config 5 at 1080×1920,
and of ``render_and_grad`` with an L2 loss where asked.

    python3 -m tpurt_torch.tools.frame_times [--grad] [--frames N]

Host clock around each call up to ``torch.cuda.synchronize()`` (median and
p90), and the device time of all kernels of a call (torch.profiler).  To
compare two checkouts on one card, run this file by its path with PYTHONPATH
at the other checkout, in turns on the same machine: host-clock times move by
a quarter from one machine or hour to another.
"""
from __future__ import annotations

import argparse
import math
import statistics
import subprocess
import time

import torch

import tpurt_torch
from tpurt_torch.scene import configs


def host_ms(fn, iters, warm=3):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return sorted(out)


def device_busy_ms(fn, iters=5):
    """(device ms of all kernels, kernels launched) of one fn()."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if "CUDA" in str(getattr(e, "device_type", ""))]
    return (sum(e.self_device_time_total for e in events) / iters / 1e3,
            sum(e.count for e in events) / iters)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grad", action="store_true", help="also time render_and_grad (L2 loss)")
    ap.add_argument("--frames", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this tool times a card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0])
    print(f"package: {tpurt_torch.__file__}")
    for name, (scene, cfg) in (("config 4 at 1024x1024", configs.config4_bunny(1024, 1024)),
                               ("config 5 at 1080x1920", configs.config5_multimesh(1080, 1920))):
        plan = tpurt_torch.prepare(scene, cfg)
        target = (tpurt_torch.render(scene, cfg, plan=plan) * 0.9).detach()
        calls = {"render": lambda: tpurt_torch.render(scene, cfg, plan=plan)}
        if args.grad:
            calls["render_and_grad"] = lambda: tpurt_torch.render_and_grad(
                scene, lambda im: ((im - target) ** 2).sum(), cfg, plan=plan)
        for what, fn in calls.items():
            ms = host_ms(fn, args.frames)
            busy, count = device_busy_ms(fn)
            print(f"{name}: {what} median {statistics.median(ms):.4f} ms, p90 "
                  f"{ms[math.ceil(len(ms) * 0.9) - 1]:.4f} ms (n={len(ms)}, host clock to "
                  f"synchronize); device {busy:.4f} ms in {count:.0f} launches", flush=True)


if __name__ == "__main__":
    main()
