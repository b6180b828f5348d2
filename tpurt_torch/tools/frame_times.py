"""Time the clustered render path on an NVIDIA card: the traversal kernel's
launches with their counts, and ms a frame of ``tpurt_torch.render`` on
config 4 at 1024×1024 and config 5 at 1080×1920, and of ``render_and_grad``
with an L2 loss where asked (and of config 4's train step on its clusters
plan).

    python3 -m tpurt_torch.tools.frame_times [--grad] [--frames N]

Kernels: K5 ``trace_records`` on configs 4 and 5, K6 ``trace_bounce`` and K7
``trace_shadows`` on config 5 with one reflective material (the launches of
one frame's wavefront loop, as ``chip_smoke.py:mirror_case``); CUDA events
around each launch, median of N after two warm-up launches, and the counts
of the counting launch.  Where the plan has a slot order, the kernels are
also counted and timed with the slots in the clusters' own order (groups
that are slabs).  Calls: host clock up to ``torch.cuda.synchronize()``
(median and p90), and the device time of all kernels of a call
(torch.profiler).  To compare two checkouts on one card, run this file by
its path with PYTHONPATH at the other checkout, in turns on the same
machine: host-clock times move by a quarter from one machine or hour to
another.  It uses only entry points that the traversal kernel's first
version had.  The last line is one JSON object of the numbers printed.
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
from tpurt_torch.kernels import traversal as TV
from tpurt_torch.kernels.packc import pack_clusters
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


def wavefront_calls(scene, cfg, packed):
    """The arguments of the trace_bounce and trace_shadows calls that one
    frame's wavefront loop makes."""
    calls = {"trace_bounce": [], "trace_shadows": []}
    originals = {k: getattr(TV, k) for k in calls}

    def recorder(key):
        def wrapped(*args, **kwargs):
            calls[key].append((args, kwargs))
            return originals[key](*args, **kwargs)
        return wrapped

    for k in calls:
        setattr(TV, k, recorder(k))
    try:
        TV._wavefront_records(scene, cfg, packed, 0, cfg.height)
    finally:
        for k, fn in originals.items():
            setattr(TV, k, fn)
    return calls


def kernel_times(scene, cfg, plan, frames, mirror):
    """{kernel: {"ms": ..., counts (TV.STAT_NAMES)}} on one plan's packing:
    K5 over the frame, or on a reflective scene K6 and K7 as the wavefront
    loop launches them."""
    packed = pack_clusters(scene, plan.tri_ids, plan.tree)
    if not mirror:
        launch = [("trace_records", TV.trace_records_cuda, (packed, cfg, 0, cfg.height),
                   {"max_depth": 0})]
    else:
        calls = wavefront_calls(scene, cfg, packed)
        launch = [(key, getattr(TV, f"{key}_cuda"), *calls[key][0])
                  for key in ("trace_bounce", "trace_shadows")]
    out = {}
    for key, fn, args, kw in launch:
        stats = fn(*args, **kw, count=True)[-1]
        out[key] = {"ms": device_ms(lambda: fn(*args, **kw), frames),
                    **dict(zip(TV.STAT_NAMES, stats.tolist()))}
    return out


def reflective(scene, plan):
    """Config 5 with material 1 reflecting and its plan without the depth cap
    (chip_smoke.py:mirror_case)."""
    refl = scene.materials.reflectivity.clone()
    refl[1] = 0.25
    scene = dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, reflectivity=refl))
    return scene, dataclasses.replace(plan, depth_cap=None)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grad", action="store_true",
                    help="also time render_and_grad (L2 loss) and config 4's train step")
    ap.add_argument("--frames", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this tool times a card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(f"package: {tpurt_torch.__file__}", flush=True)
    result = {"card": card, "package": tpurt_torch.__file__}
    for name, (scene, cfg) in (("config 4 at 1024x1024", configs.config4_bunny(1024, 1024)),
                               ("config 5 at 1080x1920", configs.config5_multimesh(1080, 1920))):
        plan = tpurt_torch.prepare(scene, cfg)
        cases = [(name, scene, plan, False)]
        if name.startswith("config 5"):
            cases.append((name + ", reflective", *reflective(scene, plan), True))
        for case, sc, pl, mirror in cases:
            plans = {"as planned": pl}
            if getattr(pl.tree, "slot_order", None) is not None:
                plans["slab groups"] = dataclasses.replace(
                    pl, tree=dataclasses.replace(pl.tree, slot_order=None))
            for label, p in plans.items():
                for key, r in kernel_times(sc, cfg, p, args.frames, mirror).items():
                    result[f"{case}, {label}: {key}"] = r
                    print(f"{case} ({label}): {key} {r['ms']:.4f} ms (CUDA events, median of "
                          f"{args.frames}); " + ", ".join(
                              f"{k} {v}" for k, v in r.items() if k != "ms")
                          + f"; triangle tests a ray {r['tri_tests'] / r['rays']:.2f}",
                          flush=True)
        target = (tpurt_torch.render(scene, cfg, plan=plan) * 0.9).detach()
        calls = {"render": lambda: tpurt_torch.render(scene, cfg, plan=plan)}
        if args.grad:
            calls["render_and_grad"] = lambda: tpurt_torch.render_and_grad(
                scene, lambda im: ((im - target) ** 2).sum(), cfg, plan=plan)
            if name.startswith("config 4"):
                step = make_train_step(cfg, plan=plan)
                calls["train step"] = lambda: step(scene, target, 1.0)
        for what, fn in calls.items():
            ms = host_ms(fn, args.frames)
            busy, count = device_busy_ms(fn)
            result[f"{name}: {what}"] = {"median": statistics.median(ms), "device": busy,
                                         "launches": count}
            print(f"{name}: {what} median {statistics.median(ms):.4f} ms, p90 "
                  f"{ms[math.ceil(len(ms) * 0.9) - 1]:.4f} ms (n={len(ms)}, host clock to "
                  f"synchronize); device {busy:.4f} ms in {count:.0f} launches", flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
