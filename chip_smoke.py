#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (tpurt_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each:
  1. device   the card, as nvidia-smi names it, and its power limit;
  2. build    nvcc builds the kernels from tpurt_torch/kernels/csrc;
  3. parity   the CUDA kernel against its plain PyTorch version on the same
              packed inputs: config 1 at 256², config 2 at 512², config 3
              at 1080×1920;
  4. main     tpurt_torch.render on config 3 at 1080×1920 for 3 frames (the
              sphere centres move between frames), through the kernel and
              never the plain version; then ms/frame of both, and a check
              of the kernel path against the brute-force oracle on a small
              image.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Any failure raises: no result is printed.
"""
import json
import math
import statistics
import subprocess
import time

import torch

import tpurt_torch
from tpurt_torch.kernels import build
from tpurt_torch.kernels import megakernel as MK
from tpurt_torch.kernels.pack import pack_scene
from tpurt_torch.scene import configs

#: A pixel counts as a mismatch when a channel differs by more than this.
#: Kernel and plain version round every op alike (-fmad=false), but their
#: sqrt, rsqrt, pow and division need not agree to the last bit, so a
#: silhouette or shadow-edge pixel may flip; at most 1e-5 of the pixels may.
PIX_ATOL = 2e-4
MAX_FLIP_SHARE = 1e-5
ORACLE_ATOL = 2e-4  # the bar of tests/test_kernels.py
ORACLE_FLIP_SHARE = 1e-3
FRAMES = 3


def device_phase():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "run needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    return smi


def build_phase():
    t0 = time.perf_counter()
    so = build.build()
    build.load()
    secs = time.perf_counter() - t0
    log = (so.parent / "nvcc.log").read_text() if (so.parent / "nvcc.log").exists() else ""
    ptxas = "; ".join(l.split(":", 1)[-1].strip() for l in log.splitlines()
                      if "registers" in l or "spill" in l)
    print(f"build: {so.name} in {secs:.2f} s ({ptxas or 'cached build'})", flush=True)


def _warm(fn):
    fn()
    fn()
    torch.cuda.synchronize()


def host_ms(fn, iters):
    """Per-call host-clock ms of fn() up to torch.cuda.synchronize(): a
    request's time, host work included."""
    _warm(fn)
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def device_ms(fn, iters):
    """Per-call device ms of fn() between two CUDA events."""
    _warm(fn)
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(iters)]
    for start, end in evs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in evs]


def median(ms):
    return statistics.median(ms)


def summary(ms):
    """Median and the highest of p99/p90 with at least ten samples beyond it."""
    s = sorted(ms)
    text = f"median {median(s):.4f} ms"
    for q in (99, 90):
        if len(s) * (100 - q) >= 1000:
            text += f", p{q} {s[math.ceil(len(s) * q / 100) - 1]:.4f} ms"
            break
    return text + f" (n={len(s)})"


def parity_phase():
    """Kernel against plain version; returns config 3's packed scene, cfg
    and the worst max |Δ| seen."""
    worst = 0.0
    for k, (h, w) in ((1, (256, 256)), (2, (512, 512)), (3, (1080, 1920))):
        scene, cfg = configs.ALL_CONFIGS[k](h, w, device="cuda")
        packed = pack_scene(scene)
        n_pix = h * w
        col_k, occ_k = MK.megakernel_fwd_cuda(packed, cfg, 0, n_pix)
        col_r, occ_r = MK.tile_color_reference(packed, cfg, 0, n_pix)
        torch.cuda.synchronize()
        diff = (col_k - col_r).abs()
        max_d = float(diff.max())
        over = int((diff > PIX_ATOL).any(0).sum())
        occ_bad = int((occ_k != occ_r).any(0).sum())
        allowed = math.floor(MAX_FLIP_SHARE * n_pix)
        print(f"parity: config {k} at {h}x{w}: max|d colour| {max_d:.3g}, "
              f"pixels over {PIX_ATOL:g}: {over}, occ mismatches: {occ_bad} "
              f"(allowed {allowed} each)", flush=True)
        if not (torch.isfinite(col_k).all() and over <= allowed and occ_bad <= allowed):
            raise RuntimeError(f"kernel and plain version disagree on config {k}")
        worst = max(worst, max_d)
    return packed, cfg, worst


def moved_scenes(h, w):
    """FRAMES scenes of config 3 whose sphere centres move a little."""
    out = []
    for f in range(FRAMES):
        scene, cfg = configs.config3_spheres(h, w, device="cuda")
        shift = torch.tensor([0.05 * f, 0.0, -0.03 * f], device="cuda")
        scene.sph_center = scene.sph_center + shift
        out.append(scene)
    return out, cfg


def main_phase(packed3, cfg3):
    h, w = 1080, 1920
    scenes, cfg = moved_scenes(h, w)
    plans = [tpurt_torch.prepare(s, cfg) for s in scenes]
    if any(p.kind != "phase1" for p in plans):
        raise RuntimeError(f"config 3 planned as {plans}, not phase1")

    MK.reset_launches()
    images = [tpurt_torch.render(s, cfg, plan=p) for s, p in zip(scenes, plans)]
    torch.cuda.synchronize()
    counts = dict(MK.launches)
    for img in images:
        if img.shape != (h, w, 3) or not torch.isfinite(img).all() \
                or float(img.min()) < 0.0 or float(img.max()) > 1.0:
            raise RuntimeError("main path image is not finite in [0, 1] "
                               f"of shape {(h, w, 3)}")
    if counts["megakernel_fwd"] != FRAMES or counts["tile_color_reference"] != 0:
        raise RuntimeError(f"main path launches {counts}: want {FRAMES} "
                           "kernel launches and no plain-version launch")
    if torch.equal(images[0], images[1]):
        raise RuntimeError("moving the spheres did not change the image")

    scene = scenes[0]
    n_pix = h * w

    def plain_render():
        col, _ = MK.tile_color_reference(pack_scene(scene), cfg, 0, n_pix)
        return col.reshape(3, h, w).permute(1, 2, 0)

    rays = h * w * (cfg.max_depth + 1) * (1 + scene.n_lights)  # bench.py count_rays
    frame = host_ms(lambda: tpurt_torch.render(scene, cfg), 100)
    plain_frame = host_ms(plain_render, 20)
    print(f"main: config 3 at {h}x{w}, {FRAMES} frames: kernel launches "
          f"{counts['megakernel_fwd']}, plain-version launches "
          f"{counts['tile_color_reference']}; render {summary(frame)} a frame, "
          f"{rays / median(frame) / 1e3:.1f} nominal Mrays/s ({rays} rays); "
          f"with the plain version {summary(plain_frame)}, "
          f"{rays / median(plain_frame) / 1e3:.1f} Mrays/s", flush=True)

    # the kernel and its plain version alone on the same packed inputs, in
    # turns: kernel, plain, plain, kernel
    def kernel():
        return MK.megakernel_fwd_cuda(packed3, cfg3, 0, n_pix)

    def plain():
        return MK.tile_color_reference(packed3, cfg3, 0, n_pix)

    k1, p1, p2, k2 = (device_ms(kernel, 100), device_ms(plain, 10),
                      device_ms(plain, 10), device_ms(kernel, 100))
    print(f"main: kernel alone {summary(k1 + k2)} (halves {median(k1):.4f}, "
          f"{median(k2):.4f}); plain version alone {summary(p1 + p2)} "
          f"(halves {median(p1):.4f}, {median(p2):.4f})", flush=True)

    # the kernel path against the brute-force oracle (Möller–Trumbore and
    # the o - c sphere quadratic, independent of the packed forms) on a
    # small image; the two algorithms may split a silhouette or shadow-edge
    # pixel differently
    small, scfg = configs.config3_spheres(96, 128, device="cuda")
    img = tpurt_torch.render(small, scfg)
    ref = tpurt_torch.render(small, scfg, accel="none")
    diff = (img - ref).abs()
    over = int((diff > ORACLE_ATOL).any(-1).sum())
    allowed = math.floor(ORACLE_FLIP_SHARE * 96 * 128)
    print(f"main: config 3 at 96x128 against the oracle: max|d| "
          f"{float(diff.max()):.3g}, pixels over {ORACLE_ATOL:g}: {over} "
          f"(allowed {allowed})", flush=True)
    if over > allowed:
        raise RuntimeError("kernel path disagrees with the oracle")
    return counts["megakernel_fwd"], median(k1 + k2), median(p1 + p2)


def main():
    device_phase()
    build_phase()
    packed3, cfg3, max_err = parity_phase()
    launches, kernel_ms, plain_ms = main_phase(packed3, cfg3)
    print(json.dumps({"kernels": [{
        "name": "megakernel_fwd",
        "route": "cuda",
        "source": "tpurt_torch/kernels/csrc/megakernel_fwd.cu",
        "replaces": "tpurt/kernels/megakernel.py:423",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
