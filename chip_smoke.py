#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (tpurt_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, a few lines each:
  1. device   the card, as nvidia-smi names it, and its power limit;
  2. build    g++ builds the C++ builders (tpurt_torch/native), nvcc the
              kernels from tpurt_torch/kernels/csrc; the traversal and phase-1
              kernels' registers, stack frame and spills, and their static
              SASS instructions (cuobjdump, where the toolkit has it);
  3. parity   the forward kernel against its plain PyTorch version on the
              same packed inputs: config 1 at 256², config 2 at 512², config 3
              at 1080×1920;
  4. main     tpurt_torch.render on config 3 at 1080×1920 for 3 frames (the
              sphere centres move between frames), through the kernel and
              never the plain version; then ms/frame of both, and a check
              of the kernel path against the brute-force oracle on a small
              image;
  5. parity, backward   the replay backward, the fused L2 kernel and the
              hand-adjoint kernel, each against its plain version, on those
              three scenes and on a smooth-shaded box with a sphere at 256²;
              the fused against the hand-adjoint kernel; two launches of each
              against each other, bit for bit;
  5b. parity, large table   the same three kernels on a table beyond the
              shared-memory route: config 3 with 300 small spheres more at
              1080×1920 (the records route, summed by the segment-sum
              kernel): two launches of each bit for bit, the tables against
              the plain versions on a slab of 24 rows, the times;
  6. train    make_train_step on config 3 at 1080×1920 for 5 steps through
              the hand-adjoint kernel, then one render_and_grad with an L1
              loss (forward + replay backward) and one l2_loss_and_grad with
              hand=False (the fused kernel); launch counts, the loss going
              down, finite leaves;
  7. times    ms/step, the three backward kernels and their plain versions
              alone (with config 3's table path, shared memory and blocks an
              SM), the host's share of a step, and each kernel's bound;
  8. parity, traversal   the three modes of the traversal kernel against
              their plain versions: whole frames of config 3 through a
              clusters plan at 256², config 4 at 128² and a small config 5 at
              96×128, then 16,384 sampled pixels of config 4 at 1024×1024 and
              of config 5 at 1080×1920;
  9. main, clustered   (configs 4 and 5 built at full size by prepare's C++
              builder, beside the same plans over the numpy builder, timed)
              prepare + render of config 4 at 1024×1024 for 3 frames
              (the mesh moves, the boxes are refit), of config 3 through a
              clusters plan at 1080×1920, and of config 5 at 1080×1920 as it
              stands and with one reflective material; launch counts, images
              in [0, 1], the oracle on a small image, phase-1 against
              clustered on config 3;
 10. times, clustered   ms/frame of configs 4 and 5 and their split: pack,
              each kernel launch, deferred shading, launches a frame; each
              traversal kernel's time, its counting launch (box, group and
              triangle tests a ray), its bound from the lower of its counts
              and the first design's, and the slot order's counts against
              groups that are slabs;
 11. parity, segsum   the sorted segment-sum kernel against its plain version
              (index_add_) and a float64 sum: synthetic sorted streams (empty
              rows, one row holding half the stream, out-of-range entries,
              0, 1 and a prime number of updates, rows 3, 6, 8, 11 and 32
              wide), then
              the streams that the backward of config 4 at 1024x1024 and of
              config 5 at 1080x1920 hands it; two launches bit for bit;
 12. main, clustered backward   render_and_grad with an L2 loss against the
              image of a moved scene on config 4 at 1024x1024 and config 5 at
              1080x1920, the vertex-table gradient through the segment-sum
              kernel; against the plain-indexing route; two runs bit for bit;
              then 5 steps of make_train_step on config 4's clusters plan;
 13. times, clustered backward   ms of render_and_grad and of a step, the
              parts of the vertex-table backward (sort, permutation, kernel)
              beside index_add_ on the same stream, launches a step, the
              kernel's bound;
 13b. grid    config 4 at 1024x1024 through prepare(accel="grid") (the C++
              builder's uniform grid): blocks against clusters, 3 frames
              through K5 alone, K5 on the grid's blocks against its plain
              version on the clusters phase's sample, the image against the
              clusters plan's, render_and_grad against the clusters plan's,
              both plans timed in turns;
 13c. obj     config 4's mesh (subdiv 4) through save_obj and scene_from_obj
              on the card, rendered at 512x512 against the original; the C++
              parse against the numpy parse;
 13d. verify  tpurt_torch.tools.verify in this process (7 render-and-grad
              cases against the oracle on the CPU, 2 record equalities, 2
              finite differences) and its JSON line;
 14. main, clustered backward with spheres   render_and_grad with an L2 loss
              on config 3 through its clusters plan at 1080x1920 against moved
              spheres: the sphere table [centre | radius] through the segment
              sum, leaves against the plain-indexing route, both routes timed
              and profiled;
 15. probes   the two probe kernels against their plain versions at shapes
              that cut every tail, two abt launches bit for bit, the two block
              sizes of zeros_blocks against Tensor.zero_(), then the
              measurement tool they belong to (tpurt_torch.tools.probe_segsum):
              their times beside those before the redesign, gather rates and
              argsort times;
 16. dist     tile-parallel rows over torch.distributed
              (tpurt_torch.tools.dist_check): world 1 over NCCL in this
              process and two spawned ranks over gloo on the one card, each
              on config 3 at 1080x1920 (phase-1) and config 4 at 1024x1024
              (clusters; config 5 is left out for time): render_sharded and
              the window records bit-equal to the single device, the mesh
              step's gradients against render_and_grad, two runs bit for bit,
              5 and 3 steps lowering the loss, render_resumable crashing after
              2 chunks and resumed bit for bit, multihost-render as two
              processes, ms/frame, ms/step, the gather and the gradient sum,
              and what NCCL says to an all_reduce of two ranks on one card.
              The ranks' launches count in the kernels line.
 17. ring     the sharded scene and its ring (tpurt_torch.tools.ring_check):
              two spawned ranks over gloo on the one card render config 4 at
              1024x1024 and config 5 at 1080x1920 on the ring and take 3 ring
              train steps of each; the image, ids and occlusion bits against
              the replicated render of the renumbered scene (shadows from K7
              at the kernel's hit points; the lanes off the default in-kernel
              shadows counted), the gradients against render_and_grad, two
              runs bit for bit, the loss going down, K6 and K7 on a shard
              against their plain versions on a sample, ms/frame, ms/step,
              the bytes of each ring pass and the ring's share of a frame.
              The ranks' K6, K7 and K8 launches count in the kernels line.
 18. bench    the benchmark command (tpurt_torch.tools.bench, bench.py's
              harness) in this process: configs 3, 4 and 5 fwdbwd at
              1080x1920 (each with its forward alone), config 3 fwd, config 3
              fwdbwd over --mesh 1 (NCCL), config 4 fwd at 1024x1024 on the
              ring of --scene-shard 2 (gloo); each run's JSON line prefixed
              "bench:"; the nominal rays equal count_rays, phase-1's traced
              rays equal them, clustered 0 < traced <= nominal; every run
              launched its kernels and no plain version.  Its launches count
              in the kernels line.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Any failure raises: no result is printed.
"""
import contextlib
import dataclasses
import io
import json
import math
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

import tpurt_torch
from tpurt_torch.accel.clusters import build_clusters
from tpurt_torch.accel import native
from tpurt_torch.dist.train import make_train_step
from tpurt_torch.kernels import build
from tpurt_torch.kernels import megabwd as MB
from tpurt_torch.kernels import megakernel as MK
from tpurt_torch.kernels import probes as PR
from tpurt_torch.kernels import segsum as SS
from tpurt_torch.kernels import traversal as TV
from tpurt_torch.kernels.pack import pack_scene
from tpurt_torch.kernels.packc import pack_clusters
from tpurt_torch.core import geom
from tpurt_torch.render import cap_depth, clusters_plan
from tpurt_torch.scene import configs
from tpurt_torch.scene import obj as OBJ
from tpurt_torch.scene.scene import Materials
from tpurt_torch.shading import deferred as TD
from tpurt_torch.shading.deferred import records_from_ids, shade_from_records
from tpurt_torch.tools import bench as BENCH
from tpurt_torch.tools import dist_check as DIST
from tpurt_torch.tools import frame_times as FRAME
from tpurt_torch.tools import phase1_times as PHASE1
from tpurt_torch.tools import probe_segsum as PROBE
from tpurt_torch.tools import ring_check as RING
from tpurt_torch.tools import verify as VERIFY
from tpurt_torch.utils import roofline as RL

#: A pixel counts as a mismatch when a channel differs by more than this.
#: Kernel and plain version round every op alike (-fmad=false), but their
#: sqrt, rsqrt, pow and division need not agree to the last bit, so a
#: silhouette or shadow-edge pixel may flip; at most 1e-5 of the pixels may.
PIX_ATOL = 2e-4
MAX_FLIP_SHARE = 1e-5
ORACLE_ATOL = 2e-4  # the bar of tests/test_kernels.py
ORACLE_FLIP_SHARE = 1e-3
FRAMES = 3
#: backward bars (tests/test_kernels.py): each cotangent table to 2e-3 of its
#: own largest magnitude, the summed squared error to rtol 1e-5.  Kernel and
#: plain version sum 2 M pixels in different orders, and powf/logf need not
#: agree to the last bit, so the bar is relative to the table.
GRAD_RTOL = 2e-3
LOSS_RTOL = 1e-5
TRAIN_STEPS = 5
TRAIN_LR = 0.1

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
    lib = native.build()
    native.load()
    print(f"build: {lib.name} (g++ {' '.join(native.CXXFLAGS)}) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    so = build.build()
    build.load()
    secs = time.perf_counter() - t0
    log = (so.parent / "nvcc.log").read_text() if (so.parent / "nvcc.log").exists() else ""
    ptxas = "; ".join(l.split(":", 1)[-1].strip() for l in log.splitlines()
                      if "registers" in l or "spill" in l)
    print(f"build: {so.name} in {secs:.2f} s ({ptxas or 'cached build'})", flush=True)
    # the traversal and phase-1 kernels: registers, stack frame, spills
    for kernel, props in PHASE1.ptxas_props(log, ("trace_",) + PHASE1.PHASE1).items():
        print(f"build: {kernel}: {props}", flush=True)
    for kernel, c in PHASE1.sass_counts(PHASE1.sass_of(so)).items():
        if any(f in kernel for f in ("trace_",) + PHASE1.PHASE1):
            print(f"build: {kernel}: {c['instructions']} SASS instructions, {c['calls']} CALL",
                  flush=True)


def _warm(fn, calls=2):
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()


def host_ms(fn, iters, warm=2):
    """Per-call host-clock ms of fn() up to torch.cuda.synchronize(): a
    request's time, host work included."""
    _warm(fn, warm)
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def device_ms(fn, iters, warm=2):
    """Per-call device ms of fn() between two CUDA events."""
    _warm(fn, warm)
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
        scene, cfg = configs.ALL_CONFIGS[k](h, w)
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
        scene, cfg = configs.config3_spheres(h, w)
        shift = torch.tensor([0.05 * f, 0.0, -0.03 * f], device="cuda")
        scene.sph_center = scene.sph_center + shift
        out.append(scene)
    return out, cfg


def check_images(what, images, h, w):
    for img in images:
        if img.shape != (h, w, 3) or not torch.isfinite(img).all() \
                or float(img.min()) < 0.0 or float(img.max()) > 1.0:
            raise RuntimeError(f"{what}: image is not finite in [0, 1] of shape {(h, w, 3)}")


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
    check_images("main path", images, h, w)
    if {k: n for k, n in counts.items() if n} != {"megakernel_fwd": FRAMES}:
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
    small, scfg = configs.config3_spheres(96, 128)
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


TABLES = ("globals", "tri_forms", "sph_forms", "attrs")


def table_gap(got, want):
    """Largest |Δ| over the four cotangent tables, and the largest share of a
    table's own max|g| that its |Δ| reaches."""
    worst_abs = worst_share = 0.0
    for name in TABLES:
        a, b = getattr(got, name), getattr(want, name)
        if not torch.isfinite(a).all():
            raise RuntimeError(f"cotangent table {name} is not finite")
        gap = float((a - b).abs().max())
        worst_abs = max(worst_abs, gap)
        worst_share = max(worst_share, gap / (float(b.abs().max()) + 1e-30))
    return worst_abs, worst_share


def backward_parity_phase():
    """K2, K3, K4 against their plain versions, and each against a second
    launch of itself: bit for bit where the table takes the fixed-order path.
    Returns {kernel: worst max|Δ|}."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    worst = {"megakernel_bwd": 0.0, "l2_fused": 0.0, "l2_hand": 0.0}
    limits = MK._shared_limits(torch.cuda.current_device())
    cases = [("config 1", *configs.config1_sphere(256, 256)),
             ("config 2", *configs.config2_cornell(512, 512)),
             ("config 3", *configs.config3_spheres(1080, 1920)),
             ("smooth box", *configs.smooth_box(256, 256))]
    for name, scene, cfg in cases:
        packed = pack_scene(scene)
        n_pix = cfg.height * cfg.width
        n = MK.table_floats(packed)
        route = "shared memory" if MK.takes_fixed_order(n, cfg.max_depth + 1, *limits) \
            else "records"
        g = (torch.rand((3, n_pix), generator=gen) - 0.5).cuda()
        target = torch.rand((3, n_pix), generator=gen).cuda()
        _, occ = MK.megakernel_fwd_cuda(packed, cfg, 0, n_pix)
        k2, k2b = (MK.megakernel_bwd_cuda(packed, cfg, 0, n_pix, occ, g) for _ in range(2))
        (sq3, k3), (sq3b, k3b) = (MK.l2_fused_cuda(packed, cfg, 0, n_pix, target)
                                  for _ in range(2))
        (sq4, k4), (sq4b, k4b) = (MB.hand_l2_cuda(packed, cfg, 0, n_pix, target)
                                  for _ in range(2))
        p2 = MK.tile_color_vjp_reference(packed, cfg, 0, n_pix, occ, g)
        psq3, p3 = MK.l2_fused_reference(packed, cfg, 0, n_pix, target)
        psq4, p4 = MB.hand_l2_reference(packed, cfg, 0, n_pix, target)
        torch.cuda.synchronize()
        gaps = {"megakernel_bwd": table_gap(k2, p2), "l2_fused": table_gap(k3, p3),
                "l2_hand": table_gap(k4, p4), "fused vs hand": table_gap(k3, k4),
                "bwd, run to run": table_gap(k2b, k2), "fused, run to run": table_gap(k3b, k3),
                "hand, run to run": table_gap(k4b, k4)}
        repeat = {"megakernel_bwd": PHASE1.same_bits(k2, k2b),
                  "l2_fused": PHASE1.same_bits((sq3, k3), (sq3b, k3b)),
                  "l2_hand": PHASE1.same_bits((sq4, k4), (sq4b, k4b))}
        loss_gap = {"l2_fused": float((sq3.sum() - psq3.sum()).abs() / psq3.sum()),
                    "l2_hand": float((sq4.sum() - psq4.sum()).abs() / psq4.sum()),
                    "fused vs hand": float((sq3.sum() - sq4.sum()).abs() / sq4.sum())}
        print(f"parity, backward: {name} at {cfg.height}x{cfg.width} ({n} floats, "
              f"{route} route): "
              + "; ".join(f"{k} max|d| {a:.3g} = {s:.2g} of max|g|" for k, (a, s) in gaps.items())
              + "; loss rel. gaps " + ", ".join(f"{k} {v:.2g}" for k, v in loss_gap.items())
              + "; two launches bit-equal: " + ", ".join(f"{k} {v}" for k, v in repeat.items()),
              flush=True)
        bad = [k for k, (_, s) in gaps.items() if s > GRAD_RTOL] \
            + [k for k, v in loss_gap.items() if not v <= LOSS_RTOL] \
            + [f"{k} run to run" for k, v in repeat.items() if not v]
        if bad:
            raise RuntimeError(f"backward parity failed on {name}: {bad}")
        for k in worst:
            worst[k] = max(worst[k], gaps[k][0])
    return worst


#: small spheres added to config 3 for a table beyond the shared-memory route
LARGE_TABLE_SPHERES = 300
LARGE_TABLE_ROWS = (528, 24)   # the slab the plain versions take: first row, rows


def _cotangents(result):
    """The cotangent tables of a backward wrapper's result: (sq, tables) or tables."""
    return result[1] if isinstance(result, tuple) else result


def large_table_phase():
    """K2, K3, K4 on the records route at 1080x1920: two launches of each
    bit for bit, the tables against the plain versions on a slab of rows."""
    h, w = 1080, 1920
    scene, cfg = PHASE1.many_spheres(h, w, LARGE_TABLE_SPHERES)
    packed = pack_scene(scene)
    n, depths, n_pix = MK.table_floats(packed), cfg.max_depth + 1, h * w
    limits = MK._shared_limits(torch.cuda.current_device())
    if MK.takes_fixed_order(n, depths, *limits):
        raise RuntimeError(f"a table of {n} floats took the shared-memory route")
    gen = torch.Generator(device="cpu").manual_seed(2)
    g = (torch.rand((3, n_pix), generator=gen) - 0.5).cuda()
    target = torch.rand((3, n_pix), generator=gen).cuda()
    _, occ = MK.megakernel_fwd_cuda(packed, cfg, 0, n_pix)
    calls = {"megakernel_bwd": lambda off, m: MK.megakernel_bwd_cuda(
                 packed, cfg, off, m, occ[:, off:off + m].contiguous(),
                 g[:, off:off + m].contiguous()),
             "l2_fused": lambda off, m: MK.l2_fused_cuda(
                 packed, cfg, off, m, target[:, off:off + m].contiguous()),
             "l2_hand": lambda off, m: MB.hand_l2_cuda(
                 packed, cfg, off, m, target[:, off:off + m].contiguous())}
    plain = {"megakernel_bwd": lambda off, m: MK.tile_color_vjp_reference(
                 packed, cfg, off, m, occ[:, off:off + m].contiguous(),
                 g[:, off:off + m].contiguous()),
             "l2_fused": lambda off, m: MK.l2_fused_reference(
                 packed, cfg, off, m, target[:, off:off + m].contiguous()),
             "l2_hand": lambda off, m: MB.hand_l2_reference(
                 packed, cfg, off, m, target[:, off:off + m].contiguous())}
    row0, rows = LARGE_TABLE_ROWS
    for name, fn in calls.items():
        SS.reset_launches()
        first, again = fn(0, n_pix), fn(0, n_pix)
        torch.cuda.synchronize()
        seg = SS.launches["sorted_segsum"]
        repeat = PHASE1.same_bits(first, again)
        slab = fn(row0 * w, rows * w)
        want = plain[name](row0 * w, rows * w)
        torch.cuda.synchronize()
        gap, share = table_gap(_cotangents(slab), _cotangents(want))
        live = float(_cotangents(first).sph_forms[3:].abs().max())
        ms = device_ms(lambda: fn(0, n_pix), 10)
        split, _, _ = device_profile(lambda: fn(0, n_pix), (name, "reduce_rows", "segsum_kernel",
                                                           "RadixSort", "index"), iters=5)
        print(f"parity, large table: {name}, config 3 with {LARGE_TABLE_SPHERES} small spheres "
              f"more at {h}x{w} ({n} floats, records route; {seg} segment sums in two calls): "
              f"two launches bit-equal: {repeat}; on rows {row0}..{row0 + rows - 1} against "
              f"the plain version max|d| {gap:.3g} = {share:.2g} of max|g| (allowed "
              f"{GRAD_RTOL:g}); small spheres' forms max|g| {live:.3g}; the call "
              f"{summary(ms)} (CUDA events), on the device (torch.profiler, mean of 5) "
              + ", ".join(f"*{k}* {v:.4f} ms" for k, v in split.items()), flush=True)
        if not repeat or share > GRAD_RTOL or seg != 2 or not live > 0.0:
            raise RuntimeError(f"{name} on the records route: bits repeat {repeat}, "
                               f"{share:.3g} of max|g| off, {seg} segment sums, {live}")


def nonzero(counts):
    return {k: n for k, n in counts.items() if n}


def train_phase():
    """The train step, render_and_grad and the fused path on config 3 at
    1080x1920; returns the launch counts of each path, and what the timing
    phase needs."""
    h, w = 1080, 1920
    scenes, cfg = moved_scenes(h, w)
    scene = scenes[0]
    target = tpurt_torch.render(scenes[FRAMES - 1], cfg)
    step = make_train_step(cfg)

    MK.reset_launches()
    losses = []
    for _ in range(TRAIN_STEPS):
        scene, loss = step(scene, target, TRAIN_LR)
        losses.append(float(loss))
    torch.cuda.synchronize()
    train_counts = dict(MK.launches)
    if nonzero(train_counts) != {"l2_hand": TRAIN_STEPS}:
        raise RuntimeError(f"train launches {nonzero(train_counts)}: want "
                           f"{TRAIN_STEPS} of l2_hand and nothing else")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not go down: {losses}")
    for path, leaf in MK.scene_float_leaves(scene):
        if not torch.isfinite(leaf).all():
            raise RuntimeError(f"leaf {'.'.join(path)} is not finite after training")
    print(f"train: config 3 at {h}x{w}, {TRAIN_STEPS} steps at lr {TRAIN_LR}: launches "
          f"{nonzero(train_counts)}; loss " + " -> ".join(f"{x:.6g}" for x in losses), flush=True)

    MK.reset_launches()
    (l1, image), grads = tpurt_torch.render_and_grad(
        scenes[0], lambda im: (im - target).abs().sum(), cfg)
    torch.cuda.synchronize()
    rg_counts = dict(MK.launches)
    if nonzero(rg_counts) != {"megakernel_fwd": 1, "megakernel_bwd": 1}:
        raise RuntimeError(f"render_and_grad launches {nonzero(rg_counts)}")
    if not all(torch.isfinite(t).all() for _, t in MK.scene_float_leaves(grads)) \
            or float(grads.sph_center.abs().max()) == 0.0:
        raise RuntimeError("render_and_grad gradients are not finite and nonzero")

    MK.reset_launches()
    sq_f, g_f = MK.l2_loss_and_grad(scenes[0], target, cfg, hand=False)
    torch.cuda.synchronize()
    fused_counts = dict(MK.launches)
    if nonzero(fused_counts) != {"l2_fused": 1}:
        raise RuntimeError(f"l2_loss_and_grad(hand=False) launches {nonzero(fused_counts)}")
    sq_h, g_h = MK.l2_loss_and_grad(scenes[0], target, cfg, hand=True)
    gap = max(float((a - b).abs().max()) / (float(b.abs().max()) + 1e-30)
              for (_, a), (_, b) in zip(MK.scene_float_leaves(g_f), MK.scene_float_leaves(g_h)))
    print(f"train: render_and_grad (L1 loss {float(l1):.6g}) launches {nonzero(rg_counts)}; "
          f"l2_loss_and_grad(hand=False) launches {nonzero(fused_counts)}, its scene "
          f"gradients within {gap:.2g} of max|g| of the hand path's, loss "
          f"{float(sq_f):.6g} against {float(sq_h):.6g}", flush=True)
    if gap > GRAD_RTOL:
        raise RuntimeError("fused and hand scene gradients disagree")
    return {"l2_hand": train_counts["l2_hand"], "megakernel_bwd": rg_counts["megakernel_bwd"],
            "l2_fused": fused_counts["l2_fused"]}, (scenes[0], cfg, target, step)


def bounds(packed, cfg, n_pix):
    """{kernel: (bound_ms, bound_by)} for one launch over n_pix pixels
    (``tpurt_torch.utils.roofline``), printed with the work they count."""
    work = RL.phase1_work(packed, cfg, n_pix)
    c, ops, nbytes = work["counts"], work["ops"], work["bytes"]
    out = RL.phase1_bounds(packed, cfg, n_pix)
    print(f"times: config 3 paths: closest-hit passes {c['rays']}, shaded points "
          f"{[a + b for a, b in zip(c['shaded_tri'], c['shaded_sph'])]} per depth "
          f"({work['shaded_tri']} on triangles, {work['shaded_sph']} on spheres), shadow rays "
          f"{work['shadow_rays']} of which {work['blocked']} blocked; " + "; ".join(
              f"{k}: {ops[k] / 1e9:.3f} GFLOP, {nbytes[k] / 1e6:.1f} MB, bound "
              f"{out[k][0]:.4f} ms by {out[k][1]}" for k in ops)
          + f" (peaks {RL.PEAK_FP32_FLOPS / 1e12:g} TFLOP/s FP32 with FMA as two, "
          f"{RL.PEAK_BYTES_PER_S / 1e12:g} TB/s; -fmad=false forgoes the FMA half)", flush=True)
    return out

def device_profile(fn, names, iters=20, warm=2):
    """From torch.profiler over `iters` calls of fn(): mean device ms per call
    of each CUDA kernel whose name contains one of `names`, the device ms of
    all kernels per call, and the kernels launched per call."""
    from torch.profiler import ProfilerActivity, profile

    _warm(fn, warm)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    # device-side events only: a host op's row repeats its kernels' time, and
    # so does the device side of the program's spans
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type)
              and not getattr(e, "is_user_annotation", False)]
    if not events:
        raise RuntimeError("torch.profiler recorded no device kernel")

    def ms(e):
        return getattr(e, "self_device_time_total", 0.0) / iters / 1e3

    named = {n: sum(ms(e) for e in events if n in e.key) for n in names}
    return named, sum(ms(e) for e in events), sum(e.count for e in events) / iters


def times_phase(packed3, cfg3, train_state):
    """Returns {kernel: (ms, plain_ms)} for the three backward kernels."""
    scene, cfg, target, step = train_state
    h, w = cfg.height, cfg.width
    n_pix = h * w
    rays = h * w * (cfg.max_depth + 1) * (1 + scene.n_lights)  # bench.py count_rays

    ms = host_ms(lambda: step(scene, target, TRAIN_LR), 100)
    print(f"times: train step, config 3 at {h}x{w}: {summary(ms)} a step, "
          f"{rays / median(ms) / 1e3:.1f} nominal Mrays/s fwd+bwd ({rays} rays)", flush=True)

    # the host's share of a step: pack_scene and its autograd backward
    leaves = [t.detach().requires_grad_(True) for _, t in MK.scene_float_leaves(scene)]
    paths = [p for p, _ in MK.scene_float_leaves(scene)]

    def pack_fwd():
        return pack_scene(MK.scene_like(scene, dict(zip(paths, leaves)), default=lambda t: t))

    def pack_fwd_bwd():
        p = pack_fwd()
        outs = (p.tri_forms, p.sph_forms, p.attrs, p.globals)
        torch.autograd.grad(outs, leaves, grad_outputs=[torch.ones_like(t) for t in outs],
                            allow_unused=True)

    pf, pfb = host_ms(pack_fwd, 100), host_ms(pack_fwd_bwd, 100)
    print(f"times: host share of a step: pack_scene forward {summary(pf)}, forward and "
          f"autograd backward {summary(pfb)} (host clock to synchronize)", flush=True)

    n = MK.table_floats(packed3)
    depths = cfg3.max_depth + 1
    limits = MK._shared_limits(torch.cuda.current_device())
    if not MK.takes_fixed_order(n, depths, *limits):
        raise RuntimeError(f"config 3's table ({n} floats) left the shared-memory route")
    per_sm = {k: MK._blocks_per_sm(k, torch.cuda.current_device(), n, depths, False)
              for k in ("megakernel_bwd", "l2_fused", "l2_hand")}
    print(f"times: config 3's table {n} floats at {depths} depths: shared-memory route, "
          f"{MK.phase1_shared_bytes(n, depths, True)} bytes of shared memory a block "
          f"(card: {limits[0]} an SM, {limits[1]} a block, {limits[2]} kept back a block; "
          f"the largest table on that route at {depths} depths "
          f"{MK.fixed_order_limit(depths, *limits)} floats); blocks an SM {per_sm}", flush=True)

    gen = torch.Generator(device="cpu").manual_seed(1)
    g = (torch.rand((3, n_pix), generator=gen) - 0.5).cuda()
    tgt = target.reshape(n_pix, 3).t().contiguous()
    _, occ = MK.megakernel_fwd_cuda(packed3, cfg3, 0, n_pix)
    pairs = {
        "megakernel_bwd": (lambda: MK.megakernel_bwd_cuda(packed3, cfg3, 0, n_pix, occ, g),
                           lambda: MK.tile_color_vjp_reference(packed3, cfg3, 0, n_pix, occ, g)),
        "l2_fused": (lambda: MK.l2_fused_cuda(packed3, cfg3, 0, n_pix, tgt),
                     lambda: MK.l2_fused_reference(packed3, cfg3, 0, n_pix, tgt)),
        "l2_hand": (lambda: MB.hand_l2_cuda(packed3, cfg3, 0, n_pix, tgt),
                    lambda: MB.hand_l2_reference(packed3, cfg3, 0, n_pix, tgt)),
    }
    out = {}
    for name, (kernel, plain) in pairs.items():
        # in turns: kernel, plain, plain, kernel
        # a plain backward version at 1080p takes seconds: one call a turn
        k1, p1, p2, k2 = (device_ms(kernel, 100), device_ms(plain, 1, warm=0),
                          device_ms(plain, 1, warm=0), device_ms(kernel, 100))
        print(f"times: {name} alone {summary(k1 + k2)} (halves {median(k1):.4f}, "
              f"{median(k2):.4f}); its plain version alone {summary(p1 + p2)}", flush=True)
        out[name] = (median(k1 + k2), median(p1 + p2))
    split, _, _ = device_profile(pairs["l2_hand"][0], ("l2_hand", "reduce_rows"))
    print(f"times: l2_hand launch split (torch.profiler, mean of 20): main kernel "
          f"{split['l2_hand']:.4f} ms, reduce_rows {split['reduce_rows']:.4f} ms", flush=True)
    in_step, busy, count = device_profile(lambda: step(scene, target, TRAIN_LR),
                                          ("l2_hand", "reduce_rows"))
    print(f"times: a train step on the device (torch.profiler, mean of 20): all kernels "
          f"{busy:.4f} ms in {count:.0f} launches = {100 * busy / median(ms):.1f}% of the "
          f"step's host-clock median; l2_hand {in_step['l2_hand']:.4f} ms, reduce_rows "
          f"{in_step['reduce_rows']:.4f} ms, the rest (pack, its backward, the update) "
          f"{busy - in_step['l2_hand'] - in_step['reduce_rows']:.4f} ms", flush=True)
    return out


# ---------------------------------------------------------------------------
# the clustered path: the traversal kernel's three modes (trace_records,
# trace_bounce, trace_shadows) and deferred shading
# ---------------------------------------------------------------------------
SAMPLE = 16384          # pixels of a full-size frame that the plain versions trace
TRAV = ("trace_records", "trace_bounce", "trace_shadows")
CLUSTER_FRAMES = 30     # frames of a clustered timing


def clustered_case(name, scene, cfg, accel=None):
    """Build the plan (host work, timed) and pack once."""
    t0 = time.perf_counter()
    plan = tpurt_torch.prepare(scene, cfg, accel=accel)
    secs = time.perf_counter() - t0
    if plan.kind != "clusters":
        raise RuntimeError(f"{name} planned as {plan.kind}, not clusters")
    packed = pack_clusters(scene, plan.tri_ids, plan.tree)
    print(f"build: {name}: {scene.n_tris} triangles in {packed.n_clusters} clusters, upper "
          f"level {packed.tree_depth} deep ({packed.wide_children.shape[0]} nodes 4 wide, "
          f"a stack of {packed.stack} entries at most), depth cap {plan.depth_cap}; prepare "
          f"{secs:.2f} s on the host (the C++ builder)", flush=True)
    return {"name": name, "scene": scene, "cfg": cfg, "plan": plan, "packed": packed,
            "prepare_s": secs}


def big_scenes():
    """Configs 4 and 5 at full size, built once."""
    t0 = time.perf_counter()
    s4, c4 = configs.config4_bunny(1024, 1024)
    t1 = time.perf_counter()
    s5, c5 = configs.config5_multimesh(1080, 1920)
    t2 = time.perf_counter()
    print(f"build: procedural meshes on the host: config 4 {t1 - t0:.2f} s, "
          f"config 5 {t2 - t1:.2f} s", flush=True)
    cases = (clustered_case("config 4", s4, c4), clustered_case("config 5", s5, c5))
    for case in cases:
        prepare_routes(case)
    return cases


def prepare_routes(case):
    """prepare's seconds with the C++ builder (clustered_case timed the call)
    against the same plan over the numpy builder, the plain version."""
    scene = case["scene"]
    verts, tris = scene.vertices.cpu().numpy(), scene.triangles.cpu().numpy()
    t0 = time.perf_counter()
    cpp = native.build_clusters_native(verts, tris)
    t1 = time.perf_counter()
    plain = build_clusters(verts, tris)
    t2 = time.perf_counter()
    clusters_plan(scene, plain)
    t3 = time.perf_counter()
    print(f"build: {case['name']}: prepare with the C++ builder {case['prepare_s']:.2f} s (the "
          f"builder alone {t1 - t0:.2f} s, {cpp.n_clusters} clusters); the same plan over "
          f"the numpy builder {t3 - t1:.2f} s (the builder alone {t2 - t1:.2f} s, "
          f"{plain.n_clusters} clusters)", flush=True)


def record_gaps(got, want):
    """(ids off, occ off, max |Δ tbest| where the ids agree) of two records."""
    ids_off = int((got[0] != want[0]).sum())
    occ_off = int((got[1] != want[1]).sum())
    same = got[0] == want[0]
    t_gap = float((got[2] - want[2])[same].abs().max()) if bool(same.any()) else 0.0
    return ids_off, occ_off, t_gap


def check_records(what, got, want, worst, key):
    ids_off, occ_off, t_gap = record_gaps(got, want)
    lanes = got[0].numel()
    allowed = math.floor(MAX_FLIP_SHARE * lanes)
    print(f"parity, traversal: {what}: {lanes} lanes, ids off {ids_off} (allowed 0), occ "
          f"off {occ_off} (allowed {allowed}), max|d t| {t_gap:.3g}", flush=True)
    if ids_off or occ_off > allowed:
        bad = torch.nonzero((got[0] != want[0]) | (got[1] != want[1]))[:5].tolist()
        raise RuntimeError(f"{what}: kernel and plain version disagree, first lanes {bad}: "
                           f"ids {got[0][got[0] != want[0]][:5].tolist()} against "
                           f"{want[0][got[0] != want[0]][:5].tolist()}")
    worst[key] = max(worst[key], t_gap)


def traversal_parity_phase(big4, big5):
    """K5, K6, K7 against their plain versions.  Returns ({kernel: worst
    max|Δ|}, {case: ms of the plain version on the sample})."""
    worst = {k: 0.0 for k in TRAV}
    s3, c3 = configs.config3_spheres(256, 256)
    c4 = big4["cfg"].replace(width=128, height=128)
    s5, c5 = configs.config5_multimesh(96, 128, n_blobs=2, subdiv=4)
    small = [clustered_case("config 3 through clusters", s3, c3, accel="bvh"),
             dict(big4, cfg=c4),
             clustered_case("config 5, 2 blobs at subdiv 4", s5, c5)]
    for case in small:
        scene, cfg, packed, name = case["scene"], case["cfg"], case["packed"], case["name"]
        h, w = cfg.height, cfg.width
        got = TV.trace_records_cuda(packed, cfg, 0, h)
        want = TV.trace_records_reference(packed, cfg, 0, h)
        check_records(f"K5 {name} at {h}x{w}, depth {cfg.max_depth}", got, want, worst,
                      "trace_records")
        # K6 and K7 on what follows depth 0: every hit continues
        o, d = TV._camera_rays(packed, cfg, 0, h * w)
        ids0 = got[0][0]
        o2, d2, _, pts = TV._continue_rays(packed, o, d, ids0)
        alive = ids0 >= 0
        o2, d2, pts = o2.contiguous(), d2.contiguous(), pts.contiguous()
        check_records(f"K6 {name}, {int(alive.sum())} live rays",
                      TV.trace_bounce_cuda(packed, cfg, o2, d2, alive),
                      TV.trace_bounce_reference(packed, cfg, o2, d2, alive), worst,
                      "trace_bounce")
        occ_k, _ = TV.trace_shadows_cuda(packed, cfg, pts, o2, alive)
        occ_r, _ = TV.trace_shadows_reference(packed, cfg, pts, o2, alive)
        zeros = torch.zeros_like(occ_k)
        check_records(f"K7 {name}", (zeros, occ_k, zeros.float()), (zeros, occ_r, zeros.float()),
                      worst, "trace_shadows")
        # the hit points were recomputed outside the kernel: against the
        # in-kernel shadows of K5 a shadow-edge lane may differ
        edge = int((occ_k != got[1][0]).sum())
        print(f"parity, traversal: K7 {name}: {edge} of {int(alive.sum())} hit points differ "
              "from K5's in-kernel shadow bits (hit points recomputed outside the kernel in "
              "its arithmetic)", flush=True)

    plain_ms = {}
    gen = torch.Generator(device="cpu").manual_seed(0)
    for case in (big4, big5):
        cfg, packed, name = case["cfg"], case["packed"], case["name"]
        h, w = cfg.height, cfg.width
        # prepare capped the depth at 0: one launch with in-kernel shadows
        got = TV.trace_records_cuda(packed, cfg, 0, h, max_depth=0)
        pix = torch.randperm(h * w, generator=gen)[:SAMPLE].cuda()
        case["sample"] = pix
        o, d = TV._camera_rays(packed, cfg, 0, h * w)
        o, d = o[pix].contiguous(), d[pix].contiguous()
        alive = torch.ones(SAMPLE, dtype=torch.bool, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = TV.trace_bounce_reference(packed, cfg, o, d, alive)
        torch.cuda.synchronize()
        plain_ms[name] = (time.perf_counter() - t0) * 1e3
        check_records(f"K5 {name} at {h}x{w}, {SAMPLE} sampled pixels (plain version "
                      f"{plain_ms[name]:.0f} ms)", tuple(x[0][pix] for x in got[:3]), want[:3],
                      worst, "trace_records")
    return worst, plain_ms


def moved_frames(scene):
    """FRAMES copies of the scene with every vertex but the floor's four
    corners moved a little further each time."""
    blob = torch.ones((scene.vertices.shape[0], 1), device="cuda")
    blob[-4:] = 0.0
    return [dataclasses.replace(
        scene, vertices=scene.vertices + blob * torch.tensor([0.04 * f, 0.02 * f, -0.03 * f],
                                                             device="cuda"))
        for f in range(FRAMES)]


def mirror_case(big5):
    """Config 5 with material 1 reflecting (a third of the blobs): the path
    that re-bins shadows (over 2048 clusters, depth 1) and bounces.  The
    clusters do not depend on materials, so the plan is config 5's with the
    depth cap that prepare() gives a scene with a reflective material."""
    scene = big5["scene"]
    refl = scene.materials.reflectivity.clone()
    refl[1] = 0.25
    scene = dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, reflectivity=refl))
    plan = dataclasses.replace(big5["plan"], depth_cap=None)
    return dict(big5, name="config 5 with a reflective material", scene=scene, plan=plan,
                packed=pack_clusters(scene, plan.tri_ids, plan.tree))


def clustered_main_phase(big4, big5, mirror):
    """The clustered main path through prepare + render.  Returns the launch
    counts of the three modes over the whole phase and config 3's clusters
    case."""
    s4, c4, plan4 = big4["scene"], big4["cfg"], big4["plan"]
    frames4 = moved_frames(s4)
    s3, c3 = configs.config3_spheres(1080, 1920)
    plan3 = tpurt_torch.prepare(s3, c3, accel="bvh")
    paths = [("config 4 at 1024x1024, 3 frames", frames4, c4, plan4,
              {"trace_records": FRAMES}),
             ("config 3 through clusters at 1080x1920", [s3], c3, plan3,
              {"trace_records": 1, "trace_bounce": 2}),
             ("config 5 at 1080x1920", [big5["scene"]], big5["cfg"], big5["plan"],
              {"trace_records": 1}),
             ("config 5 with a reflective material at 1080x1920", [mirror["scene"]],
              mirror["cfg"], mirror["plan"],
              {"trace_records": 1, "trace_shadows": 2, "trace_bounce": 1})]
    if plan3.kind != "clusters" or plan4.depth_cap != 0 or big5["plan"].depth_cap != 0:
        raise RuntimeError("plans: config 3 with accel='bvh' must be clusters, configs 4 "
                           "and 5 capped at depth 0")

    MK.reset_launches()
    TV.reset_launches()
    images = {}
    per_path = {}
    for name, scenes, cfg, plan, _ in paths:
        before = dict(TV.launches)
        images[name] = [tpurt_torch.render(s, cfg, plan=plan) for s in scenes]
        per_path[name] = {k: TV.launches[k] - before[k] for k in TV.launches}
    torch.cuda.synchronize()
    counts = dict(TV.launches)
    for name, _, cfg, _, want in paths:
        check_images(name, images[name], cfg.height, cfg.width)
        print(f"main, clustered: {name}: launches {nonzero(per_path[name])}", flush=True)
        if nonzero(per_path[name]) != want:
            raise RuntimeError(f"{name}: launches {nonzero(per_path[name])}, want {want} "
                               "and no plain-version launch")
    if nonzero(MK.launches):
        raise RuntimeError(f"the clustered path launched phase-1 kernels: {nonzero(MK.launches)}")
    f4 = images[paths[0][0]]
    if torch.equal(f4[0], f4[1]) or torch.equal(f4[1], f4[2]):
        raise RuntimeError("moving the mesh did not change the image")

    # the kernel path against the brute-force oracle on a small image
    small, scfg = configs.config4_bunny(64, 64, subdiv=4)
    img = tpurt_torch.render(small, scfg)
    ref = tpurt_torch.render(small, scfg, accel="none")
    diff = (img - ref).abs()
    over = int((diff > ORACLE_ATOL).any(-1).sum())
    allowed = math.floor(ORACLE_FLIP_SHARE * 64 * 64)
    print(f"main, clustered: config 4 (subdiv 4) at 64x64 against the oracle: max|d| "
          f"{float(diff.max()):.3g}, pixels over {ORACLE_ATOL:g}: {over} (allowed {allowed})",
          flush=True)
    if over > allowed:
        raise RuntimeError("clustered kernel path disagrees with the oracle")

    # two intersection paths on config 3 at 1080p: phase-1 (one kernel that
    # shades) against clustered (records, then shading in PyTorch)
    phase1 = tpurt_torch.render(s3, c3)
    diff = (phase1 - images[paths[1][0]][0]).abs()
    n_pix = c3.height * c3.width
    over = int((diff > PIX_ATOL).any(-1).sum())
    print(f"main, clustered: config 3 at 1080x1920, phase-1 image against clustered image: "
          f"max|d| {float(diff.max()):.3g}, pixels over {PIX_ATOL:g}: {over} = "
          f"{over / n_pix:.2e} of {n_pix}", flush=True)
    if over > ORACLE_FLIP_SHARE * n_pix:
        raise RuntimeError("phase-1 and clustered images of config 3 disagree")

    # re-binned shadows (K7, hit points recomputed outside) against in-kernel
    # shadows on the reflective config 5: counted, not hidden
    scene, cfg, packed = mirror["scene"], mirror["cfg"], mirror["packed"]
    ids_r, occ_r = TV._wavefront_records(scene, cfg, packed, 0, cfg.height)
    ids_k, occ_k = TV._wavefront_records(scene, cfg.replace(shadow_rebin=False), packed, 0,
                                         cfg.height)
    ids_m, occ_m, _, _ = TV.trace_records_cuda(packed, cfg, 0, cfg.height)
    lanes = ids_r.numel()
    print(f"main, clustered: config 5 reflective at 1080x1920, {lanes} record lanes: "
          f"re-binned against in-kernel shadows: ids off {int((ids_r != ids_k).sum())}, occ "
          f"off {int((occ_r != occ_k).sum())}; wavefront against the multi-bounce launch: ids "
          f"off {int((ids_k != ids_m).sum())}, occ off {int((occ_k != occ_m).sum())}; "
          f"{int((ids_r[1] >= 0).sum())} bounce hits", flush=True)
    if int((ids_r != ids_k).sum()) or int((occ_r != occ_k).sum()) > ORACLE_FLIP_SHARE * lanes \
            or int((ids_k != ids_m).sum()) > ORACLE_FLIP_SHARE * lanes:
        raise RuntimeError("record paths of config 5 disagree beyond shadow-edge lanes")
    return {k: counts[k] for k in TRAV}, {"name": "config 3 through clusters", "scene": s3,
                                          "cfg": c3, "plan": plan3}


#: the first design's counting launches (a binary upper level, all 128 slots
#: of every cluster entered; the kernel of commit 4039bf9) on the inputs that
#: clustered_times_phase gives the kernel, which are deterministic: printed
#: by tpurt_torch/tools/frame_times.py run on that commit's checkout (PERF.md)
FIRST_DESIGN_COUNTS = {
    "trace_records config 4": {"nodes": 47609388, "clusters": 3355952, "tri_tests": 411635731,
                               "sph_tests": 0, "rays": 2593578},
    "trace_records config 5": {"nodes": 90170562, "clusters": 5696278, "tri_tests": 687189559,
                               "sph_tests": 0, "rays": 4785592},
    "trace_bounce": {"nodes": 3947332, "clusters": 237189, "tri_tests": 30360192,
                     "sph_tests": 0, "rays": 95526},
    "trace_shadows": {"nodes": 60982414, "clusters": 3872775, "tri_tests": 453781556,
                      "sph_tests": 0, "rays": 2711992},
}


def per_ray(n):
    return (f"{n['tri_tests'] / n['rays']:.2f} triangle tests, {n['nodes'] / n['rays']:.2f} "
            f"upper-level box tests and {n.get('group_tests', 0) / n['rays']:.2f} group box "
            f"tests a ray")


def traversal_bound(packed, stats, first, rays_in, lanes_out, floats_in, words_out):
    """(bound_ms, bound_by, text) of one launch from its counting launch:
    operations over the FP32 peak against bytes over the memory rate, each
    table and input read once and each record written once.  The operations
    are the lower of this design's counts and the first design's (`first`),
    so that the bound never rises because a design does more work; the
    tables are those the first design reads (the fewer bytes)."""
    n = dict(zip(TV.STAT_NAMES, stats.tolist()))
    ops = RL.traversal_ops(n, lanes_out)
    ops_first = RL.traversal_ops(first, lanes_out)
    tables = sum(x.numel() * x.element_size() for x in (
        packed.tri_forms, packed.tri_attrs, packed.boxes, packed.children, packed.sph_forms,
        packed.sph_attrs, packed.globals))
    nbytes = tables + rays_in * floats_in * 4 + lanes_out * words_out * 4
    b_ms, b_by = RL.bound_ms(nbytes, min(ops, ops_first))
    text = (f"{n['rays']} rays, {n['nodes']} upper-level box tests, {n['clusters']} clusters "
            f"entered, {n['group_tests']} group box tests, {n['tri_tests']} triangle tests "
            f"({n['tri_tests'] * 48 / 1e9:.2f} GB of forms re-read through the caches), "
            f"{n['sph_tests']} sphere tests: {per_ray(n)}, {ops / 1e9:.3f} GFLOP = "
            f"{ops / RL.PEAK_FP32_FLOPS * 1e3:.4f} ms; the first design on the same rays: "
            f"{first['clusters']} clusters entered, {per_ray(first)}, {ops_first / 1e9:.3f} "
            f"GFLOP = {ops_first / RL.PEAK_FP32_FLOPS * 1e3:.4f} ms; {nbytes / 1e6:.1f} MB = "
            f"{nbytes / RL.PEAK_BYTES_PER_S * 1e3:.4f} ms")
    return b_ms, b_by, text


def slab_counts(case, **kw):
    """Counts of trace_records on a case with the slots in the clusters' own
    order (groups that are slabs along the last split), against the plan's
    slot order."""
    scene, cfg, plan = case["scene"], case["cfg"], case["plan"]
    out = {}
    for label, tree in (("slot order", plan.tree),
                        ("slab groups", dataclasses.replace(plan.tree, slot_order=None))):
        packed = pack_clusters(scene, plan.tri_ids, tree)
        n = dict(zip(TV.STAT_NAMES, TV.trace_records_cuda(
            packed, cfg, 0, cfg.height, count=True, **kw)[3].tolist()))
        out[label] = n
    print(f"times, clustered: {case['name']}: groups of the slot order against slab groups, "
          "counting launches of trace_records: " + "; ".join(
              f"{label}: {n['tri_tests']} triangle tests = {per_ray(n)}"
              for label, n in out.items()), flush=True)


def frame_split(case):
    """ms/frame of render() on a clustered case and where it goes."""
    scene, cfg, plan, name = case["scene"], case["cfg"], case["plan"], case["name"]
    h, w = cfg.height, cfg.width
    capped = cap_depth(cfg, plan)
    rays = h * w * (cfg.max_depth + 1) * (1 + scene.n_lights)  # bench.py count_rays
    frame = host_ms(lambda: tpurt_torch.render(scene, cfg, plan=plan), CLUSTER_FRAMES)
    pack = host_ms(lambda: pack_clusters(scene, plan.tri_ids, plan.tree), CLUSTER_FRAMES)
    packed = pack_clusters(scene, plan.tri_ids, plan.tree)
    if capped.wavefront and capped.max_depth > 0:
        ids, occ = TV._wavefront_records(scene, capped, packed, 0, h)
    else:
        ids, occ, _, _ = TV.trace_records(packed, capped, 0, h)
    recs = records_from_ids(ids, occ, scene.n_tris)
    o, d = geom.generate_rays(scene.camera, h, w)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    shade = host_ms(lambda: shade_from_records(scene, o, d, recs, capped.max_depth,
                                               capped.shadows), CLUSTER_FRAMES)
    names = ("trace_records_kernel", "trace_bounce_kernel", "trace_shadows_kernel")
    split, busy, count = device_profile(lambda: tpurt_torch.render(scene, cfg, plan=plan),
                                        names, iters=10)
    s = sorted(frame)
    print(f"times, clustered: {name} at {h}x{w}: render {summary(frame)}, p90 "
          f"{s[math.ceil(len(s) * 0.9) - 1]:.4f} ms a frame, {rays / median(frame) / 1e3:.1f} "
          f"nominal Mrays/s ({rays} rays); pack_clusters + refit alone {summary(pack)}; "
          f"deferred shading alone {summary(shade)} (host clock to synchronize); on the "
          f"device (torch.profiler, mean of 10): all kernels {busy:.4f} ms in {count:.0f} "
          f"launches = {100 * busy / median(frame):.1f}% of the frame's median; "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
          + f"; the rest (pack, sorts, shading) {busy - sum(split.values()):.4f} ms",
          flush=True)
    return median(frame)


def sample_parity(what, kernel_out, plain_fn, idx, worst, key):
    """Time a plain version on the sampled lanes idx and hold the kernel's
    output at those lanes to it.  Returns the plain version's ms."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain_fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    check_records(f"{what}, {idx.numel()} sampled lanes (plain version {ms:.0f} ms)",
                  tuple(x[idx] for x in kernel_out), want, worst, key)
    return ms


def clustered_times_phase(big4, big5, mirror, worst, k5_plain_ms):
    """Returns ({kernel: (ms, plain_ms)}, {kernel: (bound_ms, bound_by)}); K5
    at config 4 1024x1024, K6 and K7 at the reflective config 5 at 1080x1920."""
    for case in (big4, big5, mirror):
        frame_split(case)

    times, bound = {}, {}
    for case in (big4, big5):
        cfg, packed, name = case["cfg"], case["packed"], case["name"]
        h, w = cfg.height, cfg.width

        def k5():
            return TV.trace_records_cuda(packed, cfg, 0, h, max_depth=0)

        ms = device_ms(k5, CLUSTER_FRAMES)
        stats = TV.trace_records_cuda(packed, cfg, 0, h, max_depth=0, count=True)[3]
        b_ms, b_by, text = traversal_bound(
            packed, stats, FIRST_DESIGN_COUNTS[f"trace_records {name}"], 0, h * w, 0, 3)
        slab_counts(case, max_depth=0)
        print(f"times, clustered: K5 trace_records, {name} at {h}x{w}: {summary(ms)}; "
              f"its plain version on {SAMPLE} sampled pixels {k5_plain_ms[name]:.0f} ms; "
              f"{text}; bound {b_ms:.4f} ms by {b_by}", flush=True)
        if case is big4:
            times["trace_records"] = (median(ms), k5_plain_ms[name])
            bound["trace_records"] = (b_ms, b_by)

    # K6 and K7 at the shapes the reflective config 5 gives them
    scene, cfg, packed = mirror["scene"], mirror["cfg"], mirror["packed"]
    # does re-binning pay on this card?  The records of one frame three ways
    routes = {
        "wavefront, shadows re-binned (the default)": lambda: TV._wavefront_records(
            scene, cfg, packed, 0, cfg.height),
        "wavefront, shadows in the kernel": lambda: TV._wavefront_records(
            scene, cfg.replace(shadow_rebin=False), packed, 0, cfg.height),
        "one multi-bounce launch": lambda: TV.trace_records_cuda(packed, cfg, 0, cfg.height),
    }
    print(f"times, clustered: records of {mirror['name']} (host clock to synchronize): "
          + "; ".join(f"{k}: {summary(host_ms(fn, 10))}" for k, fn in routes.items()),
          flush=True)
    calls = FRAME.wavefront_calls(scene, cfg, packed)
    gen = torch.Generator(device="cpu").manual_seed(1)
    (b_args, b_kw), = calls["trace_bounce"]
    (s_args, s_kw) = calls["trace_shadows"][0]
    for key, label, args, kw, floats_in, words_out in (
            ("trace_bounce", "K6", b_args, b_kw, 6.25, 3),
            ("trace_shadows", "K7", s_args, s_kw, 6.25, 1)):
        fn = getattr(TV, key)
        ms = device_ms(lambda: fn(*args, **kw), CLUSTER_FRAMES)
        out = fn(*args, **kw)
        stats = fn(*args, **kw, count=True)[-1]
        a, b, alive = args[2], args[3], args[4]
        live = torch.nonzero(alive)[:, 0]
        idx = live[torch.randperm(live.numel(), generator=gen)[:SAMPLE].cuda()]
        sub = (packed, cfg, a[idx].contiguous(), b[idx].contiguous(), alive[idx])
        if key == "trace_bounce":
            plain = sample_parity(f"K6 {mirror['name']}", out[:3],
                                  lambda: TV.trace_bounce_reference(*sub, None, kw["shadows"])[:3],
                                  idx, worst, key)
        else:
            zeros = torch.zeros_like(out[0])
            plain = sample_parity(
                f"K7 {mirror['name']}", (zeros, out[0], zeros.float()),
                lambda: (zeros[idx], TV.trace_shadows_reference(*sub)[0], zeros[idx].float()),
                idx, worst, key)
        n_rays = a.shape[0]
        b_ms, b_by, text = traversal_bound(packed, stats, FIRST_DESIGN_COUNTS[key], n_rays,
                                           n_rays, floats_in, words_out)
        print(f"times, clustered: {label} {key}, {mirror['name']} at {cfg.height}x{cfg.width}: "
              f"{n_rays} lanes, {live.numel()} live: {summary(ms)}; its plain version on "
              f"{idx.numel()} sampled lanes {plain:.0f} ms; {text}; bound {b_ms:.4f} ms by "
              f"{b_by}", flush=True)
        times[key] = (median(ms), plain)
        bound[key] = (b_ms, b_by)
    return times, bound


# ---------------------------------------------------------------------------
# the clustered backward: the sorted segment-sum kernel (sorted_segsum) under
# render_and_grad and the train step on a clusters plan; the probe kernels
# ---------------------------------------------------------------------------
#: the clustered gradient bar (tests/test_traversal.py:89): a leaf's gradient
#: to 2e-4 of its largest magnitude; two routes sum the pixels in two orders
CLUSTERED_GRAD_RTOL = 2e-4
CLUSTERED_TRAIN_LR = 1.0
BACKWARD_RUNS = 10      # timed calls of render_and_grad and of a step
#: leaves whose gradient the segment sum makes: the vertex table's, the
#: material table's and the textures'
SEGSUM_LEAVES = (("vertices",), ("vnormals",), ("uvs",), ("textures",), ("materials", "ka"),
                 ("materials", "kd"), ("materials", "ks"), ("materials", "shininess"))


def segsums_a_backward(scene):
    """Segment sums of one backward at depth 0: the vertex table, the
    material table and, where the scene is textured, the texels."""
    return 3 if scene.textured else 2


def moved_case(case, shift):
    """The case's scene with every vertex but the floor's four corners moved,
    and the image of that scene: the target of an L2 loss."""
    scene = case["scene"]
    blob = torch.ones((scene.vertices.shape[0], 1), device="cuda")
    blob[-4:] = 0.0
    moved = dataclasses.replace(
        scene, vertices=scene.vertices + blob * torch.tensor(shift, device="cuda"))
    return tpurt_torch.render(moved, case["cfg"], plan=case["plan"]).detach()


def l2_grads(case, target):
    return tpurt_torch.render_and_grad(
        case["scene"], lambda im: ((im - target) ** 2).sum(), case["cfg"], plan=case["plan"])


def capture_streams(fn):
    """fn() with the (idx, upd, n_rows) of every segsum_rows call that the
    backward makes kept."""
    streams = []
    original = TD.segsum_rows

    def recorder(idx, upd, n_rows):
        streams.append((idx.clone(), upd.clone(), n_rows))
        return original(idx, upd, n_rows)

    TD.segsum_rows = recorder
    try:
        fn()
    finally:
        TD.segsum_rows = original
    return streams


def with_plain_gather(fn, gather=TD.gather_rows_reference):
    """fn() with the table gathers by plain indexing (its backward is
    PyTorch's index_put with accumulation): the plain route; or by `gather`."""
    original = TD.gather_rows
    TD.gather_rows = gather
    try:
        return fn()
    finally:
        TD.gather_rows = original


def check_segsum(what, idx, upd, n_rows, worst):
    """K8 on a sorted stream against its plain version and a float64 sum;
    two launches against each other."""
    got = SS.sorted_segsum_cuda(idx, upd, n_rows)
    again = SS.sorted_segsum_cuda(idx, upd, n_rows)
    # the same stream as shuffled rows with the positions that sort them
    order = torch.randperm(idx.numel(), device="cuda")
    shuffled = torch.empty_like(upd)
    shuffled[order] = upd
    ordered = SS.sorted_segsum_cuda(idx, shuffled, n_rows, order)
    plain = SS.sorted_segsum_reference(idx, upd, n_rows)
    exact = SS.sorted_segsum_reference(idx, upd.double(), n_rows)
    torch.cuda.synchronize()
    gaps = {"kernel against plain": PROBE.sum_gap(got, plain, idx, upd, n_rows, serial_f32=True),
            "kernel against float64": PROBE.sum_gap(got, exact, idx, upd, n_rows),
            "plain against float64": PROBE.sum_gap(plain, exact, idx, upd, n_rows,
                                                   serial_f32=True)}
    finite = torch.isfinite(plain)
    err = float((got - plain)[finite].abs().max()) if bool(finite.any()) else 0.0
    live = int(((idx >= 0) & (idx < n_rows)).sum())
    print(f"parity, segsum: {what}: {idx.numel()} updates ({live} in range) of width "
          f"{upd.shape[1]} into {n_rows} rows: max|d| against the plain version {err:.3g}; "
          + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
          + " of the allowed gap (rtol 1e-5, atol 1e-6 of max(1, max|a|, a row's summed "
          "|update|), against the plain f32 sum 2^-24 sqrt(n) of it more on a row of n updates); "
          f"two launches bit-equal: {torch.equal(got, again)}; shuffled rows read "
          f"through their sorting positions bit-equal: {torch.equal(got, ordered)}", flush=True)
    if max(gaps.values()) > 1.0 or not torch.equal(got, again) \
            or not torch.equal(got, ordered) or got.shape != plain.shape:
        raise RuntimeError(f"sorted_segsum disagrees on {what}")
    worst["sorted_segsum"] = max(worst["sorted_segsum"], err)


def sorted_stream(idx, upd):
    idx_sorted, order = torch.sort(idx.reshape(-1).to(torch.int32), stable=True)
    return idx_sorted, upd.reshape(-1, upd.shape[-1]).index_select(0, order)


def segsum_parity_phase(big4, big5, targets):
    """Returns ({kernel: worst max|d|}, {case: its backward's stream})."""
    worst = {"sorted_segsum": 0.0}
    for kind in ("uniform", "dominant", "out_of_range", "sparse"):
        for width in (3, 6, 8, 11, 32):
            for n in (0, 1, 200003):
                idx, upd = PROBE.synthetic_stream(kind, n, 40009, width, n + width, "cuda")
                check_segsum(f"{kind}, seed {n + width}", *sorted_stream(idx, upd), 40009, worst)
    streams = {}
    for case in (big4, big5):
        name = case["name"]
        got = capture_streams(lambda: l2_grads(case, targets[name]))
        cfg = case["cfg"]
        n_pix = cfg.height * cfg.width
        # a lane sends 3 corner rows, 1 material row, 4 texel rows
        by_rows = {3: "vertices", 1: "materials", 4: "texels"}
        streams[name] = {by_rows.get(s[0].numel() // n_pix): s for s in got}
        want = set(by_rows.values()) - (set() if case["scene"].textured else {"texels"})
        if len(got) != len(want) or set(streams[name]) != want:
            raise RuntimeError(f"{name}: the backward's streams have "
                               f"{[s[0].numel() for s in got]} updates, want those of {want}")
        for table, (idx, upd, n_rows) in streams[name].items():
            check_segsum(f"the backward of {name} at {cfg.height}x{cfg.width}, {table} table",
                         *sorted_stream(idx, upd), n_rows, worst)
    return worst, streams


def clustered_backward_phase(big4, big5, targets):
    """The clustered main path backward.  Returns the launch counts of
    sorted_segsum and trace_records over the phase and the train state."""
    total = {"sorted_segsum": 0, "trace_records": 0}
    for case in (big4, big5):
        name, cfg = case["name"], case["cfg"]
        per_run = segsums_a_backward(case["scene"])
        for mod in (MK, TV, SS, PR):
            mod.reset_launches()
        (loss, image), grads = l2_grads(case, targets[name])
        torch.cuda.synchronize()
        counts = {**nonzero(MK.launches), **nonzero(TV.launches), **nonzero(SS.launches),
                  **nonzero(PR.launches)}
        if counts != {"trace_records": 1, "sorted_segsum": per_run}:
            raise RuntimeError(f"{name}: render_and_grad launches {counts}: want one "
                               f"trace_records, {per_run} sorted_segsum and no plain version")
        for k in total:
            total[k] += counts[k]
        check_images(name, [image], cfg.height, cfg.width)
        for path, g in MK.scene_float_leaves(grads):
            if not torch.isfinite(g).all():
                raise RuntimeError(f"{name}: gradient of {'.'.join(path)} is not finite")
        _, again = l2_grads(case, targets[name])
        (_, _), plain = with_plain_gather(lambda: l2_grads(case, targets[name]))
        torch.cuda.synchronize()
        if SS.launches["sorted_segsum"] != 2 * per_run or SS.launches["sorted_segsum_reference"]:
            raise RuntimeError(f"{name}: the plain route went through the segment sum")
        ours, twice, theirs = (dict(MK.scene_float_leaves(g)) for g in (grads, again, plain))
        top = {path: float(theirs[path].abs().max()) for path in SEGSUM_LEAVES}
        untextured = {("uvs",), ("textures",)} if not case["scene"].textured else set()
        for path in SEGSUM_LEAVES:
            if (top[path] == 0.0) != (path in untextured):
                raise RuntimeError(f"{name}: gradient of {'.'.join(path)} has max|g| {top[path]}")
        gaps = {path: float((ours[path] - theirs[path]).abs().max()) / top[path]
                for path in SEGSUM_LEAVES if top[path] > 0.0}
        # which leaves come out the same bits twice: those of the segment sum
        # must (it has no atomics)
        varying = [".".join(path) for path in ours if not torch.equal(ours[path], twice[path])]
        print(f"main, clustered backward: {name} at {cfg.height}x{cfg.width}: L2 loss "
              f"{float(loss):.6g}, launches {counts}; segment-sum route against the "
              f"plain-indexing route, share of max|g| (allowed {CLUSTERED_GRAD_RTOL:g}): "
              + ", ".join(f"{'.'.join(k)} {v:.2g} of {top[k]:.4g}" for k, v in gaps.items())
              + f"; leaves whose bits differ between two runs: {varying or 'none'}", flush=True)
        if max(gaps.values()) > CLUSTERED_GRAD_RTOL:
            raise RuntimeError(f"{name}: the two routes' gradients disagree")
        if set(varying) & {".".join(path) for path in SEGSUM_LEAVES}:
            raise RuntimeError(f"{name}: segment-sum gradients differ between two runs")

    scene, cfg, plan = big4["scene"], big4["cfg"], big4["plan"]
    step = make_train_step(cfg, plan=plan)
    for mod in (MK, TV, SS, PR):
        mod.reset_launches()
    losses, cur = [], scene
    for _ in range(TRAIN_STEPS):
        cur, loss = step(cur, targets["config 4"], CLUSTERED_TRAIN_LR)
        losses.append(float(loss))
    torch.cuda.synchronize()
    counts = {**nonzero(MK.launches), **nonzero(TV.launches), **nonzero(SS.launches)}
    if counts != {"trace_records": TRAIN_STEPS,
                  "sorted_segsum": TRAIN_STEPS * segsums_a_backward(scene)}:
        raise RuntimeError(f"clustered train launches {counts}")
    for k in total:
        total[k] += counts[k]
    moved = float((cur.vertices - scene.vertices).abs().max())
    for path, leaf in MK.scene_float_leaves(cur):
        if not torch.isfinite(leaf).all():
            raise RuntimeError(f"leaf {'.'.join(path)} is not finite after training")
    print(f"main, clustered backward: train, config 4 at {cfg.height}x{cfg.width}, "
          f"{TRAIN_STEPS} steps at lr {CLUSTERED_TRAIN_LR}: launches {counts}; loss "
          + " -> ".join(f"{x:.6g}" for x in losses) + f"; vertices moved by up to {moved:.3g}",
          flush=True)
    if not losses[-1] < losses[0] or moved == 0.0:
        raise RuntimeError(f"the loss did not go down or no vertex moved: {losses}")
    return total, step


def clustered_backward_times_phase(big4, big5, targets, streams, step):
    """Returns ({kernel: (ms, plain_ms)}, {kernel: (bound_ms, by)}, {kernel:
    library_ms}) of sorted_segsum on config 4's stream."""
    times, bound, library = {}, {}, {}
    for case in (big4, big5):
        name, cfg = case["name"], case["cfg"]
        rg = host_ms(lambda: l2_grads(case, targets[name]), BACKWARD_RUNS)
        fwd = host_ms(lambda: tpurt_torch.render(case["scene"], cfg, plan=case["plan"]),
                      BACKWARD_RUNS)
        plain = host_ms(lambda: with_plain_gather(lambda: l2_grads(case, targets[name])),
                        BACKWARD_RUNS)
        print(f"times, clustered backward: {name} at {cfg.height}x{cfg.width}: render_and_grad "
              f"{summary(rg)}; with the plain-indexing route {summary(plain)}; render alone "
              f"{summary(fwd)} (host clock to synchronize)", flush=True)

        for table, (idx, upd, n_rows) in streams[name].items():
            seg = device_ms(lambda: TD.segsum_rows(idx, upd, n_rows), CLUSTER_FRAMES)
            put = device_ms(lambda: torch.zeros((n_rows, upd.shape[1]), device="cuda").index_put_(
                (idx.long().clamp(0, n_rows - 1),), upd, accumulate=True), 3, warm=1)
            print(f"times, clustered backward: {name}, {table} table: {idx.numel()} updates of "
                  f"width {upd.shape[1]} into {n_rows} rows: segsum_rows {summary(seg)}; "
                  f"index_put_ with accumulation, what plain indexing's backward runs, "
                  f"{summary(put)}", flush=True)
        idx, upd, n_rows = streams[name]["vertices"]
        width = upd.shape[1]
        idx_s, upd_s = sorted_stream(idx, upd)
        order = torch.sort(idx, stable=True)[1]
        ok_s, ok_u = (idx_s >= 0) & (idx_s < n_rows), (idx >= 0) & (idx < n_rows)
        lib = {"sorted": (idx_s[ok_s], upd_s[ok_s]), "unsorted": (idx[ok_u], upd[ok_u]),
               "unsorted, dropped lanes on row 0 with zeros": (
                   torch.where(ok_u, idx, 0), torch.where(ok_u[:, None], upd, 0.0))}
        out = torch.zeros((n_rows, width), device="cuda")
        parts = {
            # what segsum_rows launches: the rows read through the sort's positions
            "sorted_segsum": lambda: SS.sorted_segsum_cuda(idx_s, upd, n_rows, order),
            "sorted_segsum on a sorted copy": lambda: SS.sorted_segsum_cuda(idx_s, upd_s, n_rows),
            "its plain version (permutation, mask, compaction, index_add_)":
                lambda: SS.sorted_segsum_reference(idx_s, upd, n_rows, order),
            "stable sort": lambda: torch.sort(idx, stable=True),
            "making the sorted copy (index_select)": lambda: upd.index_select(0, order),
            "segsum_rows (sort, kernel)": lambda: TD.segsum_rows(idx, upd, n_rows),
            **{f"index_add_ {k}": (lambda a=a, b=b: out.zero_().index_add_(0, a, b))
               for k, (a, b) in lib.items()},
        }
        # device time by CUDA graph (tools/probe_segsum.py:device_ms): the
        # kernel is faster than the host issues its launches; the plain
        # version (a boolean mask, a sync) cannot be captured and is timed
        # by events around each call
        plain_key = "its plain version (permutation, mask, compaction, index_add_)"
        ms = {k: median(device_ms(fn, CLUSTER_FRAMES)) if k == plain_key else PROBE.device_ms(fn)
              for k, fn in parts.items()}
        nbytes, flops = SS.segsum_counts(idx_s, n_rows, width)
        b_ms, b_by = RL.bound_ms(nbytes, flops)
        runs = torch.unique_consecutive(idx_s[ok_s], return_counts=True)[1]
        print(f"times, clustered backward: the vertex-table stream of {name}: {idx.numel()} "
              f"updates of width {width} into {n_rows} rows, {int(ok_s.sum())} in range in "
              f"{runs.numel()} runs, longest {int(runs.max())}; "
              + "; ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
              + f" (a CUDA graph of 20 calls, median of 5 replays; the plain version CUDA "
              f"events, median of {CLUSTER_FRAMES}); bound {b_ms:.4f} ms "
              f"by {b_by} ({nbytes / 1e6:.1f} MB, "
              f"{flops / 1e6:.1f} MFLOP)", flush=True)
        if case is big4:
            times["sorted_segsum"] = (ms["sorted_segsum"], ms[plain_key])
            bound["sorted_segsum"] = (b_ms, b_by)
            library["sorted_segsum"] = ms["index_add_ sorted"]

    scene, cfg = big4["scene"], big4["cfg"]
    ms = host_ms(lambda: step(scene, targets["config 4"], CLUSTERED_TRAIN_LR), BACKWARD_RUNS)
    names = ("segsum_kernel", "trace_records_kernel", "RadixSort", "index")
    split, busy, count = device_profile(
        lambda: step(scene, targets["config 4"], CLUSTERED_TRAIN_LR), names, iters=5)
    print(f"times, clustered backward: train step, config 4 at {cfg.height}x{cfg.width}: "
          f"{summary(ms)} a step (host clock to synchronize); on the device (torch.profiler, "
          f"mean of 5): all kernels {busy:.4f} ms in {count:.0f} launches = "
          f"{100 * busy / median(ms):.1f}% of the step's median; kernels named "
          + ", ".join(f"*{k}* {v:.4f} ms" for k, v in split.items()), flush=True)
    return times, bound, library


SPHERE_LEAVES = (("sph_center",), ("sph_radius",))
#: the sphere shifts of the targets the two routes are held to each other on
SPHERE_SHIFTS = ((0.05, 0.0, -0.03), (-0.04, 0.03, 0.02))


class _Float64Rows(torch.autograd.Function):
    """table[idx] whose backward adds every lane's cotangent row into a
    float64 table (index_add_): plain indexing with its sum in float64."""

    @staticmethod
    def forward(ctx, table, idx, live):
        ctx.save_for_backward(idx)
        ctx.shape = table.shape
        return table[idx]

    @staticmethod
    def backward(ctx, cot):
        idx, = ctx.saved_tensors
        g = torch.zeros(ctx.shape, dtype=torch.float64, device=cot.device)
        g.index_add_(0, idx.reshape(-1), cot.reshape(-1, ctx.shape[-1]).double())
        return g.float(), None, None


def float64_gather(table, idx, live):
    return _Float64Rows.apply(table, idx, live)


def sphere_route_check(case, target):
    """One render_and_grad through the segment sum, held to the
    plain-indexing route with its sums in float64: PyTorch's own (index_put_)
    adds a row's million updates one after another in f32 and can itself be
    further than the bar from float64 (ROADMAP.md Queue 3), so its gaps are
    printed beside.  Raises where the routes disagree.  Returns the launch
    counts of the call."""
    scene, cfg = case["scene"], case["cfg"]
    for mod in (MK, TV, SS, PR):
        mod.reset_launches()
    out = {}
    streams = capture_streams(lambda: out.update(call=l2_grads(case, target)))
    (loss, image), grads = out["call"]
    torch.cuda.synchronize()
    counts = {**nonzero(MK.launches), **nonzero(TV.launches), **nonzero(SS.launches),
              **nonzero(PR.launches)}
    # the sphere table is [centre | radius]: rows 4 wide, one a sphere
    sph = [s for s in streams if s[1].shape[1] == 4 and s[2] == scene.n_spheres]
    if not sph or counts.get("sorted_segsum", 0) != len(streams) \
            or counts.get("sorted_segsum_reference"):
        raise RuntimeError(f"{case['name']}: render_and_grad launches {counts}, sphere-table "
                           f"streams {len(sph)} of {len(streams)}: want the sphere table "
                           "through sorted_segsum and no plain version")
    check_images(case["name"], [image], cfg.height, cfg.width)
    (_, _), plain = with_plain_gather(lambda: l2_grads(case, target))
    (_, _), exact = with_plain_gather(lambda: l2_grads(case, target), float64_gather)
    torch.cuda.synchronize()
    ours, theirs, bar = (dict(MK.scene_float_leaves(g)) for g in (grads, plain, exact))
    leaves = [p for p in SPHERE_LEAVES + SEGSUM_LEAVES if float(bar[p].abs().max()) > 0.0]
    gaps, tops = {}, {p: float(bar[p].abs().max()) for p in leaves}
    for p in leaves:
        gaps[p] = tuple(float((a.double() - b.double()).abs().max()) / tops[p]
                        for a, b in ((ours[p], bar[p]), (ours[p], theirs[p]),
                                     (theirs[p], bar[p])))
    print(f"main, clustered backward: {case['name']} at {cfg.height}x{cfg.width}: L2 loss "
          f"{float(loss):.6g} against moved spheres, launches {counts}; {len(sph)} "
          f"sphere-table segment sums ("
          + ", ".join(f"{s[0].numel()} updates" for s in sph) + "); share of max|g| of the "
          "segment-sum route against the plain-indexing route summed in float64 (allowed "
          f"{CLUSTERED_GRAD_RTOL:g}) | against the plain route as PyTorch sums it (index_put_, "
          "serially in f32) | the latter against the float64 one: "
          + ", ".join(f"{'.'.join(k)} {a:.3g} | {b:.3g} | {c:.3g} of {tops[k]:.4g}"
                      for k, (a, b, c) in gaps.items()), flush=True)
    bad = [p for p, (a, _, _) in gaps.items() if a > CLUSTERED_GRAD_RTOL]
    if any(not torch.isfinite(ours[p]).all() for p in ours) or not all(
            p in leaves for p in SPHERE_LEAVES) or bad:
        raise RuntimeError(f"{case['name']}: the two routes' gradients disagree or vanish: "
                           f"{bad}")
    return counts


def sphere_backward_phase(case):
    """render_and_grad with an L2 loss on config 3 through its clusters plan
    at 1080x1920 against the images of spheres moved two ways: the sphere
    table's gather goes through the segment sum; each held to the
    plain-indexing route (sphere_route_check); both routes timed on the
    first.  Returns the launch counts of one call."""
    scene, cfg, plan = case["scene"], case["cfg"], case["plan"]
    targets = [tpurt_torch.render(dataclasses.replace(
        scene, sph_center=scene.sph_center + torch.tensor(shift, device="cuda")),
        cfg, plan=plan).detach() for shift in SPHERE_SHIFTS]
    counts = [sphere_route_check(case, t) for t in targets]
    target = targets[0]

    rg = host_ms(lambda: l2_grads(case, target), BACKWARD_RUNS)
    slow = host_ms(lambda: with_plain_gather(lambda: l2_grads(case, target)), 2, warm=0)
    names = ("segsum_kernel", "index")
    split, busy, count = device_profile(lambda: l2_grads(case, target), names, iters=5)
    psplit, pbusy, pcount = device_profile(
        lambda: with_plain_gather(lambda: l2_grads(case, target)), names, iters=1, warm=0)
    print(f"times, clustered backward: {case['name']} at {cfg.height}x{cfg.width}: "
          f"render_and_grad {summary(rg)}; with the plain-indexing route {summary(slow)} (host "
          f"clock to synchronize); on the device (torch.profiler): segment-sum route, mean of "
          f"5, all kernels {busy:.4f} ms in {count:.0f} launches, "
          + ", ".join(f"*{k}* {v:.4f} ms" for k, v in split.items())
          + f"; plain route, 1 call, all kernels {pbusy:.4f} ms in {pcount:.0f} launches, "
          + ", ".join(f"*{k}* {v:.4f} ms" for k, v in psplit.items()), flush=True)
    return counts[0]


#: the probe kernels' times before their redesign (chip_smoke.py through
#: tools/probe_segsum.py on an NVIDIA H100 80GB HBM3, 700 W, timed then by
#: one graph replay, not the median of 5): abt, then zeros_blocks at 960 and
#: 3,840 blocks
BEFORE_MS = {"abt": 0.2128, "zeros_blocks": {960: 0.0075, 3840: 0.0239}}


def probes_phase():
    """K9 and K10 against their plain versions, then the measurement tool.
    Returns (errs, launches, times, bound, library) keyed by kernel."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    errs = {"abt": 0.0, "zeros_blocks": 0.0}
    for m, n, k in PROBE.ABT_CASES:
        a = torch.randn((m, k), generator=gen).cuda().bfloat16()
        b = torch.randn((n, k), generator=gen).cuda().bfloat16()
        got, again, want = PR.abt_cuda(a, b), PR.abt_cuda(a, b), PR.abt_reference(a, b)
        err, top = float((got - want).abs().max()), float(want.abs().max())
        print(f"parity, probes: abt ({m}, {k}) x ({n}, {k}): max|d| {err:.3g} of max|ref| "
              f"{top:.3g} (allowed {PROBE.ABT_RTOL:g} of it: the order of an f32 sum); two "
              f"launches bit-equal: {torch.equal(got, again)}", flush=True)
        if not err <= PROBE.ABT_RTOL * top or not torch.equal(got, again):
            raise RuntimeError("abt disagrees with its plain version or with itself")
        errs["abt"] = max(errs["abt"], err)
    for nb, br, w in PROBE.ZERO_CASES:
        got = PR.zeros_blocks_cuda(nb, br, w, "cuda")
        want = PR.zeros_blocks_reference(nb, br, w, "cuda")
        if got.shape != want.shape or not torch.equal(got, want):
            raise RuntimeError(f"zeros_blocks({nb}, {br}, {w}) wrote something else than zeros")
    print(f"parity, probes: zeros_blocks at (nblocks, br, w) {PROBE.ZERO_CASES}: exact zeros",
          flush=True)

    PR.reset_launches()
    a, z = PROBE.report()      # the path these two kernels are on
    launches = {k: PR.launches[k] for k in ("abt", "zeros_blocks")}
    # abt: bf16 operands, so the tensor cores' rate; zeros_blocks only writes
    bound = {"abt": RL.bound_ms(a["bytes"], a["flops"], RL.PEAK_BF16_FLOPS),
             "zeros_blocks": RL.bound_ms(z[PROBE.ZERO_BLOCKS[0]]["bytes"], 0)}
    print(f"probes: launches in the tool's run {launches}; abt {a['ms']:.4f} ms (before the "
          f"redesign {BEFORE_MS['abt']} ms), torch.matmul {a['library_ms']:.4f} ms, bound "
          f"{bound['abt'][0]:.6f} ms by {bound['abt'][1]} ({a['bytes'] / 1e6:.2f} MB, "
          f"{a['flops'] / 1e6:.1f} MFLOP at {RL.PEAK_BF16_FLOPS / 1e12:g} TFLOP/s bf16); "
          + "; ".join(f"zeros_blocks at {nb} blocks {r['ms']:.4f} ms (before "
                      f"{BEFORE_MS['zeros_blocks'][nb]} ms), Tensor.zero_() "
                      f"{r['library_ms']:.4f} ms = {r['ms'] / r['library_ms']:.3f}x, bound "
                      f"{RL.bound_ms(r['bytes'], 0)[0]:.6f} ms by bytes "
                      f"({r['bytes'] / 1e6:.1f} MB)" for nb, r in z.items()), flush=True)
    z = z[PROBE.ZERO_BLOCKS[0]]
    times = {"abt": (a["ms"], a["plain_ms"]), "zeros_blocks": (z["ms"], z["plain_ms"])}
    library = {"abt": a["library_ms"], "zeros_blocks": z["library_ms"]}
    return errs, launches, times, bound, library


# ---------------------------------------------------------------------------
# the uniform grid, OBJ import and the verification tier: paths into the
# clustered kernels (K5, K8) from other plans and scenes
# ---------------------------------------------------------------------------
GRID_RUNS = 10          # timed calls a turn of the grid against the clusters plan


def reset_all():
    for mod in (MK, TV, SS, PR):
        mod.reset_launches()


def all_launches():
    return {**nonzero(MK.launches), **nonzero(TV.launches), **nonzero(SS.launches),
            **nonzero(PR.launches)}


def grid_phase(big4, target, worst):
    """Config 4 at 1024x1024 through prepare(accel="grid"): 3 frames, K5 on
    the grid's blocks against its brute-force plain version, the image
    against the clusters plan's, render_and_grad against the clusters plan's,
    and both plans timed in turns.  Returns the launch counts."""
    s4, c4 = big4["scene"], big4["cfg"]
    h, w = c4.height, c4.width
    grid = clustered_case("config 4 on the uniform grid", s4, c4, accel="grid")
    plan, packed = grid["plan"], grid["packed"]
    print(f"grid: config 4: {packed.n_clusters} grid blocks against {big4['packed'].n_clusters} "
          f"clusters ({packed.n_slots} slots against {big4['packed'].n_slots})", flush=True)

    frames = moved_frames(s4)
    reset_all()
    images = [tpurt_torch.render(s, c4, plan=plan) for s in frames]
    torch.cuda.synchronize()
    counts = all_launches()
    print(f"grid: config 4 at {h}x{w}, {FRAMES} frames: launches {counts}", flush=True)
    if counts != {"trace_records": FRAMES}:
        raise RuntimeError(f"grid frames launched {counts}, want {FRAMES} trace_records "
                           "and no plain version")
    check_images("grid frames", images, h, w)
    if torch.equal(images[0], images[1]):
        raise RuntimeError("moving the mesh did not change the grid's image")

    # K5 on the grid's blocks against brute force, on the clusters phase's sample
    pix = big4["sample"]
    got = TV.trace_records_cuda(packed, c4, 0, h, max_depth=0)
    o, d = TV._camera_rays(packed, c4, 0, h * w)
    o, d = o[pix].contiguous(), d[pix].contiguous()
    alive = torch.ones(pix.numel(), dtype=torch.bool, device="cuda")
    sample_parity("K5 config 4 on the uniform grid at 1024x1024", tuple(x[0] for x in got[:3]),
                  lambda: TV.trace_bounce_reference(packed, c4, o, d, alive)[:3], pix, worst,
                  "trace_records")

    # the two plans' images: the same triangles, the same arithmetic
    img_c = tpurt_torch.render(s4, c4, plan=big4["plan"])
    img_g = tpurt_torch.render(s4, c4, plan=plan)
    diff = (img_g - img_c).abs()
    over = int((diff > PIX_ATOL).any(-1).sum())
    allowed = math.floor(MAX_FLIP_SHARE * h * w)
    print(f"grid: config 4 at {h}x{w}, the grid's image against the clusters plan's: max|d| "
          f"{float(diff.max()):.3g}, pixels over {PIX_ATOL:g}: {over} (allowed {allowed})",
          flush=True)
    if over > allowed:
        raise RuntimeError("the grid and the clusters plan render different images")

    reset_all()
    (loss, image), grads = l2_grads(grid, target)
    torch.cuda.synchronize()
    rg_counts = all_launches()
    want = {"trace_records": 1, "sorted_segsum": segsums_a_backward(s4)}
    if rg_counts != want:
        raise RuntimeError(f"render_and_grad on the grid launched {rg_counts}, want {want}")
    check_images("grid render_and_grad", [image], h, w)
    (loss_c, _), grads_c = l2_grads(big4, target)
    ours, theirs = dict(MK.scene_float_leaves(grads)), dict(MK.scene_float_leaves(grads_c))
    gaps = {}
    for path, g in theirs.items():
        if not torch.isfinite(ours[path]).all():
            raise RuntimeError(f"grid gradient of {'.'.join(path)} is not finite")
        top = float(g.abs().max())
        if top > 0.0:
            gaps[path] = float((ours[path] - g).abs().max()) / top
    print(f"grid: render_and_grad (L2 loss {float(loss):.6g}, clusters plan {float(loss_c):.6g}) "
          f"launches {rg_counts}; leaves against the clusters plan's, share of max|g| (allowed "
          f"{CLUSTERED_GRAD_RTOL:g}): " + ", ".join(f"{'.'.join(k)} {v:.2g}"
                                                   for k, v in gaps.items()), flush=True)
    if max(gaps.values()) > CLUSTERED_GRAD_RTOL:
        raise RuntimeError("the grid's gradients disagree with the clusters plan's")

    # the two plans in turns: clusters, grid, grid, clusters
    turns = []
    for label, case in (("clusters", big4), ("grid", grid), ("grid", grid),
                        ("clusters", big4)):
        pk, pl = case["packed"], case["plan"]
        frame = median(host_ms(lambda: tpurt_torch.render(s4, c4, plan=pl), GRID_RUNS))
        rg = median(host_ms(lambda: l2_grads(case, target), GRID_RUNS))
        k5 = median(device_ms(lambda: TV.trace_records_cuda(pk, c4, 0, h, max_depth=0),
                              GRID_RUNS))
        _, busy, n = device_profile(lambda: tpurt_torch.render(s4, c4, plan=pl), (), iters=5)
        _, rg_busy, rg_n = device_profile(lambda: l2_grads(case, target), (), iters=5)
        turns.append(f"{label}: render {frame:.4f} ms host clock, {busy:.4f} device-ms in "
                     f"{n:.0f} launches; render_and_grad {rg:.4f} ms, {rg_busy:.4f} device-ms "
                     f"in {rg_n:.0f} launches; K5 {k5:.4f} ms")
    print(f"grid: config 4 at {h}x{w} in turns (host clock median of {GRID_RUNS} to "
          f"synchronize; device ms torch.profiler, mean of 5; K5 CUDA events, median of "
          f"{GRID_RUNS}): " + " | ".join(turns), flush=True)
    return {"trace_records": FRAMES + 1, "sorted_segsum": want["sorted_segsum"]}


OBJ_SIZE = 512


def obj_phase():
    """Config 4's mesh (subdiv 4) written with save_obj and read back with
    scene_from_obj on the card, with config 4's materials, lights and camera:
    its render against the original's, and the C++ parse against the numpy
    parse.  Returns the launch counts."""
    scene, cfg = configs.config4_bunny(OBJ_SIZE, OBJ_SIZE, subdiv=4)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/config4.obj"
        t0 = time.perf_counter()
        OBJ.save_obj(path, scene.vertices.cpu().numpy(), scene.triangles.cpu().numpy(),
                     tri_group=scene.tri_mat.cpu().numpy())
        t1 = time.perf_counter()
        cpp = OBJ.load_obj(path)
        t2 = time.perf_counter()
        with open(path) as f:
            plain = OBJ.parse_obj_lines(f)
        t3 = time.perf_counter()
        # the groups come back in order of first use: "default", then mat<id>
        rows = torch.tensor([int(g[3:]) if g.startswith("mat") else 0 for g in cpp["groups"]],
                            device="cuda")
        m = scene.materials
        mats = Materials(ka=m.ka[rows], kd=m.kd[rows], ks=m.ks[rows], shininess=m.shininess[rows],
                         reflectivity=m.reflectivity[rows], texture_id=m.texture_id[rows])
        lights = list(zip(scene.light_pos.tolist(), scene.light_color.tolist()))
        loaded = OBJ.scene_from_obj(path, materials=mats, lights=lights, camera=scene.camera,
                                    smooth=scene.smooth, device="cuda")
    same = all(np.array_equal(cpp[k], plain[k])
               for k in ("vertices", "triangles", "uvs", "tri_group"))
    same = same and cpp["normals"] is None and plain["normals"] is None \
        and cpp["groups"] == plain["groups"]
    print(f"obj: config 4 (subdiv 4, {scene.n_tris} triangles): save_obj {t1 - t0:.2f} s, "
          f"the C++ parse {t2 - t1:.3f} s, the numpy parse {t3 - t2:.2f} s; equal arrays: "
          f"{same}; groups {cpp['groups']}", flush=True)
    if not same:
        raise RuntimeError("the C++ and numpy parses of the .obj disagree")
    plan = tpurt_torch.prepare(loaded, cfg)
    reset_all()
    img = tpurt_torch.render(loaded, cfg, plan=plan)
    torch.cuda.synchronize()
    counts = all_launches()
    if plan.kind != "clusters" or counts != {"trace_records": 1}:
        raise RuntimeError(f"the .obj scene planned as {plan.kind}, launched {counts}: want "
                           "one trace_records")
    ref = tpurt_torch.render(scene, cfg)
    check_images("obj scene", [img], OBJ_SIZE, OBJ_SIZE)
    diff = (img - ref).abs()
    over = int((diff > PIX_ATOL).any(-1).sum())
    allowed = math.floor(MAX_FLIP_SHARE * OBJ_SIZE * OBJ_SIZE)
    print(f"obj: the .obj scene at {OBJ_SIZE}x{OBJ_SIZE} against the original's render: "
          f"launches {counts}; max|d| {float(diff.max()):.3g}, pixels over {PIX_ATOL:g}: "
          f"{over} (allowed {allowed})", flush=True)
    if over > allowed:
        raise RuntimeError("the .obj round trip renders another image")
    return counts


def verify_phase():
    """tools/verify.py in this process: every case must pass."""
    t0 = time.perf_counter()
    record = VERIFY.run("cuda")
    print(json.dumps(record), flush=True)
    print(f"verify: {record['value']} {record['unit']} cases passed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if record["value"] != len(record["cases"]):
        raise RuntimeError("verify: " + ", ".join(r["case"] for r in record["cases"]
                                                  if not r["ok"]) + " failed")


# (bench's arguments, the kernels the run must launch)
BENCH_RUNS = (
    (["--config", "3"], {"l2_hand", "megakernel_fwd"}),
    (["--config", "4"], {"trace_records", "sorted_segsum"}),
    (["--config", "5"], {"trace_records", "sorted_segsum"}),
    (["--config", "3", "--mode", "fwd"], {"megakernel_fwd"}),
    (["--config", "3", "--mesh", "1", "--backend", "nccl"], {"megakernel_fwd", "megakernel_bwd"}),
    (["--config", "4", "--res", "1024x1024", "--mode", "fwd", "--scene-shard", "2",
      "--backend", "gloo", "--iters", "2", "--warmup", "1"], {"trace_bounce", "trace_shadows"}),
)


def bench_phase(big4, big5):
    """tools/bench.py's main in this process, once for each of BENCH_RUNS:
    the counts and the launches checked.  Returns the launches of every run
    (the ranks' included), summed."""
    t_start = time.perf_counter()
    s3, c3 = configs.config3_spheres(8, 8)
    scene_of = {3: s3, 4: big4["scene"], 5: big5["scene"]}
    cfg_of = {3: c3, 4: big4["cfg"], 5: big5["cfg"]}
    total = {}
    for argv, want in BENCH_RUNS:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            record, launches = BENCH.main(argv)
        line = out.getvalue().splitlines()[-1]
        print(f"bench: {line}", flush=True)
        args = BENCH.parser().parse_args(argv)
        h, w = (int(x) for x in args.res.split("x"))
        nominal = BENCH.count_rays(cfg_of[args.config].replace(height=h, width=w),
                                   scene_of[args.config])
        traced = record["rays_traced"]
        ok_count = (traced == nominal if args.config == 3 else 0 < traced <= nominal)
        if json.loads(line) != record or record["rays_nominal"] != nominal or not ok_count:
            raise RuntimeError(f"bench {' '.join(argv)}: rays nominal {record['rays_nominal']} "
                               f"(count_rays {nominal}), traced {traced}")
        if not want <= set(launches) or not set(launches) <= set(SOURCES):
            raise RuntimeError(f"bench {' '.join(argv)} launched {launches}: want {want} and "
                               "no plain version")
        print(f"bench: {' '.join(argv)}: launches {launches}", flush=True)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    print(f"bench: on {DIST.card()}: {len(BENCH_RUNS)} runs in "
          f"{time.perf_counter() - t_start:.1f} s; launches {total}", flush=True)
    return total


SOURCES = {
    "megakernel_fwd": ("tpurt_torch/kernels/csrc/megakernel_fwd.cu",
                       "tpurt/kernels/megakernel.py:423"),
    "megakernel_bwd": ("tpurt_torch/kernels/csrc/megakernel_bwd.cu",
                       "tpurt/kernels/megakernel.py:438"),
    "l2_fused": ("tpurt_torch/kernels/csrc/megakernel_bwd.cu",
                 "tpurt/kernels/megakernel.py:470"),
    "l2_hand": ("tpurt_torch/kernels/csrc/megabwd_hand.cu",
                "tpurt/kernels/megabwd.py:727"),
    # the three modes of one TPU kernel body
    "trace_records": ("tpurt_torch/kernels/csrc/traversal.cu",
                      "tpurt/kernels/traversal.py:260"),
    "trace_bounce": ("tpurt_torch/kernels/csrc/traversal.cu",
                     "tpurt/kernels/traversal.py:260"),
    "trace_shadows": ("tpurt_torch/kernels/csrc/traversal.cu",
                      "tpurt/kernels/traversal.py:260"),
    "sorted_segsum": ("tpurt_torch/kernels/csrc/segsum.cu", "tpurt/kernels/segsum.py:61"),
    "abt": ("tpurt_torch/kernels/csrc/probes.cu", "scripts/probe_segsum.py:49"),
    "zeros_blocks": ("tpurt_torch/kernels/csrc/probes.cu", "scripts/probe_segsum.py:80"),
}


def main():
    device_phase()
    build_phase()
    packed3, cfg3, fwd_err = parity_phase()
    fwd_launches, fwd_ms, fwd_plain_ms = main_phase(packed3, cfg3)
    errs = backward_parity_phase()
    large_table_phase()
    launches, train_state = train_phase()
    times = times_phase(packed3, cfg3, train_state)
    bound = bounds(packed3, cfg3, cfg3.height * cfg3.width)
    errs["megakernel_fwd"] = fwd_err
    launches["megakernel_fwd"] = fwd_launches
    times["megakernel_fwd"] = (fwd_ms, fwd_plain_ms)
    big4, big5 = big_scenes()
    trav_errs, k5_plain_ms = traversal_parity_phase(big4, big5)
    mirror = mirror_case(big5)
    trav_launches, sphere_case = clustered_main_phase(big4, big5, mirror)
    launches.update(trav_launches)
    trav_times, trav_bound = clustered_times_phase(big4, big5, mirror, trav_errs, k5_plain_ms)
    errs.update(trav_errs)
    times.update(trav_times)
    bound.update(trav_bound)
    targets = {"config 4": moved_case(big4, (0.04, 0.02, -0.03)),
               "config 5": moved_case(big5, (0.02, 0.01, -0.015))}
    seg_errs, streams = segsum_parity_phase(big4, big5, targets)
    bwd_launches, step = clustered_backward_phase(big4, big5, targets)
    # trace_records is on this path too: its count is that of both main paths
    launches["trace_records"] += bwd_launches["trace_records"]
    launches["sorted_segsum"] = bwd_launches["sorted_segsum"]
    seg_times, seg_bound, library = clustered_backward_times_phase(big4, big5, targets, streams,
                                                                  step)
    # the grid and the .obj scene drive K5 and K8 from other plans and scenes
    grid_launches = grid_phase(big4, targets["config 4"], errs)
    obj_launches = obj_phase()
    for got in (grid_launches, obj_launches):
        for k, n in got.items():
            launches[k] += n
    verify_phase()
    # the sphere table's segment sums run on this path: its launches count too
    sph_launches = sphere_backward_phase(sphere_case)
    for k in ("sorted_segsum", "trace_records", "trace_bounce"):
        launches[k] += sph_launches.get(k, 0)
    probe_errs, probe_launches, probe_times, probe_bound, probe_library = probes_phase()
    for got, new in ((errs, seg_errs), (errs, probe_errs), (launches, probe_launches),
                     (times, seg_times), (times, probe_times), (bound, seg_bound),
                     (bound, probe_bound), (library, probe_library)):
        got.update(new)
    # the ranks of a mesh run K1, K2, K5 and K8 on their rows
    dist_launches, _ = DIST.run("cuda", world1_backend="nccl", backend="gloo")
    for k, n in dist_launches.items():
        if k not in SOURCES:
            raise RuntimeError(f"the mesh's main path launched {k}: a plain version on the card")
        launches[k] += n
    # the ranks of the ring run K6, K7 and K8 on their shards
    ring_launches, ring_errs, _ = RING.run("cuda", backend="gloo")
    for k, n in ring_launches.items():
        if k not in SOURCES:
            raise RuntimeError(f"the ring's main path launched {k}: a plain version on the card")
        launches[k] += n
    errs["trace_bounce"] = max(errs["trace_bounce"], ring_errs["trace_bounce"])
    # the benchmark command's routes, one device, the mesh and the ring
    for k, n in bench_phase(big4, big5).items():
        launches[k] += n
    for name in SOURCES:
        if launches[name] < 1:
            raise RuntimeError(f"{name} was not launched on the main paths")
        # no kernel beats the least time the card needs: one that does has a
        # bound that counts work the function does not need
        if times[name][0] < bound[name][0]:
            raise RuntimeError(f"{name} took {times[name][0]:.6f} ms, below its bound "
                               f"{bound[name][0]:.6f} ms")
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": errs[name],
        "ms": times[name][0],
        "plain_ms": times[name][1],
        "bound_ms": bound[name][0],
        "bound_by": bound[name][1],
        # index_add_, torch.matmul, Tensor.zero_(); no single PyTorch call
        # computes what the other kernels do
        "library_ms": library.get(name),
    } for name, (source, replaces) in SOURCES.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
