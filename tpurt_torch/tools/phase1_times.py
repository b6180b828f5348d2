"""Time the phase-1 kernels on an NVIDIA card: K1 ``megakernel_fwd`` on
configs 1, 2 and 3 at ``chip_smoke.py``'s sizes (256², 512², 1080×1920), K2
``megakernel_bwd``, K3 ``l2_fused`` and K4 ``l2_hand`` at config 3
1080×1920, ``render()`` and the config-3 train step, with the kernels'
registers and stack frames from the build and their static SASS instruction
counts (``cuobjdump -sass``, where it is on PATH or beside nvcc).

    python3 -m tpurt_torch.tools.phase1_times [--iters N] [--spheres S] [--pieces DIR]

Kernels: K1 in a CUDA graph of 20 calls, the median of 5 replays (its
smaller launches take less than the host needs to launch them); the backward
kernels by CUDA events around each wrapper call (the kernel and what the
wrapper launches after it: ``reduce_rows``, and on a table beyond the
shared-memory route the records' sort and segment sum), median of N after
two warm-up calls, and whether two calls give the same bits.  With
``--spheres S`` the kernels take config 3 with S small spheres more
(``many_spheres``), a table beyond the shared-memory route, and neither
configs 1–2 nor the step are timed.  Step: ``make_train_step``'s step on the
host clock up to ``torch.cuda.synchronize()`` (median and p90 of N), and the
device time of all its kernels and of ``l2_hand`` alone (torch.profiler,
mean of 20 steps); ``render()`` the same way.

``--pieces DIR``: instead of timing, count the forward body's pieces
(``phase1_probes.cu`` beside this file, one probe kernel a piece, compiled
with the library's nvcc flags against the imported package's ``csrc``): a
triangle test, a sphere test, one light's shading, ray generation, the
specular power, the division, reciprocal, sqrtf and powf sequences; each
piece's instructions, its CALLs and the instructions of the subroutines
they reach.  Then an estimate of the instructions a pixel of config 3 at
1080×1920 runs: each piece's count (its subroutines left out) times how
often ``MK.path_counts`` says the paths run it, every shadow ray taken to
test every primitive.  The SASS listings go to DIR.

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
import re
import shutil
import statistics
import subprocess
import time
from pathlib import Path

import torch

import tpurt_torch
from tpurt_torch.dist.train import make_train_step
from tpurt_torch.kernels import build
from tpurt_torch.kernels import megabwd as MB
from tpurt_torch.kernels import megakernel as MK
from tpurt_torch.kernels.pack import pack_scene
from tpurt_torch.scene import configs
from tpurt_torch.tools.probe_segsum import device_ms as graph_ms

PHASE1 = ("megakernel_fwd", "megakernel_bwd", "l2_fused", "l2_hand", "reduce_rows")
TABLES = ("globals", "tri_forms", "sph_forms", "attrs")
#: K1's cases: chip_smoke.py's parity sizes
K1_CASES = ((1, 256, 256), (2, 512, 512), (3, 1080, 1920))
#: the probe kernels of phase1_probes.cu
PIECES = ("base", "tri_test", "sph_test", "light", "raygen", "spec_pow", "powf", "div", "rcp",
          "sqrtf", "rsqrtf")


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


def cuobjdump():
    """cuobjdump on PATH, else beside nvcc; None where there is neither."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    try:
        beside = Path(build.find_nvcc()).parent / "cuobjdump"
    except RuntimeError:
        return None
    return str(beside) if beside.is_file() else None


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")
_ENCODING = re.compile(r"^\s*/\* 0x[0-9a-f]{16} \*/\s*$")  # an instruction's second word
_TARGET = re.compile(r"CALL\.REL(?:\.NOINC)?\s+(0x[0-9a-f]+)")


def sass_functions(listing: str) -> dict:
    """{function: its instructions, as listed with their encodings} of a
    ``cuobjdump -sass`` listing."""
    out, name = {}, None
    for line in listing.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = []
        elif name and (_INSN.search(line) or _ENCODING.match(line)):
            out[name].append(line.strip())
    return out


def sass_counts(listing: str) -> dict:
    """{function: {"instructions", "calls", "subroutines"}} from a
    ``cuobjdump -sass`` listing: instructions other than NOP; CALL
    instructions; and the instructions at or beyond the first CALL's target
    (the subroutines the compiler places after the body)."""
    out = {}
    for name, lines in sass_functions(listing).items():
        insns = [(int(m.group(1), 16), m.group(2), t and int(t.group(1), 16))
                 for m, t in ((_INSN.search(x), _TARGET.search(x)) for x in lines)
                 if m and m.group(2) != "NOP"]
        targets = [t for _, _, t in insns if t is not None]
        first = min(targets) if targets else None
        out[name] = {"instructions": len(insns),
                     "calls": sum(op.startswith("CALL") for _, op, _ in insns),
                     "subroutines": 0 if first is None else sum(a >= first for a, _, _ in insns)}
    return out


def sass_of(path) -> str:
    """The ``cuobjdump -sass`` listing of a library or cubin ("" without
    cuobjdump)."""
    tool = cuobjdump()
    if tool is None:
        return ""
    return subprocess.run([tool, "-sass", str(path)], check=True, capture_output=True,
                          text=True, timeout=300).stdout


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


def pieces(out_dir: Path):
    """{piece: sass_counts entry} of each probe kernel of phase1_probes.cu,
    compiled with the library's flags against the imported package's csrc
    (-DTPURT_LEGACY_PHASE1 where it has no phase1_math.cuh); and the
    compiler's log.  The listing is written to out_dir."""
    csrc = Path(build.__file__).resolve().parent / "csrc"
    legacy = not (csrc / "phase1_math.cuh").exists()
    out_dir.mkdir(parents=True, exist_ok=True)
    cubin = out_dir / "phase1_probes.cubin"
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    cmd = [build.find_nvcc(), *flags, "-cubin", "-I", str(csrc),
           *(["-DTPURT_LEGACY_PHASE1"] if legacy else []), "-o", str(cubin),
           str(Path(__file__).resolve().parent / "phase1_probes.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on the probes:\n{done.stdout}{done.stderr}")
    listing = sass_of(cubin)
    if not listing:
        raise RuntimeError("--pieces needs cuobjdump")
    (out_dir / "phase1_probes.sass").write_text(listing)
    counts = sass_counts(listing)
    return {name: counts[f"probe_{name}"] for name in PIECES}, done.stdout + done.stderr


def pixel_estimate(counts: dict, paths: dict, packed, cfg, n_pix: int) -> dict:
    """Instructions a pixel by part of the forward: each piece's instructions
    less its subroutines and less the base probe's, times how often the
    paths (MK.path_counts) run it; every shadow ray is taken to test every
    primitive, as an unblocked one does."""
    base = counts["base"]["instructions"]
    body = {k: v["instructions"] - v["subroutines"] - base for k, v in counts.items()}
    T, S, L = packed.n_tris, packed.n_spheres, packed.n_lights
    rays = sum(paths["rays"])
    shaded = sum(paths["shaded_tri"]) + sum(paths["shaded_sph"])
    test = T * body["tri_test"] + S * body["sph_test"]
    parts = {"raygen": n_pix * body["raygen"], "closest-hit tests": rays * test,
             "light shading": shaded * L * body["light"],
             "shadow tests": shaded * L * test if cfg.shadows else 0}
    return {k: v / n_pix for k, v in parts.items()}


def host_and_device(fn, iters, kernel=None, profiled=20):
    """fn() on the host clock up to torch.cuda.synchronize() (median and p90
    of iters after three warm-up calls), and the device time and launches of
    all its kernels, and of `kernel`'s alone where given (torch.profiler,
    mean of `profiled` calls)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    ms.sort()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if "CUDA" in str(getattr(e, "device_type", ""))]
    out = {"median": statistics.median(ms), "p90": ms[math.ceil(len(ms) * 0.9) - 1],
           "device": sum(e.self_device_time_total for e in events) / profiled / 1e3,
           "launches": sum(e.count for e in events) / profiled}
    if kernel:
        out[f"{kernel}_device"] = sum(e.self_device_time_total for e in events
                                      if kernel in e.key) / profiled / 1e3
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--spheres", type=int, default=0,
                    help="small spheres added to config 3 for the kernels; skips the step")
    ap.add_argument("--pieces", type=Path, default=None,
                    help="count the forward body's pieces, listings into this directory")
    ap.add_argument("--same-sass", type=Path, default=None,
                    help="say, kernel by kernel, whether another build of the library "
                         "compiled to the same SASS as this one")
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
    sass = {k: v for k, v in sass_counts(sass_of(so)).items() if any(f in k for f in PHASE1)}
    for name, c in sass.items():
        print(f"sass: {name}: {c['instructions']} instructions, {c['calls']} CALL "
              f"({c['subroutines']} in the subroutines they reach)", flush=True)
    result["sass"] = sass
    if args.same_sass:
        mine, other = (sass_functions(sass_of(p)) for p in (so, args.same_sass))
        same = {k: mine[k] == other[k] for k in sorted(mine.keys() & other.keys())}
        for k, v in same.items():
            print(f"same sass as {args.same_sass}: {k}: {'identical' if v else 'differs'}",
                  flush=True)
        result["same_sass"] = same
        print(json.dumps(result))
        return

    h, w = 1080, 1920
    if args.pieces:
        counts, log = pieces(args.pieces)
        print(log.strip(), flush=True)
        for name, c in counts.items():
            print(f"piece: {name}: {c['instructions']} instructions, {c['calls']} CALL "
                  f"({c['subroutines']} in the subroutines they reach)", flush=True)
        scene, cfg = configs.config3_spheres(h, w)
        packed = pack_scene(scene)
        paths = MK.path_counts(packed, cfg, 0, h * w)
        est = pixel_estimate(counts, paths, packed, cfg, h * w)
        print(f"paths of config 3 at {h}x{w}: {paths}", flush=True)
        print("estimate a pixel: " + ", ".join(f"{k} {v:.1f}" for k, v in est.items())
              + f"; total {sum(est.values()):.1f} instructions", flush=True)
        result.update(pieces=counts, paths=paths, estimate=est)
        print(json.dumps(result))
        return

    k1 = {}
    for k, kh, kw in (() if args.spheres else K1_CASES):
        kscene, kcfg = configs.ALL_CONFIGS[k](kh, kw)
        kpacked = pack_scene(kscene)
        ms = graph_ms(lambda: MK.megakernel_fwd_cuda(kpacked, kcfg, 0, kh * kw))
        k1[f"config {k} at {kh}x{kw}"] = ms
        print(f"config {k} at {kh}x{kw}: megakernel_fwd {ms:.4f} ms (a CUDA graph of 20 "
              f"calls, median of 5 replays)", flush=True)
    n_pix = h * w
    scene, cfg = (many_spheres(h, w, args.spheres) if args.spheres
                  else configs.config3_spheres(h, w))
    packed = pack_scene(scene)
    case = f"config 3 with {args.spheres} small spheres more" if args.spheres else "config 3"
    result["case"] = {"name": case, "table_floats": MK.table_floats(packed)}
    gen = torch.Generator(device="cpu").manual_seed(0)
    g = (torch.rand((3, n_pix), generator=gen) - 0.5).cuda()
    tgt = torch.rand((3, n_pix), generator=gen).cuda()
    if args.spheres:
        ms = graph_ms(lambda: MK.megakernel_fwd_cuda(packed, cfg, 0, n_pix))
        k1[f"{case} at {h}x{w}"] = ms
        print(f"{case} at {h}x{w}: megakernel_fwd {ms:.4f} ms (a CUDA graph of 20 calls, "
              f"median of 5 replays)", flush=True)
    result["megakernel_fwd"] = k1
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

    render = host_and_device(lambda: tpurt_torch.render(scene, cfg), args.iters)
    result["render"] = render
    print(f"config 3 at {h}x{w}: render median {render['median']:.4f} ms, p90 "
          f"{render['p90']:.4f} ms (n={args.iters}, host clock to synchronize); device "
          f"{render['device']:.4f} ms in {render['launches']:.0f} launches (torch.profiler, "
          f"mean of 20)", flush=True)

    moved, _ = configs.config3_spheres(h, w)
    moved.sph_center = moved.sph_center + torch.tensor([0.1, 0.0, -0.06], device="cuda")
    target = tpurt_torch.render(moved, cfg)
    step = make_train_step(cfg)
    result["train_step"] = step_times = host_and_device(
        lambda: step(scene, target, 0.1), args.iters, kernel="l2_hand")
    print(f"config 3 at {h}x{w}: train step median {step_times['median']:.4f} ms, p90 "
          f"{step_times['p90']:.4f} ms (n={args.iters}, host clock to synchronize); "
          f"device {step_times['device']:.4f} ms in {step_times['launches']:.0f} launches, of "
          f"which l2_hand {step_times['l2_hand_device']:.4f} ms (torch.profiler, mean of 20)",
          flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
