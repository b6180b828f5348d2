"""Measurements behind the segment-sum design, on an NVIDIA card (the
counterpart of ``scripts/probe_segsum.py``, at its sizes).

    python3 -m tpurt_torch.tools.probe_segsum
    python3 -m tpurt_torch.tools.probe_segsum --streams [--save F | --load F]

  1. abt: the A·Bᵀ probe kernel, (8, 1536) by (512, 1536) bf16: error against
     its plain version, time, and the time of ``torch.matmul``.
  2. zeros_blocks: the zero-writing probe kernel at 960 and 3840 blocks of
     (8, 512): µs a block, against ``Tensor.zero_()`` on the same buffer.
  3. gather rates (ns a row): a coherent wide gather (2,073,600 rows of 25
     columns), permutation gathers of (n, 8) rows, a static-order gather of
     (3 T, 8) rows from a (T, 8) table, and the last again from a view of a
     (T, 9) table.
  4. stable argsort at 196,608 / 589,824 / 2,073,600 / 6,220,800 int32 keys
     (the last is the update stream of a 1080×1920 frame's backward).

With ``--streams``, instead: the sorted segment sum (K8) on every update
stream that the main paths' backward hands it (``main_path_streams``:
render_and_grad with an L2 loss on config 4 at 1024×1024, config 5 at
1080×1920 and config 3 through clusters at 1080×1920), each with its count,
width, rows, runs, longest run and bound, K8's time through the sort's
positions split into its first pass and its later passes (torch.profiler),
K8 on a sorted copy, the stable sort, ``segsum_rows`` and ``index_add_``
(``stream_times``).  ``--save`` keeps the streams in a file and ``--load``
reads them back, so that the tool can time several checkouts in turns (run
it by path with PYTHONPATH at each) on the same streams; it uses only entry
points that the kernel's first version had.

Every function raises on failure; the times are device times (CUDA events
around a CUDA graph of 20 calls, the median of 5 replays after 5 that warm
up) on the current card, which ``main`` names
with its power limit.  Needs a card: there is no
CPU fallback for a measurement.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from tpurt_torch.kernels import probes
from tpurt_torch.utils import roofline

ABT_SHAPES = ((8, 1536), (512, 1536))
ZERO_BLOCKS = (960, 3840)
ZERO_TILE = (512, 8)             # br, w
N_TRIS, N_VERTS = 983042, 491548  # the largest scene's tables
N_PIXELS = 2073600
PERM_ROWS = (196608, 589824)
ARGSORT_KEYS = (196608, 589824, 2073600, 6220800)
#: abt against its plain version: only the order of the f32 sum differs
ABT_RTOL = 1e-3
#: (m, n, k) at which the card tests and chip_smoke.py hold abt to its plain
#: version: the probe's shape, tiny ones, and shapes that cut each tail: n and
#: m off the 8-row tiles, k off a 32-column chunk, k off 8 (the element-load
#: instantiation)
ABT_CASES = ((8, 512, 1536), (3, 5, 7), (1, 1, 1), (33, 70, 129), (8, 9, 1536), (8, 16, 24),
             (5, 12, 40), (17, 33, 64))
#: (nblocks, br, w) of zeros_blocks held to exact zeros: 16-byte stores where
#: br % 4 == 0, 4-byte ones otherwise
ZERO_CASES = ((960, 512, 8), (3, 5, 2), (1, 1, 1), (7, 4, 8), (5, 6, 3), (960, 512, 3))


def device_ms(fn, reps=20, runs=5):
    """Device ms of one fn(): `reps` calls captured into a CUDA graph, the
    median over `runs` replays of it, each between two CUDA events, after
    `runs` replays that warm the card up.  Several of these calls take a few
    microseconds on the card, less than the host needs to launch them, so
    events around eager calls would time the host; a graph replays them back
    to back.  One replay of calls of a few microseconds moved by up to 10%
    between measurements on an H100 (PERF.md)."""
    fn()                                  # builds, handles and workspaces first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    for _ in range(runs):
        graph.replay()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(runs)]
    for start, end in events:
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events) / reps


def synthetic_stream(kind: str, n: int, n_rows: int, width: int, seed: int, device="cpu"):
    """An unsorted update stream (idx (n,) int32, upd (n, width) f32) made
    from a numpy seed.  Kinds: "uniform" (rows drawn evenly, so some stay
    empty), "dominant" (one row holds half the stream), "out_of_range" (a
    third of the entries below 0 or at and above n_rows), "sparse" (a few
    rows far apart, long empty stretches)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, max(n_rows, 1), n)
    if kind == "dominant":
        idx[rng.random(n) < 0.5] = n_rows // 3
    elif kind == "out_of_range":
        r = rng.random(n)
        idx[r < 0.15] = -1 - rng.integers(0, 5, int((r < 0.15).sum()))
        idx[r > 0.85] = n_rows + rng.integers(0, 5, int((r > 0.85).sum()))
    elif kind == "sparse":
        idx = (idx % 7) * max(n_rows // 7, 1)
    elif kind != "uniform":
        raise ValueError(f"unknown stream kind {kind!r}")
    upd = rng.standard_normal((n, width)).astype(np.float32)
    return (torch.from_numpy(idx.astype(np.int32)).to(device),
            torch.from_numpy(upd).to(device))


def sum_gap(got, want, idx_sorted, upd_sorted, n_rows: int, serial_f32: bool = False) -> float:
    """Largest |got - want| over what is allowed, element by element; at most
    1 where the two agree.  Allowed: rtol 1e-5 and atol 1e-6·max(1, max|want|)
    (the bar tpurt holds its own segment sum to), the atol widened on a row
    that sums so much that f32 cannot do better, to 1e-6 of the row's summed
    |update| (a row of 100,000 updates of size 1 keeps 7 digits of 80,000,
    not of its sum of 300).  `serial_f32`: one side is an f32 sum that adds a
    row's n updates one after another (index_add_); its rounding errors walk
    to about 2^-24·sqrt(n) of the summed |update|, which is allowed on top
    (1.9e-6 of it was seen on a row of 386,000 updates, where the kernel, which
    adds 512 at a time, kept 3e-8)."""
    from tpurt_torch.kernels.segsum import sorted_segsum_reference

    mass = sorted_segsum_reference(idx_sorted, upd_sorted.abs().double(), n_rows)
    want = want.double()
    top = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    allowed = 1e-5 * want.abs() + 1e-6 * mass.clamp_min(top)
    if serial_f32:
        count = sorted_segsum_reference(
            idx_sorted, torch.ones((idx_sorted.numel(), 1), dtype=torch.float64,
                                   device=idx_sorted.device), n_rows)
        allowed = allowed + 2.0 ** -24 * count.sqrt() * mass
    gap = (got.double() - want).abs() / allowed
    # NaN and Inf must sit in the same places
    same = (got.double() == want) | (torch.isnan(got) & torch.isnan(want))
    gap = torch.where(same, 0.0, gap).nan_to_num(nan=float("inf"))
    return float(gap.max()) if gap.numel() else 0.0


def _need_card():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: the probes measure a card")
    return torch.device("cuda")


def probe_abt():
    """{"max_abs_err", "max_ref", "ms", "plain_ms", "library_ms", "bytes",
    "flops"} of the abt kernel at the probe's shape."""
    dev = _need_card()
    a, b = (torch.from_numpy(np.random.default_rng(s).standard_normal(shape).astype(np.float32))
            .to(dev).to(torch.bfloat16) for s, shape in enumerate(ABT_SHAPES))
    out, ref = probes.abt_cuda(a, b), probes.abt_reference(a, b)
    torch.cuda.synchronize()
    err, top = float((out - ref).abs().max()), float(ref.abs().max())
    if not err <= ABT_RTOL * top:
        raise RuntimeError(f"abt: max error {err:.3e} over {ABT_RTOL:g} of max|ref| {top:.3e}")
    (m, k), (n, _) = ABT_SHAPES
    return {"max_abs_err": err, "max_ref": top,
            "ms": device_ms(lambda: probes.abt_cuda(a, b)),
            "plain_ms": device_ms(lambda: probes.abt_reference(a, b)),
            "library_ms": device_ms(lambda: torch.matmul(a, b.t())),
            "bytes": 2 * (m * k + n * k) + 4 * m * n, "flops": 2 * m * n * k}


def probe_zeros_blocks():
    """{nblocks: {"ms", "us_per_block", "plain_ms", "library_ms", "bytes"}} of
    the zero-writing kernel."""
    dev = _need_card()
    br, w = ZERO_TILE
    out = {}
    for nb in ZERO_BLOCKS:
        got = probes.zeros_blocks_cuda(nb, br, w, dev)
        torch.cuda.synchronize()
        if got.shape != (w, nb * br) or bool((got != 0).any()):
            raise RuntimeError(f"zeros_blocks({nb}, {br}, {w}) is not all zeros")
        buf = torch.empty_like(got)
        ms = device_ms(lambda: probes.zeros_blocks_cuda(nb, br, w, dev))
        out[nb] = {"ms": ms, "us_per_block": ms / nb * 1e3,
                   "plain_ms": device_ms(lambda: probes.zeros_blocks_reference(nb, br, w, dev)),
                   "library_ms": device_ms(buf.zero_), "bytes": 4 * w * nb * br}
    return out


def probe_gathers():
    """{name: (ms, ns a row)} of the row gathers."""
    dev = _need_card()
    rng = np.random.default_rng(0)
    out = {}

    def rate(name, table, index):
        ms = device_ms(lambda: table.index_select(0, index))
        out[name] = (ms, ms / index.numel() * 1e6)

    # the shading forward's shape: sorted ids in runs of two
    pid = np.repeat(np.sort(rng.integers(0, N_TRIS, N_PIXELS * 2 // 3)), 2)[:N_PIXELS]
    rate(f"gather ({N_PIXELS}, 25) coherent", torch.randn((N_TRIS, 25), device=dev),
         torch.from_numpy(pid).to(dev))
    for n in PERM_ROWS:
        rate(f"permutation gather ({n}, 8)", torch.randn((n, 8), device=dev),
             torch.from_numpy(rng.permutation(n)).to(dev))
    order = torch.from_numpy(rng.permutation(3 * N_TRIS) % N_TRIS).to(dev)
    rate(f"static-order gather ({3 * N_TRIS}, 8) of ({N_TRIS}, 8)",
         torch.randn((N_TRIS, 8), device=dev), order)
    # not in the original: PyTorch sends contiguous rows of a multiple of 16
    # bytes to another kernel than rows of any other size or stride
    rate(f"the same from an 8-column view of a ({N_TRIS}, 9) table",
         torch.randn((N_TRIS, 9), device=dev)[:, :8], order)
    return out


def probe_argsort():
    """{n: (ms, ns a key)} of a stable argsort of n int32 keys below N_VERTS."""
    dev = _need_card()
    rng = np.random.default_rng(0)
    out = {}
    for n in ARGSORT_KEYS:
        keys = torch.from_numpy(rng.integers(0, N_VERTS, n).astype(np.int32)).to(dev)
        order = torch.argsort(keys, stable=True)
        if bool((keys[order][1:] < keys[order][:-1]).any()):
            raise RuntimeError(f"argsort of {n} keys is not ascending")
        ms = device_ms(lambda: torch.argsort(keys, stable=True))
        out[n] = (ms, ms / n * 1e6)
    return out


def report():
    """Run the four measurements and print a line each; returns (abt, zeros)
    for a caller that keeps the kernels' numbers."""
    a = probe_abt()
    print(f"probes: abt {ABT_SHAPES[0]} x {ABT_SHAPES[1]} bf16: max error "
          f"{a['max_abs_err']:.3e} of max|ref| {a['max_ref']:.3e} (bar {ABT_RTOL:g}); kernel "
          f"{a['ms']:.4f} ms, plain version {a['plain_ms']:.4f} ms, torch.matmul "
          f"{a['library_ms']:.4f} ms", flush=True)
    z = probe_zeros_blocks()
    for nb, r in z.items():
        print(f"probes: zeros_blocks nblocks={nb} {ZERO_TILE[::-1]} tiles: {r['ms']:.4f} ms = "
              f"{r['us_per_block']:.4f} us a block; plain version {r['plain_ms']:.4f} ms, "
              f"Tensor.zero_() {r['library_ms']:.4f} ms", flush=True)
    for name, (ms, ns) in probe_gathers().items():
        print(f"probes: {name}: {ms:.4f} ms = {ns:.3f} ns a row", flush=True)
    for n, (ms, ns) in probe_argsort().items():
        print(f"probes: stable argsort of {n} int32 keys: {ms:.4f} ms = {ns:.3f} ns a key",
              flush=True)
    return a, z


def main_path_streams():
    """{"case, table": (idx, upd, n_rows)} of every segsum_rows call that
    render_and_grad makes with an L2 loss against a moved scene: config 4 at
    1024×1024 and config 5 at 1080×1920 (one depth: vertex and material
    tables, config 5's texels), config 3 through clusters at 1080×1920 (three
    depths: vertex, material and sphere tables)."""
    import dataclasses

    import tpurt_torch
    from tpurt_torch.scene import configs
    from tpurt_torch.shading import deferred as TD

    dev = _need_card()
    out = {}
    original = TD.segsum_rows
    for name, (scene, cfg), accel, field, shift in (
            ("config 4", configs.config4_bunny(1024, 1024), None, "vertices", (0.04, 0.02, -0.03)),
            ("config 5", configs.config5_multimesh(1080, 1920), None, "vertices",
             (0.02, 0.01, -0.015)),
            ("config 3 through clusters", configs.config3_spheres(1080, 1920), "bvh",
             "sph_center", (0.05, 0.0, -0.03))):
        plan = tpurt_torch.prepare(scene, cfg, accel=accel)
        moved = dataclasses.replace(
            scene, **{field: getattr(scene, field) + torch.tensor(shift, device=dev)})
        target = tpurt_torch.render(moved, cfg, plan=plan).detach()
        calls = []

        def recorder(idx, upd, n_rows, calls=calls):
            calls.append((idx.clone(), upd.clone(), n_rows))
            return original(idx, upd, n_rows)

        TD.segsum_rows = recorder
        try:
            tpurt_torch.render_and_grad(scene, lambda im: ((im - target) ** 2).sum(), cfg,
                                        plan=plan)
        finally:
            TD.segsum_rows = original
        seen = {}
        for idx, upd, n_rows in calls:
            width = upd.shape[-1]
            table = ("materials" if width == 11 else "spheres" if width == 4
                     else "vertices" if n_rows == scene.vertices.shape[0] else "texels")
            seen[table] = seen.get(table, 0) + 1
            depth = f", depth {seen[table] - 1}" if cfg.max_depth > 0 else ""
            out[f"{name}, {table}{depth}"] = (idx.reshape(-1).to(torch.int32).contiguous(),
                                               upd.reshape(-1, width).contiguous(), n_rows)
    return out


def _pass_ms(fn, iters=20):
    """(first pass, later passes) device ms of the segment-sum kernel's
    launches in one fn(), medians over `iters` calls (torch.profiler: every
    launch of a kernel whose name holds "segsum", in order)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then loses a launch's record: try again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = sorted((e.time_range.start, e.time_range.elapsed_us()) for e in prof.events()
                         if "CUDA" in str(getattr(e, "device_type", "")) and "segsum" in e.name)
        per = len(kernels) // iters
        if per >= 1 and per * iters == len(kernels):
            break
    else:
        raise RuntimeError(f"{len(kernels)} segment-sum launches in {iters} calls")
    first = [kernels[i * per][1] / 1e3 for i in range(iters)]
    later = [sum(k[1] for k in kernels[i * per + 1:(i + 1) * per]) / 1e3 for i in range(iters)]
    return statistics.median(first), statistics.median(later), per


def stream_times(streams):
    """{key: numbers} of K8 on each stream, printed a line each."""
    from tpurt_torch.kernels import segsum as SS

    out = {}
    for key, (idx, upd, n_rows) in streams.items():
        n, width = upd.shape
        idx_s, order = torch.sort(idx, stable=True)
        upd_s = upd.index_select(0, order)
        ok = (idx_s >= 0) & (idx_s < n_rows)
        live = int(ok.sum())
        runs = torch.unique_consecutive(idx_s[ok], return_counts=True)[1]
        acc = torch.zeros((n_rows, width), device=upd.device)
        ok_u = (idx >= 0) & (idx < n_rows)
        idx_u, upd_u = idx[ok_u], upd[ok_u]
        ms = {"kernel": device_ms(lambda: SS.sorted_segsum_cuda(idx_s, upd, n_rows, order)),
              "kernel on a sorted copy": device_ms(
                  lambda: SS.sorted_segsum_cuda(idx_s, upd_s, n_rows)),
              "stable sort": device_ms(lambda: torch.sort(idx, stable=True)),
              "segsum_rows": device_ms(lambda: SS.segsum_rows(idx, upd, n_rows)),
              "index_add_": device_ms(lambda: acc.zero_().index_add_(0, idx_u, upd_u))}
        first, later, passes = _pass_ms(lambda: SS.sorted_segsum_cuda(idx_s, upd, n_rows, order))
        nbytes, flops = SS.segsum_counts(idx_s, n_rows, width)
        bound = roofline.bound_ms(nbytes, flops)[0]
        r = {"n": n, "width": width, "rows": n_rows, "live": live, "runs": runs.numel(),
             "longest": int(runs.max()) if runs.numel() else 0, "bytes": nbytes,
             "bound_ms": bound, "passes": passes, "first_pass_ms": first,
             "later_passes_ms": later, **{f"{k} ms": v for k, v in ms.items()}}
        out[key] = r
        print(f"streams: {key}: {n} updates of width {width} into {n_rows} rows, {live} in "
              f"range in {r['runs']} runs, longest {r['longest']}; kernel {ms['kernel']:.4f} ms "
              f"in {passes} launches (first pass {first:.4f}, later passes {later:.4f}; "
              f"torch.profiler), on a sorted copy {ms['kernel on a sorted copy']:.4f} ms; "
              f"stable sort {ms['stable sort']:.4f} ms; segsum_rows {ms['segsum_rows']:.4f} ms; "
              f"index_add_ {ms['index_add_']:.4f} ms; bound {bound:.4f} ms "
              f"({nbytes / 1e6:.1f} MB)", flush=True)
    return out


def main(argv=()):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", action="store_true",
                    help="time the segment sum on the main paths' streams instead")
    ap.add_argument("--save", help="with --streams: keep the captured streams in this file")
    ap.add_argument("--load", help="with --streams: time the streams kept in this file")
    args = ap.parse_args(list(argv))
    dev = _need_card()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    if not args.streams:
        report()
        return
    import tpurt_torch

    print(f"package: {tpurt_torch.__file__}", flush=True)
    if args.load:
        streams = {k: (i.to(dev), u.to(dev), r) for k, (i, u, r) in torch.load(args.load).items()}
    else:
        streams = main_path_streams()
    if args.save:
        torch.save({k: (i.cpu(), u.cpu(), r) for k, (i, u, r) in streams.items()}, args.save)
    print(json.dumps({"card": card, "package": tpurt_torch.__file__,
                      "streams": stream_times(streams)}))


if __name__ == "__main__":
    main(sys.argv[1:])
