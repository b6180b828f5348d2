"""One run of one cell: load its files, make its inputs from the seed, set
the program up and warm it, measure for the window, check what the window
produced against the plain reference, and report.  ``run.py`` is the
command; tests call ``run`` with a CPU device and a throwaway benchmark
root.

Everything particular to a cell sits in files the harness finds by name:
the cell's entry in ``BENCHMARK.json``, ``configs/<config>.json`` and the
scene builder it names (``scenes/<scene>.py``), ``traffic/<traffic>.json``,
``workloads/<cell>.json`` (the limits of its correctness numbers) and one
reader a metric, ``metrics/<metric>.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import random
import sys
import time
from pathlib import Path

import torch

from benchmark import check
from benchmark.reference import tracer
from benchmark.trace import WINDOW_SPAN, Trace
from benchmark.traffic import generate

#: seconds at the start of the window that a traced run traces
TRACE_SECONDS = 1.0
#: top-level module names that may not be loaded in the process that reports
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tpurt")


@dataclasses.dataclass
class Context:
    """What a metric's reader may read."""

    cell: str
    mode: str
    config: dict
    nominal_rays: int
    setup_s: float
    window_s: float
    call_s: list
    trace: Trace | None = None
    traced_calls: int = 0
    ref_counts: dict | None = None
    n_pix: int = 0


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """The benchmark's files under `root` (the folder holding
    ``BENCHMARK.json``)."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "benchmark"

    def cell(self, name):
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")

    def json(self, *parts):
        return json.loads(self.dir.joinpath(*parts).read_text())

    def metrics(self, cell, trace: bool) -> list:
        """The cell's metrics: its end-to-end ones, or with `trace` its
        per-layer ones."""
        e2e = [m for m in self.spec["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if ((cell in m["workloads"]) if "workloads" in m else (m["moves"] in moved))]

    def reader(self, metric):
        return load_module(self.dir / "metrics" / f"{metric}.py",
                           f"benchmark_metric_{metric.replace('.', '_')}")

    def scene_arrays(self, config: dict) -> dict:
        return load_module(self.dir / "scenes" / f"{config['scene']}.py",
                           f"benchmark_scene_{config['scene']}").build(config)


def nominal_rays(h, w, max_depth, shadows, n_lights) -> int:
    """Pixels × depths × (1 + shadow rays a hit), the project's fixed
    count (``bench.py:count_rays``): rates stay in proportion to time."""
    return h * w * (max_depth + 1) * (1 + (n_lights if shadows else 0))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def _spans(readers):
    """Wrap the calls that the readers name (their ``SPANS``: module, name,
    span) in ``record_function`` spans, where the caller looks them up."""
    saved = []
    for r in readers:
        for mod_name, attr, span in getattr(r, "SPANS", ()):
            mod = sys.modules.get(mod_name) or importlib.import_module(mod_name)
            fn = getattr(mod, attr)

            def wrapped(*a, _fn=fn, _span=span, **kw):
                with torch.profiler.record_function(_span):
                    return _fn(*a, **kw)

            saved.append((mod, attr, fn))
            setattr(mod, attr, wrapped)
    try:
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


@dataclasses.dataclass
class Job:
    """One run's cell, files and options, as every rank sees them."""

    root: str
    cell: str
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float
    program: str = "benchmark.program"

    def load(self):
        bench = Bench(self.root)
        cell = bench.cell(self.cell)
        cfg = bench.json("configs", f"{cell['config']}.json")
        traffic = bench.json("traffic", f"{cell['traffic']}.json")
        return bench, cell, cfg, traffic


def _program(spec):
    """The system under test: a module, or ``module:function`` returning one
    (tests plant faults this way, also in the ranks of a mesh)."""
    if not isinstance(spec, str):
        return spec
    mod, _, fn = spec.partition(":")
    m = importlib.import_module(mod)
    return getattr(m, fn)() if fn else m


def drive(job: Job, program, mesh=None) -> dict:
    """Set the program up and run the window in this process (one rank of
    `mesh` where given).  Returns what the check and the readers need."""
    bench, cell, cfg, traffic = job.load()
    metrics = bench.metrics(job.cell, job.trace)
    readers = {m["name"]: bench.reader(m["name"]) for m in metrics}
    dev = torch.device(job.device) if mesh is None else mesh.device
    seconds = job.seconds
    arrays = bench.scene_arrays(cfg)
    rcfg = program.render_config(cfg)
    mode = "frame" if traffic["kind"] == "orbit" else "step"
    scene = program.scene_from_arrays(arrays, dev)
    plan = program.prepare(scene, rcfg)
    if plan.kind != cfg["plan"]:
        raise SystemExit(f"{job.cell}: the program planned {plan.kind!r}, "
                         f"the configuration states {cfg['plan']!r}")
    out = {"mode": mode}
    if mode == "frame":
        if mesh is not None:
            raise SystemExit(f"{job.cell}: frames over a mesh are not supported")
        # no pose repeats within a run; the bound on the count is a frame
        # every half millisecond
        n_cap = int(seconds * 2000) + 8
        eyes_np = generate.orbit_eyes(traffic, job.seed, arrays["camera"], n_cap + 2)
        eyes = torch.as_tensor(eyes_np, device=dev)
        scenes = [program.with_eye(scene, eyes[k]) for k in range(n_cap + 2)]
        for k in (n_cap, n_cap + 1):  # warm-up on poses the window never reaches
            program.render(scenes[k], rcfg, plan=plan)
        _sync(dev)
        kept, rng = [], random.Random(job.seed)
        n_keep = traffic["frames_kept"]

        def call(k):
            img = program.render(scenes[k], rcfg, plan=plan)
            _sync(dev)
            # a uniform sample of the window's frames, drawn from the seed
            if len(kept) < n_keep:
                kept.append((k, img))
            else:
                j = rng.randrange(k + 1)
                if j < n_keep:
                    kept[j] = (k, img)
    else:
        lr = traffic["lr"]
        per = traffic["steps_per_start"]
        n_starts = int(seconds * 2000) // per + 2
        starts = generate.inverse_starts(traffic, job.seed, arrays, n_starts)
        start_scenes = [program.with_start(scene, s) for s in starts]
        step = (program.make_train_step(rcfg, plan=plan) if mesh is None
                else program.make_train_step(rcfg, plan=plan, mesh=mesh))
        target = program.render(scene, rcfg, plan=plan)
        # the first three steps of the first start: the warm-up, and what
        # the check follows
        s0 = start_scenes[0]
        s1, l1 = step(s0, target, lr)
        s2, l2 = step(s1, target, lr)
        s3, l3 = step(s2, target, lr)
        _sync(dev)
        out["program"] = check.program_step_readings(
            program.float_leaves(s0), program.float_leaves(s1), program.float_leaves(s3),
            (l1, l2, l3), lr)
        del s1, s2
        state = {"scene": s3, "start": 0, "k": 3}
        losses = []

        def call(_):
            if state["k"] == per:
                state["start"] += 1
                state["scene"], state["k"] = start_scenes[state["start"]], 0
            state["scene"], loss = step(state["scene"], target, lr)
            _sync(dev)
            state["k"] += 1
            losses.append(loss)

    go = None if mesh is None else torch.zeros(1, device=dev)

    def more(t_win, limit):
        """Whether to make another call: rank 0's clock decides for every
        rank, since every rank makes the same collectives."""
        if go is None:
            return time.perf_counter() - t_win < limit
        go.fill_(float(time.perf_counter() - t_win < limit) if mesh.rank == 0 else 0.0)
        torch.distributed.broadcast(go, 0)
        return bool(go.item())

    # -- the window ---------------------------------------------------------------
    call_s = []
    prof = None
    traced_calls = 0
    tracing = contextlib.ExitStack()
    if job.trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        tracing.enter_context(_spans(readers.values()))
        prof = tracing.enter_context(profile(activities=acts))
    if mesh is not None:
        torch.distributed.barrier()
    t_win = time.perf_counter()
    setup_s = t_win - job.t0
    k = 0
    if job.trace:
        # the first TRACE_SECONDS of the window are traced
        with torch.profiler.record_function(WINDOW_SPAN):
            while k == 0 or more(t_win, min(TRACE_SECONDS, seconds)):
                a = time.perf_counter()
                call(k)
                call_s.append(time.perf_counter() - a)
                k += 1
        traced_calls = k
        tracing.close()
    while more(t_win, seconds):
        a = time.perf_counter()
        call(k)
        call_s.append(time.perf_counter() - a)
        k += 1
    window_s = time.perf_counter() - t_win
    out.update(call_s=call_s, window_s=window_s, setup_s=setup_s, traced_calls=traced_calls,
               peak=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
               trace=Trace.from_profiler(prof) if job.trace else None, readers=readers,
               metrics=metrics, arrays=arrays, rcfg=rcfg, cfg=cfg)
    if mode == "frame":
        out.update(kept=kept, eyes=eyes_np)
    else:
        finite = torch.isfinite(torch.stack([x.float() for x in losses])) if losses else None
        out.update(nonfinite=0 if finite is None else int((~finite).sum()),
                   start=starts[0], lr=lr)
    return out


def read_metrics(side: dict, ctx: Context) -> dict:
    out = {}
    for m in side["metrics"]:
        value = side["readers"][m["name"]].read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def context(job: Job, side: dict, ref_counts=None) -> Context:
    rcfg = side["rcfg"]
    return Context(cell=job.cell, mode=side["mode"], config=side["cfg"],
                   nominal_rays=nominal_rays(rcfg.height, rcfg.width, rcfg.max_depth,
                                             rcfg.shadows, len(side["arrays"]["lights"])),
                   setup_s=side["setup_s"], window_s=side["window_s"], call_s=side["call_s"],
                   trace=side["trace"], traced_calls=side["traced_calls"],
                   ref_counts=ref_counts, n_pix=rcfg.height * rcfg.width)


def _rank_main(mesh, job: Job):
    """One rank of a mesh cell: drive the window, read this rank's trace,
    and hand plain values back to the parent."""
    side = drive(job, _program(job.program), mesh)
    tr = side.pop("trace")
    got = {k: side[k] for k in ("mode", "call_s", "window_s", "setup_s", "traced_calls",
                                "peak", "program", "nonfinite", "start", "lr")}
    if tr is not None:
        got["busy_window"] = tr.busy_window()
        got["breakdown"] = tr.breakdown()
        side["trace"] = tr
        got["traced"] = read_metrics(side, context(job, side))
    return got


def run(root, cell_name, seed, seconds, trace, device="cuda", program=None,
        t_start=None, log=print) -> dict:
    """One run; returns the result line's object.  `program` replaces the
    system under test: a module or an object with its calls, or for a cell
    on several chips ``"module:function"`` that each rank calls for one."""
    job = Job(root=str(root), cell=cell_name, seed=seed, seconds=seconds, trace=bool(trace),
              device=device, t0=time.perf_counter() if t_start is None else t_start)
    bench, cell, cfg, traffic = job.load()
    limits = bench.json("workloads", f"{cell_name}.json")["limits"]
    chips = cell["chips"]
    dev = torch.device(device)
    if chips == 1:
        side = drive(job, _program(program or job.program))
        ranks = None
    else:
        from tpurt_torch.dist.launch import spawn_ranks
        if isinstance(program, str):
            job.program = program
        ranks = spawn_ranks(_rank_main, chips, "nccl" if dev.type == "cuda" else "gloo",
                            job, device=dev.type)
        metrics = bench.metrics(cell_name, trace)
        side = dict(ranks[0], arrays=bench.scene_arrays(cfg), cfg=cfg,
                    rcfg=_program(job.program).render_config(cfg), trace=None,
                    metrics=metrics, readers={m["name"]: bench.reader(m["name"]) for m in metrics})
        side["peak"] = max(r["peak"] for r in ranks)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))
    if loaded:
        log(f"forbidden modules loaded in the reporting process: {loaded}", file=sys.stderr)
        raise SystemExit(3)

    # -- the check, once the program's state is freed ---------------------------
    attempted, failed = len(side["call_s"]), 0
    rcfg, arrays = side["rcfg"], side["arrays"]
    h, w = rcfg.height, rcfg.width
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if side["mode"] == "frame":
        kept = side.pop("kept")
        eyes_np = side["eyes"]
        numbers = {"img_p99_gap": 0.0, "pix_off_share": 0.0}
        ref_counts = None
        for kk, img in kept:
            with torch.no_grad():
                ref, counts = tracer.render(ref_scene(arrays, dev, eye=eyes_np[kk]), h, w,
                                            rcfg.max_depth, rcfg.shadows, with_counts=True)
            ref_counts = ref_counts or counts
            got = check.frame_numbers(img, ref)
            failed += int(any(got[n] > limits[n] for n in got))
            numbers = {n: max(numbers[n], got[n]) for n in numbers}
        notes = {"frames_checked": [kk for kk, _ in kept]}
        del kept
    else:
        failed += side["nonfinite"]
        ref = check.reference_steps(ref_scene(arrays, dev),
                                    ref_scene(arrays, dev, start=side["start"]),
                                    {"h": h, "w": w, "max_depth": rcfg.max_depth,
                                     "shadows": rcfg.shadows}, side["lr"])
        ref_counts = ref["counts"]
        numbers, notes = check.step_numbers(side["program"], ref)
        failed += int(any(numbers[n] > limits[n] for n in numbers))

    correct = failed == 0 and all(numbers[n] <= limits[n] for n in numbers)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": chips, "memory_peak_bytes": int(side["peak"])}
    out_metrics = (dict(ranks[0]["traced"]) if ranks and trace
                   else read_metrics(side, context(job, side, ref_counts)))
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": out_metrics, "device": device_info}
    if trace and ranks is None:
        busy, win = side["trace"].busy_window()
        device_info["busy_s"], device_info["window_s"] = busy, win
        result["breakdown"] = side["trace"].breakdown()
    elif trace:
        # rank 0's per-layer metrics; the idle share and the busy time are
        # the mean over the cards
        for name in [n for n in out_metrics if n.startswith("idle_pct")]:
            vals = [r["traced"][name]["value"] for r in ranks if name in r["traced"]]
            out_metrics[name]["value"] = sum(vals) / len(vals)
        device_info["busy_s"] = sum(r["busy_window"][0] for r in ranks) / len(ranks)
        device_info["window_s"] = sum(r["busy_window"][1] for r in ranks) / len(ranks)
        result["breakdown"] = ranks[0]["breakdown"]
    call_s = side["call_s"]
    q = len(call_s) // 4
    if q:
        notes["first_quarter_mean_ms"] = sum(call_s[:q]) / q * 1e3
        notes["last_quarter_mean_ms"] = sum(call_s[-q:]) / q * 1e3
    log(json.dumps({"notes": notes}), file=sys.stderr)
    checks = {n: {"value": numbers[n], "limit": limits[n]} for n in numbers}
    for n, c in checks.items():
        log(f"check {n} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    result["checks"] = checks
    return result


def arrays_with(arrays, eye=None, start=None) -> dict:
    """The scene's arrays seen from `eye`, or from a start's lights and
    albedos."""
    a = dict(arrays)
    if eye is not None:
        a["camera"] = dict(arrays["camera"], eye=tuple(float(x) for x in eye))
    if start is not None:
        a["lights"] = [(p, tuple(float(x) for x in c))
                       for (p, _), c in zip(arrays["lights"], start["light_color"])]
        a["materials"] = [dict(m, kd=tuple(float(x) for x in kd))
                          for m, kd in zip(arrays["materials"], start["kd"])]
    return a


def ref_scene(arrays, dev, dtype=tracer.DTYPE, **kw):
    """The reference's scene of the arrays (``arrays_with``'s keywords)."""
    return tracer.from_arrays(arrays_with(arrays, **kw), dev, dtype)
