"""Readings for the limits of a cell's correctness numbers (``check.py``),
taken on the card at the cell's own size, in one process:

    python3 benchmark/calibrate.py --workload c5_step --seeds 1 2 3 ... \
        [--control-seeds 3] [--fault-seeds 3]

It prints one JSON line a reading: ``program`` (the lower readings: the
program against the reference, one a seed), ``control`` (the reference
computed in bfloat16, the precision below the configurations' float32, in
the program's place, against the reference) and one line a planted fault, each against the reference:

- frames: ``stale`` (the frame of the previous pose returned), ``block``
  (a 64 × 64 block of pixels at the centre set to black);
- steps: ``half`` (the loss taken over the first half of the rows alone,
  planted in the reference), ``unchanged`` (a step that returns its state:
  the change reads 1), and on a mesh ``no_exchange`` (the ranks' gradient
  sum left out, planted in the program: ``faults.no_exchange``).

The benchmark's own runs never run this.  Steps need no window: the
first three steps of a start are what a run compares.  Frames are read at
poses of the orbit drawn from the seed among the first 1,000 frames.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import check, harness
    from benchmark import program as P
    from benchmark.reference import tracer
    from benchmark.traffic import generate

    bench = harness.Bench(ROOT)
    cell = bench.cell(args.workload)
    cfg = bench.json("configs", f"{cell['config']}.json")
    traffic = bench.json("traffic", f"{cell['traffic']}.json")
    dev = torch.device(args.device)
    arrays = bench.scene_arrays(cfg)
    rcfg = P.render_config(cfg)
    h, w = rcfg.height, rcfg.width
    rc = {"h": h, "w": w, "max_depth": rcfg.max_depth, "shadows": rcfg.shadows}
    scene = P.scene_from_arrays(arrays, dev)
    plan = P.prepare(scene, rcfg)

    def emit(kind, seed, numbers, **extra):
        print(json.dumps({"kind": kind, "seed": seed, **numbers, **extra}), flush=True)

    def ref_scene(dtype=tracer.DTYPE, **kw):
        return harness.ref_scene(arrays, dev, dtype, **kw)

    if traffic["kind"] == "orbit":
        for i, seed in enumerate(args.seeds):
            eyes = generate.orbit_eyes(traffic, seed, arrays["camera"], 1000)
            picks = random.Random(seed).sample(range(1, 1000), 3)
            worst, ctl, stale, block = {}, {}, {}, {}
            for k in picks:
                img = P.render(P.with_eye(scene, torch.as_tensor(eyes[k], device=dev)),
                               rcfg, plan=plan)
                with torch.no_grad():
                    ref = tracer.render(ref_scene(eye=eyes[k]), h, w, rcfg.max_depth, rcfg.shadows)
                worst = _worse(worst, check.frame_numbers(img, ref))
                if i < args.control_seeds:
                    with torch.no_grad():
                        low = tracer.render(ref_scene(torch.bfloat16, eye=eyes[k]), h, w,
                                            rcfg.max_depth, rcfg.shadows)
                    ctl = _worse(ctl, check.frame_numbers(low, ref))
                if i < args.fault_seeds:
                    prev = P.render(P.with_eye(scene, torch.as_tensor(eyes[k - 1], device=dev)),
                                    rcfg, plan=plan)
                    stale = _worse(stale, check.frame_numbers(prev, ref))
                    bad = img.clone()
                    bad[h // 2 - 32:h // 2 + 32, w // 2 - 32:w // 2 + 32] = 0.0
                    block = _worse(block, check.frame_numbers(bad, ref))
            emit("program", seed, worst, frames=picks)
            for kind, nums in (("control", ctl), ("stale", stale), ("block", block)):
                if nums:
                    emit(kind, seed, nums)
        return

    lr = traffic["lr"]
    if cell["chips"] == 1:
        prog = _program_readings(P, scene, plan, rcfg, traffic, arrays, args.seeds)
        broken = {}
    else:
        from tpurt_torch.dist.launch import spawn_ranks
        backend = "nccl" if dev.type == "cuda" else "gloo"
        del scene, plan
        prog = spawn_ranks(_mesh_readings, cell["chips"], backend, args.workload, args.seeds,
                           "benchmark.program", device=dev.type)[0]
        broken = spawn_ranks(_mesh_readings, cell["chips"], backend, args.workload,
                             args.seeds[:args.fault_seeds], "benchmark.faults:no_exchange",
                             device=dev.type)[0]
    for i, seed in enumerate(args.seeds):
        start = generate.inverse_starts(traffic, seed, arrays, 1)[0]
        t = time.perf_counter()
        ref = check.reference_steps(ref_scene(), ref_scene(start=start), rc, lr)
        nums, notes = check.step_numbers(prog[seed], ref)
        emit("program", seed, nums, reference_seconds=time.perf_counter() - t,
             losses=prog[seed]["losses"], ref_losses=ref["losses"], **notes,
             grad=prog[seed]["grad"], ref_grad=ref["grad"], change=prog[seed]["change"],
             ref_change=ref["change"])
        if i < args.control_seeds:
            low = check.reference_steps(ref_scene(torch.bfloat16),
                                        ref_scene(torch.bfloat16, start=start), rc, lr)
            emit("control", seed, check.step_numbers(low, ref)[0])
        if i < args.fault_seeds:
            half = check.reference_steps(ref_scene(), ref_scene(start=start), rc, lr, fault="half")
            emit("half", seed, check.step_numbers(half, ref)[0])
            still = dict(prog[seed], change={k: 0.0 for k in prog[seed]["change"]})
            emit("unchanged", seed, check.step_numbers(still, ref)[0])
            if seed in broken:
                emit("no_exchange", seed, check.step_numbers(broken[seed], ref)[0])


def _program_readings(program, scene, plan, rcfg, traffic, arrays, seeds, mesh=None):
    """{seed: the program's readings of the first three steps from the
    seed's start} (``check.program_step_readings``)."""
    from benchmark import check
    from benchmark.traffic import generate

    lr = traffic["lr"]
    step = (program.make_train_step(rcfg, plan=plan) if mesh is None
            else program.make_train_step(rcfg, plan=plan, mesh=mesh))
    target = program.render(scene, rcfg, plan=plan)
    out = {}
    for seed in seeds:
        start = generate.inverse_starts(traffic, seed, arrays, 1)[0]
        s0 = program.with_start(scene, start)
        s1, l1 = step(s0, target, lr)
        s2, l2 = step(s1, target, lr)
        s3, l3 = step(s2, target, lr)
        out[seed] = check.program_step_readings(
            *[program.float_leaves(s) for s in (s0, s1, s3)], (l1, l2, l3), lr)
    return out


def _mesh_readings(mesh, cell_name, seeds, program_spec):
    """One rank of a mesh cell's calibration: the program's readings on
    every seed (every rank holds the same scene after each step)."""
    from benchmark import harness

    program = harness._program(program_spec)
    bench = harness.Bench(ROOT)
    cell = bench.cell(cell_name)
    cfg = bench.json("configs", f"{cell['config']}.json")
    traffic = bench.json("traffic", f"{cell['traffic']}.json")
    arrays = bench.scene_arrays(cfg)
    rcfg = program.render_config(cfg)
    scene = program.scene_from_arrays(arrays, mesh.device)
    plan = program.prepare(scene, rcfg)
    return _program_readings(program, scene, plan, rcfg, traffic, arrays, seeds, mesh)

def _worse(a: dict, b: dict) -> dict:
    return {k: max(a.get(k, 0.0), v) for k, v in b.items()}


if __name__ == "__main__":
    main()
