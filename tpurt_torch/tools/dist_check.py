"""Tile-parallel rows (``tpurt_torch.dist``) on one card: the image, the
records, the gradients and the train step of a mesh of ranks held to the
single device, resumable chunks, ``multihost-render``, and the cost of the
layer.

    python3 -m tpurt_torch.tools.dist_check --backend gloo

World 1 runs in this process over NCCL; world 2 runs two spawned ranks over
``--backend`` (the card holds both: NCCL refuses two ranks of one
communicator on one device, which the probe shows).
Config 3 at 1080×1920 (phase-1: K1 forward, K2 backward) and config 4 at
1024×1024 (clusters: K5, deferred shading, K8); config 5 is left out for the
run's time.  At each world size:
  - ``render_sharded`` of both equals ``render()`` bit for bit; on config 4 the
    records of each rank's window equal the whole frame's;
  - ``render_and_grad_sharded`` with an L2 loss on config 3 against the
    single-device ``render_and_grad`` (the same K2 route), within GRAD_RTOL of
    each leaf's max|g|; two runs bit-equal;
  - 5 mesh steps of config 3 and 3 of config 4's clusters plan lower the loss;
  - ``render_resumable`` of config 3 in 128-row chunks crashes after 2 chunks,
    resumes, and equals ``render()`` bit for bit;
  - ms/frame and ms/step, the image gather and the gradient sum (host clock to
    ``torch.cuda.synchronize()``).
Then ``multihost-render`` as two processes on 127.0.0.1 over ``--backend``,
whose PNG equals the single-device render's.  ``main`` (this command) also
probes which collectives each backend runs on two ranks' CUDA tensors on the
one card; ``run``, which ``chip_smoke.py`` calls, tries NCCL's
``all_reduce`` on them once and prints what NCCL says.

Launch counts are those of the main path alone (the renders and the steps),
summed over the ranks and the world sizes.  Any failure raises.  The last
line of ``main`` is one JSON object of the numbers printed.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import tpurt_torch
from tpurt_torch.accel import native
from tpurt_torch.dist import failsafe
from tpurt_torch.dist import shard
from tpurt_torch.dist.launch import init_ranks, spawn_ranks
from tpurt_torch.dist.train import make_train_step, render_and_grad_sharded
from tpurt_torch.kernels import build
from tpurt_torch.kernels import megakernel as MK
from tpurt_torch.kernels import segsum as SS
from tpurt_torch.kernels import traversal as TV
from tpurt_torch.kernels.packc import pack_clusters
from tpurt_torch.render import cap_depth
from tpurt_torch.scene import configs
from tpurt_torch.utils import load_png, save_png

REPO = Path(__file__).resolve().parents[2]
SIZE3, SIZE4, SUBDIV4 = (1080, 1920), (1024, 1024), None
STEPS3, LR3 = 5, 0.1          # chip_smoke.py's TRAIN_STEPS, TRAIN_LR
STEPS4, LR4 = 3, 1.0          # chip_smoke.py's CLUSTERED_TRAIN_LR
CHUNK_ROWS, FAIL_AFTER = 128, 2
GRAD_RTOL = 2e-3              # of each leaf's max|g|
TIMED = 10                    # timed calls of each measurement
PROBE_TIMEOUT_S = 90.0


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def host_ms(fn, dev, iters=TIMED, warm=2):
    """Median host-clock ms of fn() up to a synchronize, after `warm` calls."""
    for _ in range(warm):
        fn()
    _sync(dev)
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def reset_launches():
    for mod in (MK, TV, SS):
        mod.reset_launches()


def launches():
    return {k: n for mod in (MK, TV, SS) for k, n in mod.launches.items() if n}


def scenes(dev, size3=SIZE3, size4=SIZE4, subdiv4=SUBDIV4):
    """Config 3 (phase-1) and config 4 (its clusters plan) on `dev`, each with
    the target of an L2 loss: the image of the scene moved a little."""
    s3, c3 = configs.config3_spheres(*size3, device=dev)
    moved3 = dataclasses.replace(
        s3, sph_center=s3.sph_center + torch.tensor([0.1, 0.0, -0.06], device=dev))
    kw = {} if subdiv4 is None else {"subdiv": subdiv4}
    s4, c4 = configs.config4_bunny(*size4, device=dev, **kw)
    plan4 = tpurt_torch.prepare(s4, c4, accel="bvh")
    if plan4.kind != "clusters":
        raise RuntimeError(f"config 4 planned as {plan4.kind}")
    blob = torch.ones((s4.vertices.shape[0], 1), device=dev)
    blob[-4:] = 0.0     # the floor's corners stay
    moved4 = dataclasses.replace(
        s4, vertices=s4.vertices + blob * torch.tensor([0.04, 0.02, -0.03], device=dev))
    return {"c3": (s3, c3, tpurt_torch.prepare(s3, c3), tpurt_torch.render(moved3, c3)),
            "c4": (s4, c4, plan4, tpurt_torch.render(moved4, c4, plan=plan4))}


def l2(target):
    return lambda img: torch.mean((img - target) ** 2)


def digest(t):
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def grads_of(g):
    return {".".join(p): t.detach().cpu() for p, t in MK.scene_float_leaves(g)}


def rank_body(mesh, out_dir, sizes, chunk_rows):
    """Everything one rank does at one world size; returns plain CPU values
    (rank 0 also the images)."""
    dev = mesh.device
    sc = scenes(dev, *sizes)
    s3, c3, p3, t3 = sc["c3"]
    s4, c4, p4, t4 = sc["c4"]
    steps = {"c3": make_train_step(c3, mesh=mesh, plan=p3),
             "c4": make_train_step(c4, mesh=mesh, plan=p4)}

    # the main path, alone between the counters' reset and their reading
    reset_launches()
    img3 = shard.render_sharded(s3, c3, mesh, plan=p3)
    img4 = shard.render_sharded(s4, c4, mesh, plan=p4)
    losses = {"c3": [], "c4": []}
    for name, (s, _, _, target), n, lr in (("c3", sc["c3"], STEPS3, LR3),
                                           ("c4", sc["c4"], STEPS4, LR4)):
        for _ in range(n):
            s, loss = steps[name](s, target, lr)
            losses[name].append(float(loss))
    _sync(dev)
    counts = launches()

    # config 4's records: this rank's window against the whole frame
    capped = cap_depth(c4, p4)
    packed = pack_clusters(s4, p4.tri_ids, p4.tree)
    lo, hi = shard.rank_rows(c4.height, mesh)
    whole = TV.records_rows(s4, capped, packed, 0, c4.height)
    cols = slice(lo * c4.width, hi * c4.width)
    if hi > lo:
        window = TV.records_rows(s4, capped, packed, lo, hi - lo)
        records = [int((w != f[:, cols]).sum()) for w, f in zip(window, whole)]
    else:
        records = [0, 0]

    (_, _), g = render_and_grad_sharded(s3, l2(t3), c3, mesh, plan=p3)
    (_, _), g2 = render_and_grad_sharded(s3, l2(t3), c3, mesh, plan=p3)
    grads, again = grads_of(g), grads_of(g2)
    varying = [k for k in grads if not torch.equal(grads[k], again[k])]

    chunks = {}
    try:
        failsafe.render_resumable(s3, c3, out_dir, chunk_rows=chunk_rows, plan=p3, mesh=mesh,
                                  _fail_after=FAIL_AFTER)
    except RuntimeError as e:
        chunks["crashed"] = str(e)
    if mesh.rank == 0:
        with open(os.path.join(out_dir, "manifest.json")) as f:
            chunks["after_crash"] = len(json.load(f)["chunks"])
    resumed = failsafe.render_resumable(s3, c3, out_dir, chunk_rows=chunk_rows, plan=p3,
                                        mesh=mesh)

    # the layer's cost: a frame, a step, the gather of a frame's rows and the
    # sum of a step's gradients
    per = shard.rows_per_device(c3.height, mesh.size)
    rows = torch.zeros((per, c3.width, 3), device=dev)
    leaves = [t for _, t in MK.scene_float_leaves(g)]
    times = {"frame_ms": host_ms(lambda: shard.render_sharded(s3, c3, mesh, plan=p3), dev),
             "step_ms": host_ms(lambda: steps["c3"](s3, t3, LR3), dev),
             "frame4_ms": host_ms(lambda: shard.render_sharded(s4, c4, mesh, plan=p4), dev),
             "step4_ms": host_ms(lambda: steps["c4"](s4, t4, LR4), dev),
             "gather_ms": host_ms(lambda: shard._all_gather(rows, mesh), dev),
             "sum_ms": host_ms(lambda: shard.sum_in_rank_order(leaves, mesh), dev)}
    times["heartbeat_ms"] = failsafe.heartbeat(mesh, timeout_s=60.0) * 1e3
    times["gather_bytes"] = rows.numel() * 4 * mesh.size
    times["sum_bytes"] = sum(t.numel() for t in leaves) * 4 * mesh.size

    out = {"rank": mesh.rank, "chunk_rows": chunk_rows, "launches": counts, "losses": losses,
           "records_off": records, "varying": varying, "chunks": chunks, "times": times,
           "digests": {"c3": digest(img3), "c4": digest(img4)}}
    if mesh.rank == 0:
        out.update(img3=img3.cpu(), img4=img4.cpu(), grads=grads, resumed=resumed)
    return out


def _all_gather(x, mesh):
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def _all_gather_into_tensor(x, mesh):
    y = torch.empty(x.numel() * mesh.size, device=x.device)
    dist.all_gather_into_tensor(y, x)
    return y


def _all_reduce(x, mesh):
    y = x.clone()
    dist.all_reduce(y)
    return y


def _broadcast(x, mesh):
    y = x.clone()
    dist.broadcast(y, src=0)
    return y


def _reduce_scatter(x, mesh):
    y = torch.empty(x.numel() // mesh.size, device=x.device)
    dist.reduce_scatter_tensor(y, x.clone())
    return y


def _all_to_all(x, mesh):
    y = torch.empty_like(x)
    dist.all_to_all_single(y, x)
    return y


def _ring_step(x, mesh):
    """Each rank sends to the next and receives from the one before: a step
    of the ring that the sharded scene needs."""
    y = torch.empty_like(x)
    reqs = [dist.isend(x, (mesh.rank + 1) % mesh.size),
            dist.irecv(y, (mesh.rank - 1) % mesh.size)]
    for r in reqs:
        r.wait()
    return y


def _ring_step_via_host(x, mesh):
    return _ring_step(x.cpu(), mesh).to(x.device)


#: op: (function, the sum rank 0 must see with rank r holding four (r + 1)s
#: on 2 ranks); the ops that may take the process down last
PROBE_OPS = {"all_reduce": (_all_reduce, 12.0), "broadcast": (_broadcast, 4.0),
             "all_gather_into_tensor": (_all_gather_into_tensor, 12.0),
             "reduce_scatter_tensor": (_reduce_scatter, 6.0),
             "all_gather": (_all_gather, 12.0), "all_to_all_single": (_all_to_all, 6.0),
             "isend/irecv via the host": (_ring_step_via_host, 8.0),
             "isend/irecv": (_ring_step, 8.0)}


def _first_line(e):
    return (str(e).strip().splitlines() or [type(e).__name__])[0][:300]


def _probe_rank(mesh, ops, log):
    """Run each of `ops` on this rank's CUDA tensors, appending each op's
    name to `log` before it runs and its outcome after: an op that takes the
    process down (gloo aborts on some) leaves its name last."""
    x = torch.full((4,), float(mesh.rank + 1), device=mesh.device)
    for op in ops:
        fn, want = PROBE_OPS[op]
        with open(f"{log}.{mesh.rank}", "a") as f:
            f.write(f"{op}\n")
        try:
            got = float(fn(x, mesh).sum())
            _sync(mesh.device)
            outcome = "ok" if mesh.rank or got == want else f"wrong sum {got}, want {want}"
        except Exception as e:  # noqa: BLE001 — the probe records what a backend refuses
            outcome = _first_line(e)
        with open(f"{log}.{mesh.rank}", "a") as f:
            f.write(f"{op}\t{outcome}\n")


def probe_backend(backend, ops=tuple(PROBE_OPS), device="cuda"):
    """Which of `ops` `backend` runs for two ranks' tensors on `device` (both
    ranks on the one card): {op: "ok" | what it raised | "the process died:
    ..."}.  Ranks spawn again after an op that took them down, from the next
    op on."""
    t0 = time.perf_counter()
    out, ops = {}, list(ops)
    with tempfile.TemporaryDirectory(prefix="tpurt_probe_") as tmp:
        for attempt in range(len(PROBE_OPS)):
            log = os.path.join(tmp, f"log{attempt}")
            try:
                spawn_ranks(_probe_rank, 2, backend, ops, log, device=device,
                            timeout_s=PROBE_TIMEOUT_S)
                died = None
            except Exception as e:  # noqa: BLE001 — recorded, not hidden
                died = (str(e).strip().splitlines() or [type(e).__name__])[-1][:300]
            lines = open(f"{log}.0").read().splitlines() if os.path.exists(f"{log}.0") else []
            for line in lines:
                op, _, outcome = line.partition("\t")
                out[op] = outcome or f"the process died: {died}"
            if not lines:
                out["spawn"] = f"the process died: {died}"
            if died is None or not lines:
                break
            ops = ops[ops.index(lines[-1].partition("\t")[0]) + 1:]
            if not ops:
                break
    return out, time.perf_counter() - t0


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multihost(backend, dev, size3, ref_png, tmp):
    """multihost-render of config 3 as two processes on 127.0.0.1: its PNG
    equals the single-device render's."""
    out = os.path.join(tmp, "multihost.png")
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpurt_torch.cli", "multihost-render", "--config", "3",
         "--res", f"{size3[0]}x{size3[1]}", "--device", dev, "--backend", backend,
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(i), "--out", out],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    secs = time.perf_counter() - t0
    if any(p.returncode for p in procs):
        raise RuntimeError("multihost-render failed: " + " | ".join(e[-2000:] for _, e in outs))
    line = json.loads(outs[0][0].splitlines()[-1])
    same = bool(np.array_equal(load_png(out), load_png(ref_png)))
    print(f"dist: multihost-render of config 3 at {size3[0]}x{size3[1]} as 2 processes over "
          f"{backend} on 127.0.0.1: {line}, {secs:.1f} s with start-up; its PNG equals the "
          f"single-device render's: {same}", flush=True)
    if line != {"out": out, "devices": 2} or not same:
        raise RuntimeError("multihost-render's PNG differs from the single-device render's")
    return secs


def _check_world(n, results, ref):
    """Hold one world's rank results to the single-device references."""
    r0 = results[0]
    digests = {k: digest(ref[k]) for k in ("c3", "c4")}
    for r in results:
        if r["digests"] != digests:
            raise RuntimeError(f"world {n}: rank {r['rank']}'s images differ from render()")
        if r["records_off"] != [0, 0]:
            raise RuntimeError(f"world {n}: rank {r['rank']}'s window records differ from the "
                               f"whole frame's: ids, occ off {r['records_off']}")
        if r["losses"] != r0["losses"]:
            raise RuntimeError(f"world {n}: the ranks' losses differ")
        for name, ls in r["losses"].items():
            if not all(np.isfinite(ls)) or not ls[-1] < ls[0]:
                raise RuntimeError(f"world {n}: {name}'s loss did not go down: {ls}")
        if r["varying"]:
            raise RuntimeError(f"world {n}: rank {r['rank']}'s gradients differ between two "
                               f"runs: {r['varying']}")
        if r["chunks"].get("crashed") != f"injected failure after {FAIL_AFTER} chunks":
            raise RuntimeError(f"world {n}: the resumable render did not crash as asked: "
                               f"{r['chunks']}")
    if not torch.equal(r0["img3"], ref["c3"].cpu()) or not torch.equal(r0["img4"],
                                                                        ref["c4"].cpu()):
        raise RuntimeError(f"world {n}: the gathered images differ from render()")
    if r0["chunks"]["after_crash"] != FAIL_AFTER or not np.array_equal(
            r0["resumed"], ref["c3"].cpu().numpy()):
        raise RuntimeError(f"world {n}: the resumed frame differs from render()")
    gaps = {}
    for k, want in ref["grads"].items():
        top = float(want.abs().max())
        got = r0["grads"][k]
        if not torch.isfinite(got).all():
            raise RuntimeError(f"world {n}: gradient of {k} is not finite")
        gaps[k] = float((got - want).abs().max()) / top if top > 0.0 else float(
            got.abs().max())
    worst = max(gaps, key=gaps.get)
    bit_equal = all(torch.equal(r0["grads"][k], ref["grads"][k]) for k in ref["grads"])
    t = r0["times"]
    print(f"dist: world {n}: images of config 3 and config 4 bit-equal to render() on every "
          f"rank, window records equal the whole frame's; launches a rank "
          f"{[r['launches'] for r in results]}; losses config 3 "
          + " -> ".join(f"{x:.6g}" for x in r0["losses"]["c3"]) + ", config 4 "
          + " -> ".join(f"{x:.6g}" for x in r0["losses"]["c4"])
          + f"; gradients against single-device render_and_grad (share of max|g|, allowed "
          f"{GRAD_RTOL:g}): largest {worst} {gaps[worst]:.3g}; bit-equal to single-device: "
          f"{bit_equal}; two runs bit-equal: yes; resumed frame ({r0['chunk_rows']}-row chunks, crash after "
          f"{FAIL_AFTER}) bit-equal to render()", flush=True)
    print(f"dist: world {n} times (host clock to synchronize, median of {TIMED}): config 3 "
          f"render_sharded {t['frame_ms']:.4f} ms/frame, mesh step {t['step_ms']:.4f} ms/step; "
          f"config 4 {t['frame4_ms']:.4f} ms/frame, {t['step4_ms']:.4f} ms/step; image gather "
          f"({t['gather_bytes'] / 1e6:.2f} MB) {t['gather_ms']:.4f} ms; gradient sum "
          f"({t['sum_bytes'] / 1e3:.2f} kB) {t['sum_ms']:.4f} ms; heartbeat "
          f"{t['heartbeat_ms']:.4f} ms", flush=True)
    if gaps[worst] > GRAD_RTOL:
        raise RuntimeError(f"world {n}: the mesh's gradients disagree with a single device's")
    return {"gaps": gaps, **t}


def run(device, world1_backend, backend, sizes=(SIZE3, SIZE4, SUBDIV4),
        chunk_rows=CHUNK_ROWS):
    """Everything above but the probe on `device` ("cuda", or "cpu" at small
    `sizes` to rehearse: there the plain versions run);
    returns (launches of the main path summed over the ranks and world
    sizes, a record of the numbers)."""
    t_start = time.perf_counter()
    # build the kernels and the C++ builders here, not once a rank
    if device == "cuda":
        build.load()
    native.load()
    dev = "cuda:0" if device == "cuda" else "cpu"
    size3 = sizes[0]
    sc = scenes(dev, *sizes)
    s3, c3, p3, t3 = sc["c3"]
    s4, c4, p4, _ = sc["c4"]
    (_, _), g = tpurt_torch.render_and_grad(s3, l2(t3), c3, plan=p3)
    ref = {"c3": tpurt_torch.render(s3, c3, plan=p3), "c4": tpurt_torch.render(s4, c4, plan=p4),
           "grads": grads_of(g)}
    record = {"render_ms": host_ms(lambda: tpurt_torch.render(s3, c3, plan=p3), dev)}
    del sc, s3, s4, g
    total = {}

    with tempfile.TemporaryDirectory(prefix="tpurt_dist_") as tmp:
        ref_png = os.path.join(tmp, "single.png")
        save_png(ref_png, ref["c3"])
        # world 1 in this process
        init_ranks(world1_backend, 0, 1, dist.FileStore(os.path.join(tmp, "store"), 1))
        try:
            w1 = [rank_body(shard.make_mesh(device), os.path.join(tmp, "w1"), sizes, chunk_rows)]
        finally:
            dist.destroy_process_group()
        record["world1"] = _check_world(1, w1, ref)
        # world 2: two spawned ranks
        t0 = time.perf_counter()
        w2 = spawn_ranks(rank_body, 2, backend, os.path.join(tmp, "w2"), sizes, chunk_rows,
                         device=device,
                         timeout_s=600)
        record["world2_spawn_s"] = time.perf_counter() - t0
        record["world2"] = _check_world(2, w2, ref)
        for r in w1 + w2:
            for k, v in r["launches"].items():
                total[k] = total.get(k, 0) + v
        record["multihost_s"] = multihost(backend, device, size3, ref_png, tmp)

    if device == "cuda":
        _print_probe("nccl", ("all_reduce",))
    record["seconds"] = time.perf_counter() - t_start
    record["card"] = card() if device == "cuda" else "no card: the CPU"
    print(f"dist: on {record['card']}: render() single device {record['render_ms']:.4f} "
          f"ms/frame; world 2 spawn {record['world2_spawn_s']:.1f} s with start-up; phase "
          f"{record['seconds']:.1f} s; main-path launches over both worlds {total}", flush=True)
    return total, record


def _print_probe(backend, ops=tuple(PROBE_OPS)):
    res, secs = probe_backend(backend, ops)
    print(f"dist: collectives of {backend} on two ranks' CUDA tensors on one card "
          f"({secs:.1f} s): " + "; ".join(f"{op}: {v}" for op, v in res.items()), flush=True)
    return res


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", required=True, choices=["nccl", "gloo"],
                    help="the backend of the two-rank world and of multihost-render")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this tool checks a card")
    total, record = run("cuda", "nccl", args.backend)
    for b in ("gloo", "nccl"):
        record[f"probe_{b}"] = _print_probe(b)
    print(json.dumps({"launches": total, **record}, default=str))


if __name__ == "__main__":
    main()
