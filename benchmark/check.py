"""How ``correct`` is decided: the numbers that compare what the timed path
produced with the plain reference (``benchmark/reference``), and the
reference runs behind them.  Each number has its limit in the cell's file
(``benchmark/workloads/<cell>.json``); ``PERF.md`` gives the readings each
limit was set from.

Frames: ``img_p99_gap`` is the 99th percentile of |program - reference|
over every channel of a kept frame, ``pix_off_share`` the share of its
pixels whose largest channel gap passes PIX_TOL (hits or shadows that
differ); the worst kept frame counts.

Steps: ``loss_gap`` is the largest relative gap of the first three steps'
losses; ``grad_gap`` compares the first gradient, as the update applied it
((start - after one step) / lr), and ``change_gap`` the parameters' change
after three steps, each by the worst leaf: |program's norm - reference's
norm| over the larger of the reference's norm of that leaf and its median
leaf's.  ``change_gap`` leaves out the leaves whose first reference
gradient is under CHANGE_MIN of the median leaf's: they move by rounding
alone.
"""
from __future__ import annotations

import math
import statistics

import torch

from benchmark.reference import tracer

#: a pixel is off where a channel differs by more than this (5 of 255 levels)
PIX_TOL = 0.02
#: leaves whose first reference gradient is under this share of the median
#: leaf's are left out of the change
CHANGE_MIN = 1e-3


def _finite(x: float) -> float:
    return x if math.isfinite(x) else float("inf")


def frame_numbers(img, ref) -> dict:
    diff = (img.float() - ref.float()).abs()
    flat = diff.flatten()
    p99 = float(flat.kthvalue(max(1, math.ceil(0.99 * flat.numel()))).values)
    off = float((diff.amax(-1) > PIX_TOL).float().mean())
    return {"img_p99_gap": _finite(p99), "pix_off_share": _finite(off)}


def leaf_norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def _leaf_gap(prog: dict, ref: dict, names) -> tuple:
    med = statistics.median(ref.values()) if ref else 0.0
    worst, at = 0.0, None
    for k in names:
        r = ref.get(k, 0.0)
        p = prog.get(k, 0.0)
        den = max(r, med)
        gap = abs(p - r) / den if den > 0 else (0.0 if p == r else float("inf"))
        gap = _finite(gap)
        if gap >= worst:
            worst, at = gap, k
    return worst, at


def step_numbers(prog: dict, ref: dict) -> tuple:
    """(numbers, notes) from {"losses": [3], "grad": {leaf: norm}, "change":
    {leaf: norm}} of the program and of the reference."""
    loss_gap = max(_finite(abs(p - r) / abs(r)) for p, r in zip(prog["losses"], ref["losses"]))
    names = sorted(set(prog["grad"]) | set(ref["grad"]))
    grad_gap, grad_at = _leaf_gap(prog["grad"], ref["grad"], names)
    med = statistics.median(ref["grad"].values())
    moved = [k for k in names if ref["grad"].get(k, 0.0) >= CHANGE_MIN * med]
    change_gap, change_at = _leaf_gap(prog["change"], ref["change"], moved)
    return ({"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap},
            {"grad_gap_leaf": grad_at, "change_gap_leaf": change_at, "change_leaves": moved})


def program_step_readings(leaves0: dict, leaves1: dict, leaves3: dict, losses, lr) -> dict:
    """The program's side of ``step_numbers`` from its scenes at the start,
    after one step and after three."""
    return {"losses": [float(x) for x in losses],
            "grad": leaf_norms({k: (leaves0[k] - leaves1[k]) / lr for k in leaves0}),
            "change": leaf_norms({k: leaves3[k] - leaves0[k] for k in leaves0})}


def reference_steps(scene0, start_scene, rcfg: dict, lr: float, fault: str | None = None) -> dict:
    """The reference's side of ``step_numbers``: its own target from the
    unperturbed scene, then three SGD steps from the start.  `fault`
    ("half": the loss over the first half of the rows alone) plants a fault
    for calibration."""
    h, w, depth, shadows = rcfg["h"], rcfg["w"], rcfg["max_depth"], rcfg["shadows"]
    with torch.no_grad():
        target = tracer.render(scene0, h, w, depth, shadows)
    rows = h // 2 if fault == "half" else h
    s, losses, grads, counts = start_scene, [], None, None
    for k in range(3):
        if rows == h:
            loss, g, c = tracer.loss_and_grads(s, target, h, w, depth, shadows)
        else:
            loss, g, c = _loss_and_grads_rows(s, target, rcfg, rows)
        losses.append(float(loss))
        if k == 0:
            grads, counts = g, c
        s = tracer.sgd(s, g, lr)
    return {"losses": losses, "grad": leaf_norms(grads),
            "change": leaf_norms({k: s.leaves[k] - start_scene.leaves[k] for k in s.leaves}),
            "counts": counts}


def _loss_and_grads_rows(scene, target, rcfg, rows):
    names = list(scene.leaves)
    live = {k: v.detach().requires_grad_(True) for k, v in scene.leaves.items()}
    with torch.enable_grad():
        img, counts = tracer.render(scene.with_leaves(live), rcfg["h"], rcfg["w"],
                                    rcfg["max_depth"], rcfg["shadows"], with_counts=True)
        loss = torch.mean((img[:rows] - target[:rows].to(img.dtype)) ** 2)
        grads = torch.autograd.grad(loss, [live[k] for k in names], allow_unused=True)
    return (loss.detach(),
            {k: torch.zeros_like(live[k]) if g is None else g for k, g in zip(names, grads)},
            counts)
