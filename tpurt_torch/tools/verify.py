"""The port's verification tier on the card, the counterpart of
``bench.py:run_verify``: small frames through every kernel path, images and
gradients held against the port's own brute-force oracle on the CPU, two
record equalities and two finite-difference anchors.  It prints one JSON
line with ``bench.py``'s fields and exits 0 only when every case passes.

    python3 -m tpurt_torch.tools.verify [--device cuda]

Cases (each a function that takes a device and returns its result):
  * seven render-and-grad cases (``RENDER_CASES``, ``bench.py:119-136``):
    ``render_and_grad`` of sum(image²) on the device, against the oracle
    (``accel="none"``, ``backend="oracle"``) on the CPU.  A case passes when
    the mean |Δ| of the image is under 1e-4, at most 0.2% of the pixels
    differ by more than 1e-3 (a silhouette pixel may flip when rounding moves
    an intersection across it), and each named gradient leaf is finite and
    within 1e-2 of the oracle leaf's max|g|;
  * two equalities of integer records, which must be exact: the wavefront
    loop against the one multi-bounce launch, and shadows re-binned over hit
    points against shadows in the kernel (``bench.py:206-244``);
  * two central finite differences of the device's own loss, within 2% of
    its gradient (``bench.py:336-357``).
``bench.py``'s ``shade-compact-vs-plain`` and ``bf16x6-vs-highest`` test TPU
routes that the port leaves out on purpose (ROADMAP.md, Queue 2).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

import torch

from tpurt_torch.core.types import resolve_device
from tpurt_torch.kernels import traversal as TV
from tpurt_torch.kernels.packc import pack_clusters
from tpurt_torch.render import prepare, render, render_and_grad
from tpurt_torch.scene import configs

MEAN_DIFF = 1e-4       # mean |Δ| of the image
PIX_DIFF = 1e-3        # a pixel differs when a channel is off by more than this
BAD_SHARE = 2e-3       # of the pixels that may differ
GRAD_RTOL = 1e-2       # of the oracle leaf's max|g|
FD_RTOL = 2e-2         # finite difference against the gradient
FD_STEP = 2e-3

# name: (scene constructor on a device, accel, gradient leaves)
RENDER_CASES = {
    "c1-phase1": (lambda dev: configs.config1_sphere(64, 64, device=dev), "auto",
                  ("light_color",)),
    "c2-phase1": (lambda dev: configs.config2_cornell(64, 64, device=dev), "auto",
                  ("light_color",)),
    "c3-phase1": (lambda dev: configs.config3_spheres(64, 64, device=dev), "auto",
                  ("light_color", "sph_center", "sph_radius")),
    "c3-clusters-wavefront": (lambda dev: configs.config3_spheres(64, 64, device=dev), "bvh",
                              ("light_color", "sph_center", "sph_radius")),
    "c4-clusters": (lambda dev: configs.config4_bunny(64, 64, subdiv=4, device=dev), "bvh",
                    ("vertices", "light_color")),
    "c5-clusters-tex": (lambda dev: configs.config5_multimesh(48, 64, n_blobs=2, subdiv=4,
                                                              device=dev), "bvh",
                        ("light_color", "textures", "vertices")),
    "c4-grid": (lambda dev: configs.config4_bunny(48, 48, subdiv=4, device=dev), "grid",
                ("light_color", "vertices")),
}


def _loss(img):
    return (img ** 2).sum()


def render_grad_case(name: str, device="cuda") -> dict:
    """Render and differentiate RENDER_CASES[name] on `device` against the
    oracle on the CPU."""
    build, accel, leaves = RENDER_CASES[name]
    t0 = time.perf_counter()
    scene, cfg = build(device)
    plan = prepare(scene, cfg, accel=accel)
    (_, img), grads = render_and_grad(scene, _loss, cfg, plan=plan)
    cpu = scene.to("cpu")
    (_, ref), ref_grads = render_and_grad(cpu, _loss, cfg.replace(backend="oracle"),
                                          plan=prepare(cpu, cfg, accel="none"))
    d = (img.cpu() - ref).abs()
    mean_d = float(d.mean())
    frac_bad = float((d.amax(-1) > PIX_DIFF).float().mean())
    grads_ok = True
    for leaf in leaves:
        g, r = getattr(grads, leaf).cpu(), getattr(ref_grads, leaf)
        if not bool(torch.isfinite(g).all()) or \
                float((g - r).abs().max()) > GRAD_RTOL * (float(r.abs().max()) + 1e-8):
            grads_ok = False
    ok = mean_d < MEAN_DIFF and frac_bad < BAD_SHARE and grads_ok
    return {"case": name, "plan": plan.kind, "mean_diff": round(mean_d, 8),
            "frac_bad_px": round(frac_bad, 6), "grads_ok": grads_ok, "ok": ok,
            "secs": round(time.perf_counter() - t0, 1)}


def _packed(scene, cfg, accel):
    plan = prepare(scene, cfg, accel=accel)
    return pack_clusters(scene, plan.tri_ids, plan.tree)


def wavefront_vs_multibounce(device="cuda") -> int:
    """Records of config 3 at 64x64 through the wavefront loop against the
    one multi-bounce launch: the number of ids and occlusion words that
    differ."""
    scene, cfg = configs.config3_spheres(64, 64, device=device)
    packed = _packed(scene, cfg, "bvh")
    ids_w, occ_w = TV._wavefront_records(scene, cfg, packed, 0, cfg.height)
    ids_m, occ_m, _, _ = TV.trace_records(packed, cfg, 0, cfg.height)
    return int((ids_w != ids_m).sum()) + int((occ_w != occ_m).sum())


def shadow_rebin_on_off(device="cuda") -> int:
    """Occlusion words of the textured config 5 at 48x64 with shadows
    re-binned over hit points against shadows in the kernel, the gate on the
    cluster count dropped so that the small scene takes the re-binned route:
    the number that differ."""
    scene, cfg = configs.config5_multimesh(48, 64, n_blobs=2, subdiv=4, device=device)
    packed = _packed(scene, cfg, "bvh")
    saved = TV.SHADOW_REBIN_MIN_CLUSTERS
    TV.SHADOW_REBIN_MIN_CLUSTERS = 0
    try:
        occ = [TV._wavefront_records(scene, cfg.replace(max_depth=1, shadow_rebin=rebin),
                                     packed, 0, cfg.height)[1] for rebin in (True, False)]
    finally:
        TV.SHADOW_REBIN_MIN_CLUSTERS = saved
    return int((occ[0] != occ[1]).sum())


EQUALITY_CASES = {"wavefront-vs-multibounce": wavefront_vs_multibounce,
                  "shadow-rebin-on-off": shadow_rebin_on_off}


def _set_light(scene, v):
    color = scene.light_color.clone()
    color[0, 0] = v
    return dataclasses.replace(scene, light_color=color)


def _set_albedo(scene, v):
    kd = scene.materials.kd.clone()
    kd[1, 0] = v
    return dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, kd=kd))


# name: (scene constructor on a device, accel, leaf getter, leaf setter).  No
# geometry leaf: a true finite difference moves silhouettes, which the
# fixed-topology gradient leaves out by design.
FD_CASES = {
    "fd-c5-light-intensity": (
        lambda dev: configs.config5_multimesh(48, 64, n_blobs=2, subdiv=4, device=dev), "bvh",
        lambda s: s.light_color[0, 0], _set_light),
    "fd-c3-sphere-albedo": (
        lambda dev: configs.config3_spheres(64, 64, device=dev), "auto",
        lambda s: s.materials.kd[1, 0], _set_albedo),
}


def fd_case(name: str, device="cuda") -> dict:
    """Central finite difference of sum(image²) in one scalar leaf against
    its gradient, both on `device`."""
    build, accel, get, put = FD_CASES[name]
    t0 = time.perf_counter()
    scene, cfg = build(device)
    plan = prepare(scene, cfg, accel=accel)
    g = float(get(render_and_grad(scene, _loss, cfg, plan=plan)[1]))
    v0 = float(get(scene))
    with torch.no_grad():
        lp = float(_loss(render(put(scene, v0 + FD_STEP), cfg, plan=plan)))
        lm = float(_loss(render(put(scene, v0 - FD_STEP), cfg, plan=plan)))
    fd = (lp - lm) / (2.0 * FD_STEP)
    rel = abs(fd - g) / max(abs(g), 1e-3)
    return {"case": name, "plan": "finite-diff", "grad": g, "fd": fd, "rel_err": round(rel, 5),
            "ok": rel < FD_RTOL, "secs": round(time.perf_counter() - t0, 1)}


def _equality(name, device):
    t0 = time.perf_counter()
    mism = EQUALITY_CASES[name](device)
    return {"case": name, "plan": "equivalence", "mismatches": mism, "ok": mism == 0,
            "secs": round(time.perf_counter() - t0, 1)}


def run(device="cuda") -> dict:
    """Every case on `device`: ``bench.py``'s JSON record.  A case that
    raises fails, with its traceback on stderr, and the rest still run."""
    dev = resolve_device(device)
    calls = ([(name, render_grad_case) for name in RENDER_CASES]
             + [(name, _equality) for name in EQUALITY_CASES]
             + [(name, fd_case) for name in FD_CASES])
    results = []
    for name, fn in calls:
        try:
            result = fn(name, dev)
        except Exception:  # a case that raises is a failed case
            traceback.print_exc()
            result = {"case": name, "ok": False, "error": traceback.format_exc(limit=1)}
        print(f"[verify] {result}", file=sys.stderr, flush=True)
        results.append(result)
    return {"metric": "verify-parity-cases-passed",
            "value": sum(r["ok"] for r in results),
            "unit": f"of {len(results)}",
            "vs_baseline": None,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
            "cases": results}


def main(argv=()) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="where the kernel paths run (the oracle "
                    "always runs on the CPU)")
    args = ap.parse_args(list(argv))
    record = run(args.device)
    print(json.dumps(record))
    return 0 if record["value"] == len(record["cases"]) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
