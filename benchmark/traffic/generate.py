"""The one traffic generator: it reads a mix's parameters
(``benchmark/traffic/<name>.json``) and the seed, and makes everything a
run will feed the program, on the host, before the window.

kind "orbit" (``cli animate``): camera positions on a circle about the
look-at point at the eye's height and distance, ``deg_per_frame`` apart
from a seeded phase; each revolution starts ``deg_offset_per_rev`` later,
so no pose repeats within a run.

kind "inverse" (``cli inverse``): runs of ``steps_per_start`` train steps,
each from a start drawn from the seed: every light's colour times
U(light_scale), every material's kd times U(kd_scale) plus ``kd_shift``.
"""
from __future__ import annotations

import math

import numpy as np


def orbit_eyes(params: dict, seed: int, camera: dict, n: int) -> np.ndarray:
    """(n, 3) float32 eye positions of frames 0 .. n-1."""
    rng = np.random.default_rng([seed, 1])
    eye = np.asarray(camera["eye"], np.float64)
    look = np.asarray(camera["look_at"], np.float64)
    radius = math.hypot(eye[0] - look[0], eye[2] - look[2])
    phi0 = math.atan2(eye[2] - look[2], eye[0] - look[0]) + rng.uniform(0.0, 2.0 * math.pi)
    k = np.arange(n, dtype=np.float64)
    step = params["deg_per_frame"]
    per_rev = max(1, int(round(360.0 / step)))
    phi = phi0 + np.radians(k * step + (k // per_rev) * params["deg_offset_per_rev"])
    return np.stack([look[0] + radius * np.cos(phi), np.full(n, eye[1]),
                     look[2] + radius * np.sin(phi)], -1).astype(np.float32)


def inverse_starts(params: dict, seed: int, arrays: dict, n: int) -> list:
    """n starts, each {"light_color": (L, 3), "kd": (M, 3)} float32."""
    rng = np.random.default_rng([seed, 2])
    lc = np.asarray([l[1] for l in arrays["lights"]], np.float32)
    kd = np.asarray([[m["kd"]] * 3 if np.isscalar(m["kd"]) else m["kd"]
                     for m in arrays["materials"]], np.float32)
    out = []
    for _ in range(n):
        ls = rng.uniform(*params["light_scale"], size=(len(lc), 1)).astype(np.float32)
        ks = rng.uniform(*params["kd_scale"], size=(len(kd), 1)).astype(np.float32)
        out.append({"light_color": lc * ls,
                    "kd": kd * ks + np.float32(params["kd_shift"])})
    return out
