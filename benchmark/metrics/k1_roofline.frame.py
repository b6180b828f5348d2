"""K1 (``megakernel_fwd``, the phase-1 plan's forward) against its roofline,
in %: the least time an H100 could take for a frame's forward work over
K1's device time a frame.

The work is ``k4_roofline.py``'s operation counts a primitive test, a
shaded point and a light, with its reverse terms left out: every closest-hit
pass and open shadow ray tests the whole table, a blocked shadow ray needs
one test.  The path counts (closest-hit passes, shaded points on triangles
and on spheres, blocked shadow rays) come from the benchmark's own
reference render of the first kept frame, never from the program.  Bytes:
each pixel's outputs written once (colour, 12 B, and one occlusion word a
depth) and the packed table read once.

The table comes from the program's counters ``megakernel.prims`` and
``megakernel.pixels`` (``tpurt_torch.trace``), which count while the
profiler records: every K1 launch of the traced frames must have held the
configuration's triangles and spheres (at least one of each: a scene
without triangles holds one degenerate triangle, as every scene of the
program does) and the frames' every pixel, or the reader returns None, so
that a program that drops primitives or pixels cannot raise its share.  The
work counts the configuration's own primitives alone.
"""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("benchmark_metric_k4_roofline_for_k1",
                                               Path(__file__).with_name("k4_roofline.py"))
K4 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(K4)

MODE = "frame"
KERNEL = "megakernel_fwd"


def table_prims(n_tris, n_spheres):
    """Primitives of a launch's table: the scene's, with a pad of each kind
    where it has none."""
    return max(n_tris, 1) + max(n_spheres, 1)


def k1_bound_s(counts, n_tris, n_spheres, n_lights, shadows, n_pix, depths):
    rays = sum(counts["rays"])
    tri, sph = sum(counts["shaded_tri"]), sum(counts["shaded_sph"])
    shadow = (tri + sph) * n_lights if shadows else 0
    blocked = sum(counts["blocked"])
    per_ray = n_tris * K4.OPS_TRI_TEST + n_spheres * K4.OPS_SPH_TEST + K4.OPS_RAY_SETUP
    closest = rays * per_ray
    shadows_ops = (shadow - blocked) * per_ray + blocked * (K4.OPS_SPH_TEST + K4.OPS_RAY_SETUP)
    shade = tri * (K4.OPS_SHADE_FIXED + K4.OPS_NORMAL_TRI) \
        + sph * (K4.OPS_SHADE_FIXED + K4.OPS_NORMAL_SPH) \
        + (tri + sph) * n_lights * K4.OPS_SHADE_LIGHT
    ops = closest + shadows_ops + shade
    table = 4 * (K4.GLOBAL_BASE + 6 * n_lights + K4.TRI_FORM_FLOATS * n_tris
                 + K4.SPH_FORM_FLOATS * n_spheres + K4.ATTR_FLOATS * (n_tris + n_spheres))
    nbytes = n_pix * (12 + 4 * depths) + table
    return max(ops / K4.PEAK_FP32_FLOPS, nbytes / K4.PEAK_BYTES_PER_S)


def read(ctx):
    if ctx.mode != MODE or ctx.trace is None or ctx.ref_counts is None or not ctx.traced_calls:
        return None
    try:
        from tpurt_torch import trace
    except ImportError:
        return None
    seconds, n = ctx.trace.kernel_seconds(lambda name: KERNEL in name)
    if not n:
        return None
    cfg = ctx.config
    counts = trace.snapshot()
    if (counts.get("megakernel.prims") != n * table_prims(cfg["triangles"], cfg["spheres"])
            or counts.get("megakernel.pixels") != ctx.traced_calls * ctx.n_pix):
        return None
    bound = k1_bound_s(ctx.ref_counts, cfg["triangles"], cfg["spheres"], cfg["lights"],
                       cfg["shadows"], ctx.n_pix, cfg["max_depth"] + 1)
    return 100.0 * bound / (seconds / ctx.traced_calls)
