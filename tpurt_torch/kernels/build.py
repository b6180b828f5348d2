"""Build the port's CUDA kernels with nvcc and load them through ctypes.

The sources in ``csrc/`` have a plain C interface (no PyTorch headers), so
``nvcc`` builds each in seconds; one ``nvcc`` per source runs at the same
time and a last call links the objects.  The library lands in
``build/tpurt_torch/<hash>/`` at the root of the checkout, keyed by a hash
of the sources and flags, and is built at first use.  A missing ``nvcc`` or
a failed build raises with the compiler's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "tpurt_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # every product and sum rounds on its own, as in the plain version
    "-fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers and spills, kept in nvcc.log
)
LIB_NAME = "libtpurt_torch_kernels.so"

_lib = None  # the loaded library, once per process


def find_nvcc() -> str:
    """`nvcc` on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").is_file():
        return str(home / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or in $CUDA_HOME/bin (default "
        "/usr/local/cuda/bin); it is needed to build tpurt_torch/kernels/csrc"
    )


def build() -> Path:
    """Path of the built library, compiling it if this source hash has no
    build yet."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / LIB_NAME
    if so.is_file():
        return so
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f".{os.getpid()}"
    objects = [out_dir / f"{tag}.{src.stem}.o" for src in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objects)]
    tmp = out_dir / f"{tag}.{LIB_NAME}"
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objects)]
    try:
        # one compiler per source, all started together
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in cmds]
        log = "".join(f"{' '.join(cmd)}\n{proc.communicate()[0]}"
                      for cmd, proc in zip(cmds, procs))
        rc = max(proc.returncode for proc in procs)
        if rc == 0:
            linked = subprocess.run(link, capture_output=True, text=True)
            log += f"{' '.join(link)}\n{linked.stdout}{linked.stderr}"
            rc = linked.returncode
        if rc != 0:
            raise RuntimeError(f"nvcc failed with exit code {rc}:\n{log}")
        (out_dir / "nvcc.log").write_text(log)
        os.replace(tmp, so)  # atomic: another process never loads half a file
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    return so


def load() -> ctypes.CDLL:
    """The kernels' library, built and loaded at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        scene = [ptr, ptr, ptr, ptr, i32, i32, i32]  # forms, attrs, glob, T, S, L
        frame = [i32, i32, ctypes.c_float,           # H, W, aspect
                 i32, i32, i32, i32,                 # max_depth, shadows, off, n_pix
                 ptr]                                # stream
        tables = [ptr, ptr, i32, i32, ptr, ptr]      # partials, out, blocks, records, key_of, rec
        lib.tpurt_megakernel_fwd.argtypes = [*scene, ptr, ptr, *frame]  # colour, occ
        lib.tpurt_megakernel_bwd.argtypes = [*scene, ptr, ptr, *tables, *frame]  # occ, g
        lib.tpurt_l2_fused.argtypes = [*scene, ptr, ptr, *tables, *frame]  # target, sq
        lib.tpurt_l2_hand.argtypes = [*scene, ptr, ptr, *tables, *frame]   # target, sq
        # tri_forms, tri_attrs, boxes, wide_boxes, wide_children, group_boxes,
        # sph_forms, sph_attrs, glob, n_clusters, leaf, n_sph, n_lights, n_tris
        clusters = [ptr] * 9 + [i32] * 5
        lib.tpurt_trace_records.argtypes = [
            *clusters, ptr, ptr, ptr, ptr,           # ids, occ, tbest, stats
            i32, i32, ctypes.c_float,                # H, W, aspect
            i32, i32, i32, i32, ptr]                 # max_depth, shadows, off, n_pix, stream
        lib.tpurt_trace_bounce.argtypes = [
            *clusters, ptr, ptr, ptr, i32,           # o, d, alive, n_live
            ptr, ptr, ptr, ptr,                      # ids, occ, tbest, stats
            i32, i32, ptr]                           # shadows, n, stream
        lib.tpurt_trace_shadows.argtypes = [
            *clusters, ptr, ptr, ptr, i32,           # p, p_off, alive, n_live
            ptr, ptr, i32, ptr]                      # occ, stats, n, stream
        i64 = ctypes.c_longlong
        lib.tpurt_sorted_segsum.argtypes = [
            ptr, ptr, ptr, i64, i32, i32, ptr,       # idx, upd, order, n, width, n_rows, out
            ptr, ptr, i64, ptr]                      # part_idx, part_val, entries, stream
        # op, a, b, c, out, n, stream
        lib.tpurt_phase1_helpers.argtypes = [i32, ptr, ptr, ptr, ptr, i32, ptr]
        f32 = ctypes.c_float
        lib.tpurt_shade_records.argtypes = [
            ptr, ptr, ptr, i32, ptr, i32, ptr, i32,  # prim, is_tri, occ, n, o, d (row strides)
            ptr, ptr, ptr, ptr, ptr, i32,            # vertices, vnormals, uvs, triangles, tri_mat, T
            ptr, ptr, ptr, i32, i32,                 # sph_center, sph_radius, sph_mat, S, has_spheres
            ptr, ptr, ptr, ptr, ptr, ptr,            # ka, kd, ks, shininess, reflectivity, texture_id
            ptr, i32, i32,                           # textures, th, tw
            ptr, ptr, ptr, i32,                      # light_pos, light_color, ambient, L
            i32, i32, i32, i32,                      # max_depth, shadows, smooth, textured
            f32, f32, f32, f32, f32,                 # background, clamp lo, hi
            f32, f32, f32, f32, f32, f32,            # offset, det, t_min, t_max, normalize, light
            ptr, ptr]                                # out, stream
        lib.tpurt_abt.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]  # a, b, out, m, n, k
        lib.tpurt_zeros_blocks.argtypes = [ptr, i32, i32, i32, ptr]   # out, nblocks, br, w
        for fn in (lib.tpurt_megakernel_fwd, lib.tpurt_megakernel_bwd,
                   lib.tpurt_l2_fused, lib.tpurt_l2_hand, lib.tpurt_trace_records,
                   lib.tpurt_trace_bounce, lib.tpurt_trace_shadows,
                   lib.tpurt_sorted_segsum, lib.tpurt_abt, lib.tpurt_zeros_blocks,
                   lib.tpurt_phase1_helpers, lib.tpurt_shade_records):
            fn.restype = i32
        for kernel in ("megakernel_bwd", "l2_fused", "l2_hand"):  # n, depths, records, blocks
            getattr(lib, f"tpurt_{kernel}_occupancy").argtypes = [i32, i32, i32, ptr]
            getattr(lib, f"tpurt_{kernel}_occupancy").restype = i32
        lib.tpurt_record_map.argtypes = [i32, i32, i32, ptr]    # n_tris, n_sph, n_lights, dst
        lib.tpurt_record_map.restype = i32
        lib.tpurt_phase1_shared_bytes.argtypes = [i32, i32, i32]      # n, depths, fixed
        lib.tpurt_phase1_shared_bytes.restype = ctypes.c_longlong
        lib.tpurt_shared_limits.argtypes = [ptr, ptr, ptr]  # per SM, per block, reserved
        lib.tpurt_shared_limits.restype = i32
        lib.tpurt_cuda_error_string.argtypes = [i32]
        lib.tpurt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = load().tpurt_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
