"""Build the port's CUDA kernels with nvcc and load them through ctypes.

The sources in ``csrc/`` have a plain C interface (no PyTorch headers), so
one ``nvcc`` call builds them in seconds.  The library lands in
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
    "-shared", "-Xcompiler", "-fPIC",
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
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / LIB_NAME
    if so.is_file():
        return so
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{os.getpid()}.{LIB_NAME}"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n{log}")
    (out_dir / "nvcc.log").write_text(log)
    os.replace(tmp, so)  # atomic: another process never loads half a file
    return so


def load() -> ctypes.CDLL:
    """The kernels' library, built and loaded at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.tpurt_megakernel_fwd.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr,            # forms, attrs, glob, outputs
            i32, i32, i32, i32, i32, ctypes.c_float,  # T, S, L, H, W, aspect
            i32, i32, i32, i32,                      # max_depth, shadows, off, n_pix
            ptr,                                     # stream
        ]
        lib.tpurt_megakernel_fwd.restype = i32
        lib.tpurt_cuda_error_string.argtypes = [i32]
        lib.tpurt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = load().tpurt_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
