"""The two measurement probes of the segment-sum design (the kernels of
``scripts/probe_segsum.py``): wrappers and plain versions.

``csrc/probes.cu`` replaces ``_abt_kernel`` (``abt``: A·Bᵀ of two bf16
matrices, contracted over their minor axes, into f32) and ``_zero_kernel``
(``zeros_blocks``: one (w, br) tile of zeros a grid step).  A tensor on the
CPU goes to the plain version; a tensor on a card goes to the kernel, or the
call raises.  ``tpurt_torch/tools/probe_segsum.py`` runs them at the probe's
sizes beside its gather and argsort measurements.
"""
from __future__ import annotations

import torch

#: calls since reset_launches(): each kernel's wrapper and each plain version
launches = {"abt": 0, "zeros_blocks": 0, "abt_reference": 0, "zeros_blocks_reference": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _launch(dev, name, fn, *args):
    from tpurt_torch.kernels import build

    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, f"{name} launch")
    launches[name] += 1


def _check_abt(a, b):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1] \
            or a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or a.device != b.device:
        raise ValueError(f"want bf16 a (M, K) and b (N, K) on one device, got {a.dtype} "
                         f"{tuple(a.shape)} on {a.device} and {b.dtype} {tuple(b.shape)} "
                         f"on {b.device}")


def abt_reference(a, b):
    """Plain version of abt: the f32 product of the widened matrices."""
    _check_abt(a, b)
    launches["abt_reference"] += 1
    return a.float() @ b.float().t()


def abt_cuda(a, b):
    """Launch csrc/probes.cu:abt_kernel on the current stream of a's card."""
    from tpurt_torch.kernels import build

    _check_abt(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes tensors on a card, not on {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.float32, device=a.device)
    if out.numel():
        _launch(a.device, "abt", build.load().tpurt_abt, a.data_ptr(), b.data_ptr(),
                out.data_ptr(), a.shape[0], b.shape[0], a.shape[1])
    return out


def abt(a, b):
    """a (M, K) bf16, b (N, K) bf16 → a·bᵀ (M, N) f32, every product and the
    sum in f32."""
    return abt_reference(a, b) if a.device.type == "cpu" else abt_cuda(a, b)


def _check_blocks(nblocks, br, w):
    if min(nblocks, br, w) < 1 or w * nblocks * br >= 2 ** 31:
        raise ValueError(f"want nblocks, br, w >= 1 and under 2^31 elements, got "
                         f"{nblocks}, {br}, {w}")


def zeros_blocks_reference(nblocks: int, br: int, w: int, device="cpu"):
    """Plain version of zeros_blocks."""
    _check_blocks(nblocks, br, w)
    launches["zeros_blocks_reference"] += 1
    return torch.zeros((w, nblocks * br), dtype=torch.float32, device=device)


def zeros_blocks_cuda(nblocks: int, br: int, w: int, device):
    """Launch csrc/probes.cu:zeros_blocks_kernel, one thread block a tile, on
    the current stream of `device`."""
    from tpurt_torch.kernels import build

    _check_blocks(nblocks, br, w)
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel writes to a card, not to {device}")
    out = torch.empty((w, nblocks * br), dtype=torch.float32, device=device)
    _launch(out.device, "zeros_blocks", build.load().tpurt_zeros_blocks, out.data_ptr(),
            nblocks, br, w)
    return out


def zeros_blocks(nblocks: int, br: int, w: int, device=None):
    """(w, nblocks·br) f32 zeros, written tile by tile: on the card unless the
    caller asks for the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cpu":
        return zeros_blocks_reference(nblocks, br, w)
    return zeros_blocks_cuda(nblocks, br, w, device)
