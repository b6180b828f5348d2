"""Sorted-segment row accumulation: the sum behind every table gather of the
clustered backward, the vertex table's first (the counterpart of
``tpurt/kernels/segsum.py``).

    out[r, :] = Σ_{n : idx[n] == r} upd[n, :]        (idx ascending)

``csrc/segsum.cu`` replaces the TPU kernel
``tpurt/kernels/segsum.py:_segsum_kernel``.  What carries over is the
contract, not the mechanism (a one-hot matrix product over a transposed
panel with the indices as f32): here ``idx`` stays int32, ``upd`` stays
(N, W) row-major f32, and ``n_rows`` has no 2^24 limit.

* entries whose idx lies outside [0, n_rows) add nothing (a chunk of the
  stream that holds only such entries reads no update row);
* rows with no update come back zero; every output row is written exactly
  once and the kernel has no atomics, so two calls on the same input agree
  bit for bit (``index_add_`` on a card sums by atomics in an order that
  changes from run to run);
* within a row the updates are summed in ascending stream order inside a
  chunk of CHUNK entries, and the chunks' partial sums in ascending chunk
  order: the result differs from a serial sum only in f32 summation order;
* NaN and Inf in a live update reach the output as in a plain sum;
* any W from 1 to MAX_WIDTH, any N including 0.

``sorted_segsum`` takes a sorted stream, or sorted indices with the updates
as they were and ``order``, the positions that sort them: the kernel then
reads row ``order[i]`` for entry i, so the row permutation costs no pass of
its own.  ``segsum_rows`` sorts first (a stable sort, a PyTorch call).  A
tensor on the CPU goes to the plain version ``sorted_segsum_reference``
(``index_add_`` into zeros); a tensor on a card goes to the kernel, or the
call raises.  One call of the kernel's wrapper is one to three passes of the
same kernel (``pass_plan``): the stream, then the partial sums of the rows
that straddle chunk borders, until one chunk holds what is left.
"""
from __future__ import annotations

import torch

#: stream entries a thread block sums (csrc/segsum.cu: SEG_CHUNK)
CHUNK = 512
#: widest update row the kernel is built for (csrc/segsum.cu: SEG_MAX_W)
MAX_WIDTH = 16

#: calls since reset_launches(): the kernel's wrapper and the plain version
launches = {"sorted_segsum": 0, "sorted_segsum_reference": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def pass_plan(n: int) -> list[int]:
    """Stream lengths of the kernel's passes over n updates.  The first pass
    sees one entry more (a sentinel after the last update, which zero-fills
    the rows behind it); every pass but the last leaves two partial sums a
    chunk (its first and its last run) to the next."""
    plan = [n]
    chunks = -(-(n + 1) // CHUNK)
    while chunks > 1:
        plan.append(2 * chunks)
        chunks = -(-plan[-1] // CHUNK)
    return plan


def _check(idx_sorted, upd_sorted, n_rows, order=None):
    if idx_sorted.dim() != 1 or upd_sorted.dim() != 2 \
            or upd_sorted.shape[0] != idx_sorted.shape[0]:
        raise ValueError(f"want idx (N,) and upd (N, W), got {tuple(idx_sorted.shape)} "
                         f"and {tuple(upd_sorted.shape)}")
    if order is not None and (order.shape != idx_sorted.shape or order.dtype != torch.int64
                              or order.device != idx_sorted.device):
        raise ValueError(f"want order (N,) int64 beside idx, got {order.dtype} "
                         f"{tuple(order.shape)} on {order.device}")
    if idx_sorted.dtype != torch.int32 or not upd_sorted.dtype.is_floating_point:
        raise ValueError(f"want int32 idx and floating upd, got {idx_sorted.dtype} "
                         f"and {upd_sorted.dtype}")
    if idx_sorted.device != upd_sorted.device:
        raise ValueError(f"idx on {idx_sorted.device}, upd on {upd_sorted.device}")
    if n_rows < 0 or n_rows >= 2 ** 31:
        raise ValueError(f"n_rows {n_rows} must be in [0, 2^31)")


def sorted_segsum_reference(idx_sorted, upd_sorted, n_rows: int, order=None):
    """Plain version of sorted_segsum, on any device and in any float type:
    index_add_ of the in-range entries into zeros."""
    _check(idx_sorted, upd_sorted, n_rows, order)
    launches["sorted_segsum_reference"] += 1
    if order is not None:
        upd_sorted = upd_sorted.index_select(0, order)
    ok = (idx_sorted >= 0) & (idx_sorted < n_rows)
    out = torch.zeros((n_rows, upd_sorted.shape[1]), dtype=upd_sorted.dtype,
                      device=upd_sorted.device)
    return out.index_add_(0, idx_sorted[ok], upd_sorted[ok])


def sorted_segsum_cuda(idx_sorted, upd_sorted, n_rows: int, order=None):
    """Launch csrc/segsum.cu on the current stream of the tensors' card.
    Same contract as sorted_segsum_reference, float32 only."""
    from tpurt_torch.kernels import build

    _check(idx_sorted, upd_sorted, n_rows, order)
    dev = upd_sorted.device
    n, width = upd_sorted.shape
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes tensors on a card, not on {dev}")
    if upd_sorted.dtype != torch.float32 or not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"the kernel takes float32 rows of 1 to {MAX_WIDTH} columns, got "
                         f"{upd_sorted.dtype} of {width}")
    if not (idx_sorted.is_contiguous() and upd_sorted.is_contiguous()
            and (order is None or order.is_contiguous())):
        raise ValueError("idx, upd and order must be contiguous")
    out = torch.empty((n_rows, width), dtype=torch.float32, device=dev)
    parts = sum(pass_plan(n)[1:])
    part_idx = torch.empty(parts, dtype=torch.int32, device=dev)
    part_val = torch.empty((parts, width), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = build.load().tpurt_sorted_segsum(
            idx_sorted.data_ptr(), upd_sorted.data_ptr(),
            None if order is None else order.data_ptr(), n, width, n_rows, out.data_ptr(),
            part_idx.data_ptr(), part_val.data_ptr(), parts,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "sorted_segsum launch")
    launches["sorted_segsum"] += 1
    return out


def sorted_segsum(idx_sorted, upd_sorted, n_rows: int, order=None):
    """out[r] = Σ upd rows whose (ASCENDING) idx == r; out (n_rows, W).

    `idx_sorted` (N,) int32 ascending, `upd_sorted` (N, W) float.  With
    `order` (N,) int64, entry i's update is row order[i] of `upd_sorted`
    (which then need not be sorted).  Callers sort (see `segsum_rows`);
    unsorted indices give undefined sums."""
    if upd_sorted.device.type == "cpu":
        return sorted_segsum_reference(idx_sorted, upd_sorted, n_rows, order)
    return sorted_segsum_cuda(idx_sorted, upd_sorted, n_rows, order)


def segsum_rows(idx, upd, n_rows: int):
    """Unsorted segment-sum: a stable sort (so a row's updates keep their
    stream order) and sorted_segsum, which reads the rows in that order.
    `idx` entries outside [0, n_rows) contribute nothing (lanes to drop)."""
    flat = idx.reshape(-1).to(torch.int32)
    updf = upd.reshape(-1, upd.shape[-1]).contiguous()
    idx_sorted, order = torch.sort(flat, stable=True)
    return sorted_segsum(idx_sorted, updf, n_rows, order)


def segsum_counts(idx_sorted, n_rows: int, width: int):
    """(bytes, operations) that the kernel needs for this stream as
    segsum_rows hands it over, for the kernel's bound: every index and every
    sorting position once, the update rows of the in-range entries once, every
    output row once; one add for each in-range update's column."""
    live = int(((idx_sorted >= 0) & (idx_sorted < n_rows)).sum())
    return (4 + 8) * idx_sorted.numel() + 4 * width * (live + n_rows), live * width
