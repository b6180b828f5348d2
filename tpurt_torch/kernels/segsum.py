"""Sorted-segment row accumulation: the sum behind every table gather of the
clustered backward, the vertex table's first (the counterpart of
``tpurt/kernels/segsum.py``).

    out[r, :] = Σ_{n : idx[n] == r} upd[n, :]        (idx ascending)

``csrc/segsum.cu`` replaces the TPU kernel
``tpurt/kernels/segsum.py:_segsum_kernel``.  What carries over is the
contract, not the mechanism (a one-hot matrix product over a transposed
panel with the indices as f32): here ``idx`` stays int32, ``upd`` stays
(N, W) row-major f32, and ``n_rows`` has no 2^24 limit.

* entries whose idx lies outside [0, n_rows) add nothing (their update
  rows are never read);
* rows with no update come back zero; every output row is written exactly
  once and the kernel has no atomics, so two calls on the same input agree
  bit for bit (``index_add_`` on a card sums by atomics in an order that
  changes from run to run);
* the summation order within a row: each thread of the kernel adds its
  slice of ``items(W)`` consecutive entries left to right; a segmented scan
  joins the slices in a fixed tree (shuffles over 1, 2, 4, 8, 16 lanes, the
  warps of a tile in warp order, the tiles of a block in order), and a second
  launch adds the blocks' partial sums in block order.  The order depends on
  the indices, W and the card's SM count only, so the result differs from a
  serial sum only in f32 summation order, and equals itself from call to
  call and whether the rows come sorted or through ``order``;
* NaN and Inf in a live update reach the output as in a plain sum;
* any W from 1 to MAX_WIDTH, any N including 0.

``sorted_segsum`` takes a sorted stream, or sorted indices with the updates
as they were and ``order``, the positions that sort them: the kernel then
reads row ``order[i]`` for entry i, so the row permutation costs no pass of
its own.  ``segsum_rows`` sorts first (a stable sort, a PyTorch call).  A
tensor on the CPU goes to the plain version ``sorted_segsum_reference``
(``index_add_`` into zeros); a tensor on a card goes to the kernel, or the
call raises.  One call of the kernel's wrapper is one or two launches of the
same kernel (``pass_plan``): a persistent grid over the stream, then one
block over the two partial sums that each block of the first leaves (its
first and its last run, which may go on in a neighbouring block).
"""
from __future__ import annotations

import functools

import torch

#: threads of a block of the kernel (csrc/segsum.cu: SEG_THREADS)
THREADS = 256
#: widest update row the kernel is built for (csrc/segsum.cu: SEG_MAX_W)
MAX_WIDTH = 32

#: calls since reset_launches(): the kernel's wrapper and the plain version
launches = {"sorted_segsum": 0, "sorted_segsum_reference": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def items(width: int) -> int:
    """Consecutive entries a thread of the kernel sums in a tile, whose rows it
    keeps in registers: about 32 floats (csrc/segsum.cu: seg_items)."""
    return 1 if width >= 32 else min(8, 32 // width)


def blocks_per_sm(width: int) -> int:
    """Blocks an SM of the kernel's persistent grid: three for rows of up to
    12 floats, two for wider ones (csrc/segsum.cu: seg_blocks_per_sm)."""
    return 3 if width <= 12 else 2


def pass_plan(n: int, width: int, sms: int) -> list[int]:
    """Stream lengths of the kernel's launches over n updates of `width` on a
    card of `sms` SMs.  The first sees one entry more (a sentinel after the
    last update, which zero-fills the rows behind it) in tiles of THREADS *
    items(width) entries, on at most blocks_per_sm(width) blocks an SM; where that
    grid is more than one block, each block leaves two partial sums, which
    one block adds in a second launch."""
    tiles = -(-(n + 1) // (THREADS * items(width)))
    blocks = min(tiles, blocks_per_sm(width) * sms)
    return [n] if blocks == 1 else [n, 2 * blocks]


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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(dev) -> int:
    return _sm_count(dev.index if dev.index is not None else torch.cuda.current_device())


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
    if upd_sorted.data_ptr() % 16:
        upd_sorted = upd_sorted.clone()   # the kernel's row loads want 16-byte alignment
    out = torch.empty((n_rows, width), dtype=torch.float32, device=dev)
    parts = sum(pass_plan(n, width, _sms(dev))[1:])
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
    segsum_rows hands it over, for the kernel's bound: the index, the sorting
    position and the update row of each in-range entry once (the out-of-range
    ones lie at the ends of the sorted stream, and the kernel finds where the
    in-range stretch begins and ends without reading the rest), every output
    row once; one add for each in-range update's column."""
    live = int(((idx_sorted >= 0) & (idx_sorted < n_rows)).sum())
    return (4 + 8) * live + 4 * width * (live + n_rows), live * width
