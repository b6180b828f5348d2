"""The port's sorted segment sum (tpurt_torch/kernels/segsum.py) against
tpurt's Pallas kernel (tpurt/kernels/segsum.py, in interpret mode on the CPU)
on the same streams, made from numpy seeds.  On CPU tensors the port runs its
plain version; the CUDA kernel is held to that plain version on the card
(tests/test_torch_cuda.py)."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.kernels import segsum as JS
from tpurt_torch.kernels import segsum as TS
from tpurt_torch.tools.probe_segsum import synthetic_stream

import torch_one_thread  # noqa: F401  (one PyTorch thread)

N_ROWS = 1100   # three of tpurt's 512-row blocks, the last one ragged
N = 3000


def assert_sums_close(got, want):
    """The bar of tests/test_grad.py:331: both sum the same f32 products, in
    another order."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-6 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("kind,width", [
    (kind, width) for kind in ("uniform", "dominant", "out_of_range", "sparse")
    for width in (3, 6, 8)] + [("dominant", 32)])   # 32: the phase-1 records
def test_segsum_rows_matches_tpurt(kind, width):
    idx, upd = synthetic_stream(kind, N, N_ROWS, width, seed=width)
    # tpurt carries idx as f32 and pads with a sentinel: keep negatives out
    # of its stream by sending them above the table, where both drop them
    jidx = np.where(idx.numpy() < 0, N_ROWS + 7, idx.numpy()).astype(np.int32)
    want = JS.segsum_rows(jnp.asarray(jidx), jnp.asarray(upd.numpy()), N_ROWS)
    TS.reset_launches()
    got = TS.segsum_rows(idx, upd, N_ROWS)
    assert TS.launches == {"sorted_segsum": 0, "sorted_segsum_reference": 1}
    assert got.shape == (N_ROWS, width) and got.dtype == torch.float32
    assert_sums_close(got.numpy(), want)
    touched = np.unique(idx.numpy()[(idx.numpy() >= 0) & (idx.numpy() < N_ROWS)])
    empty = np.setdiff1d(np.arange(N_ROWS), touched)
    assert empty.size > 0 and not got.numpy()[empty].any()     # rows with no update
    assert np.abs(got.numpy()[touched]).max() > 0


@pytest.mark.parametrize("width", [3, 8])
def test_sorted_segsum_matches_tpurt(width):
    idx, upd = synthetic_stream("uniform", N, N_ROWS, width, seed=11)
    order = np.argsort(idx.numpy(), kind="stable")
    idx_s, upd_s = idx.numpy()[order], upd.numpy()[order]
    want = JS.sorted_segsum(jnp.asarray(idx_s), jnp.asarray(upd_s), N_ROWS)
    got = TS.sorted_segsum(torch.from_numpy(idx_s), torch.from_numpy(upd_s), N_ROWS)
    assert_sums_close(got.numpy(), want)
    # the unsorted updates with the positions that sort them: the same stream
    again = TS.sorted_segsum(torch.from_numpy(idx_s), upd, N_ROWS, torch.from_numpy(order))
    assert torch.equal(got, again)


@pytest.mark.parametrize("n", [0, 1, 511, 512, 513, 1031])
def test_segsum_rows_equals_a_float64_sum_at_any_length(n):
    idx, upd = synthetic_stream("out_of_range", n, 37, 5, seed=n)
    got = TS.segsum_rows(idx, upd, 37)
    want = np.zeros((37, 5))
    ok = (idx.numpy() >= 0) & (idx.numpy() < 37)
    np.add.at(want, idx.numpy()[ok], upd.numpy()[ok].astype(np.float64))
    assert got.shape == (37, 5)
    assert_sums_close(got.numpy(), want)


def test_segsum_keeps_stream_order_and_propagates_nan_and_inf():
    # a stable sort keeps a row's updates in stream order: (1e8 + 1) - 1e8
    # is 0 in f32 in that order, 1 in the other
    idx = torch.tensor([2, 0, 2, 2, 1, 9, -1], dtype=torch.int32)
    upd = torch.tensor([[1e8], [np.inf], [1.0], [-1e8], [np.nan], [np.nan], [np.inf]])
    got = TS.segsum_rows(idx, upd, 4)[:, 0]
    assert got[2] == 0.0 and torch.isinf(got[0]) and torch.isnan(got[1]) and got[3] == 0.0


def test_pass_plan_of_the_kernel():
    """What the wrapper allocates for the kernel's launches: a persistent grid
    of at most blocks_per_sm(W) blocks an SM over tiles of THREADS * items(W)
    entries (the stream and a sentinel); where it is more than one block,
    two partial sums a block, which one block adds in a second launch."""
    assert [TS.items(w) for w in (1, 4, 5, 6, 8, 11, 16, 17, 32)] == [8, 8, 6, 5, 4, 2, 2, 1, 1]
    sms = 132
    tile = TS.THREADS * TS.items(6)
    assert TS.pass_plan(0, 6, sms) == [0] and TS.pass_plan(tile - 1, 6, sms) == [tile - 1]
    assert TS.pass_plan(tile, 6, sms) == [tile, 4]
    # the main paths' vertex streams fill the grid: 396 blocks, 792 partial sums
    assert TS.pass_plan(3145728, 6, sms) == [3145728, 792]
    assert TS.pass_plan(6220800, 8, sms) == [6220800, 792]
    assert TS.pass_plan(6220800, 32, sms) == [6220800, 528]     # the records: 2 an SM
    for n, w in ((513, 3), (3145728, 6), (1048576, 11), (6220800, 32), (2 ** 31 - 2, 1)):
        plan = TS.pass_plan(n, w, sms)
        blocks = min(-(-(n + 1) // (TS.THREADS * TS.items(w))), TS.blocks_per_sm(w) * sms)
        assert plan == ([n] if blocks == 1 else [n, 2 * blocks])
        assert plan[-1] <= TS.THREADS * TS.items(w) * 8     # one block, a few tiles
    # the constants the kernel is built with
    text = (Path(TS.__file__).resolve().parent / "csrc" / "segsum.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert (const("SEG_THREADS"), const("SEG_MAX_W")) == (TS.THREADS, TS.MAX_WIDTH)
    assert "return w >= 32 ? 1 : (32 / w > 8 ? 8 : 32 / w);" in text
    assert "seg_blocks_per_sm(int w) { return w <= 12 ? 3 : 2; }" in text
    assert [TS.blocks_per_sm(w) for w in (1, 12, 13, 32)] == [3, 3, 2, 2]


@pytest.mark.parametrize("below,live,above", [(0, 1000, 0), (300, 1000, 200), (0, 0, 50),
                                              (0, 0, 0)])
def test_segsum_counts_charge_the_entries_in_range(below, live, above):
    # the entries out of range lie at the sorted stream's ends, and the kernel
    # reads none of them: its bound charges the index, the sorting position and
    # the row of each entry in range once, and each output row once
    n_rows, width = 37, 6
    rng = np.random.default_rng(below + live + above)
    idx = np.concatenate([rng.integers(-5, 0, below), rng.integers(0, n_rows, live),
                          rng.integers(n_rows, n_rows + 9, above)])
    idx_s = torch.from_numpy(np.sort(idx).astype(np.int32))
    nbytes, flops = TS.segsum_counts(idx_s, n_rows, width)
    assert nbytes == (4 + 8) * live + 4 * width * (live + n_rows)
    assert flops == live * width


def test_wrappers_reject_what_they_do_not_take():
    idx, upd = synthetic_stream("uniform", 8, 4, 3, seed=0)
    with pytest.raises(ValueError, match="int32"):
        TS.sorted_segsum(idx.long(), upd, 4)
    with pytest.raises(ValueError, match=r"\(N,\)"):
        TS.sorted_segsum(idx[:7], upd, 4)
    with pytest.raises(ValueError, match="order"):
        TS.sorted_segsum(idx, upd, 4, torch.arange(7))
    with pytest.raises(ValueError, match="card"):
        TS.sorted_segsum_cuda(idx, upd, 4)
