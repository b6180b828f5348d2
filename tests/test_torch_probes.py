"""The plain versions of the two probe kernels (tpurt_torch/kernels/probes.py)
against numpy.  Their originals, the Pallas kernels of
scripts/probe_segsum.py, cannot be imported: that script measures on a TPU
while it is imported.  It holds its A·Bᵀ kernel to the same numpy product
(scripts/probe_segsum.py:69); the CUDA kernels are held to these plain
versions on the card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from tpurt_torch.kernels import probes
from tpurt_torch.tools import probe_segsum

import torch_one_thread  # noqa: F401  (one PyTorch thread)


@pytest.mark.parametrize("m,n,k", [(8, 512, 1536), (3, 5, 7), (1, 1, 1), (17, 9, 40)])
def test_abt_plain_version_equals_numpy(m, n, k):
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).bfloat16()
    probes.reset_launches()
    out = probes.abt(a, b)
    assert probes.launches["abt_reference"] == 1 and probes.launches["abt"] == 0
    assert out.shape == (m, n) and out.dtype == torch.float32
    ref = a.float().numpy().astype(np.float64) @ b.float().numpy().astype(np.float64).T
    # bf16 products are exact in f32; the f32 sum of k terms of size ~1
    # rounds k times: 1e-5 of the largest entry is far above that
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("nblocks,br,w", [(960, 512, 8), (3, 5, 2), (5, 6, 3)])
def test_zeros_blocks_plain_version(nblocks, br, w):
    out = probes.zeros_blocks(nblocks, br, w, device="cpu")
    assert out.shape == (w, nblocks * br) and out.dtype == torch.float32
    assert np.array_equal(out.numpy(), np.zeros((w, nblocks * br), np.float32))  # exact


def test_probe_wrappers_reject_what_they_do_not_take():
    a = torch.zeros((2, 4), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16"):
        probes.abt(a.float(), a)
    with pytest.raises(ValueError, match="bf16"):
        probes.abt(a, a[:, :3])
    with pytest.raises(ValueError, match="card"):
        probes.abt_cuda(a, a)
    with pytest.raises(ValueError, match="nblocks"):
        probes.zeros_blocks(0, 4, 4, device="cpu")
    with pytest.raises(ValueError, match="card"):
        probes.zeros_blocks_cuda(2, 4, 4, "cpu")


def test_the_tool_measures_nothing_without_a_card_and_at_import():
    """Importing the tool runs nothing; without a card every measurement
    raises (the card tests run them where there is one)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs the tool")
    for fn in (probe_segsum.probe_abt, probe_segsum.probe_zeros_blocks,
               probe_segsum.probe_gathers, probe_segsum.probe_argsort, probe_segsum.main):
        with pytest.raises(RuntimeError, match="card"):
            fn()


@pytest.mark.parametrize("kind", ["uniform", "dominant", "out_of_range", "sparse"])
def test_synthetic_streams_are_what_they_say(kind):
    idx, upd = probe_segsum.synthetic_stream(kind, 4000, 500, 6, seed=1)
    again, _ = probe_segsum.synthetic_stream(kind, 4000, 500, 6, seed=1)
    i = idx.numpy()
    assert idx.dtype == torch.int32 and upd.shape == (4000, 6) and torch.equal(idx, again)
    outside = ((i < 0) | (i >= 500)).mean()
    assert (outside > 0.2) == (kind == "out_of_range") and (outside > 0) == (kind == "out_of_range")
    assert (np.bincount(i[(i >= 0) & (i < 500)]).max() > 1500) == (kind == "dominant")
    assert (np.unique(i).size <= 7) == (kind == "sparse")
