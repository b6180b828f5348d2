"""The card's check of tile-parallel rows (tpurt_torch.tools.dist_check,
chip_smoke.py's phase 16) rehearsed on the CPU at a small size: world 1 in
this process and two spawned ranks over gloo, where the kernels' plain
versions run, and multihost-render as two processes.  Every check of the
tool raises on failure; this holds that they pass and what the main path
launches.  The ranks import the tool, never this module."""
import torch

from tpurt_torch.tools import dist_check as DIST

import torch_one_thread  # noqa: F401  (one PyTorch thread)

# config 3 at 36x32 (chunks of 8 rows: 5 of them), config 4 at 32x32, subdiv 3
SIZES = ((36, 32), (32, 32), 3)
A_RANK = {"tile_color_reference": 1 + DIST.STEPS3, "tile_color_vjp_reference": DIST.STEPS3,
          "trace_records_reference": 1 + DIST.STEPS4,
          "sorted_segsum_reference": 2 * DIST.STEPS4}


def test_dist_check_passes_on_the_cpu():
    total, record = DIST.run("cpu", "gloo", "gloo", sizes=SIZES, chunk_rows=8)
    # world 1 and the two ranks of world 2
    assert total == {k: 3 * n for k, n in A_RANK.items()}
    for world in ("world1", "world2"):
        assert max(record[world]["gaps"].values()) <= DIST.GRAD_RTOL
        assert record[world]["gather_ms"] > 0.0 and record[world]["sum_ms"] > 0.0
    assert record["world1"]["gaps"]["vertices"] == 0.0    # world 1 is the single device
    assert not any(k.startswith("probe") for k in record)


def test_tests_run_pytorch_on_one_thread():
    # torch_one_thread's rule, which the bit-equal world-1 gradients above
    # rely on
    assert torch.get_num_threads() == 1
