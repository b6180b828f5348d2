"""The card's check of the sharded scene's ring (tpurt_torch.tools.ring_check,
chip_smoke.py's phase 17) rehearsed on the CPU at a small size: two spawned
ranks over gloo, where the kernels' plain versions run.  Every check of the
tool raises on failure; this holds that they pass and what the main path
launches.  The ranks import the tool, never this module."""
from tpurt_torch.tools import ring_check as RING

import torch_one_thread  # noqa: F401  (one PyTorch thread)

# config 4 at 16x16 (subdiv 2), config 5 at 8x8 (one blob, subdiv 1)
SMALL = {"config 4": (4, 16, 16, {"subdiv": 2}), "config 5": (5, 8, 8, {"n_blobs": 1,
                                                                        "subdiv": 1})}


def test_ring_check_passes_on_the_cpu():
    total, errs, record = RING.run("cpu", "gloo", full=SMALL)
    # both ranks: each render and step traces every bounce's ring steps and
    # shadow passes with the plain versions of K6 and K7, and each step's
    # backward sums with the plain version of K8
    assert set(total) == {"trace_bounce_reference", "trace_shadows_reference",
                          "sorted_segsum_reference"}
    assert errs == {"trace_bounce": 0.0, "trace_shadows": 0.0}
    for name in SMALL:
        times = record[name]["times"]
        assert len(times) == 2 and all(t["shifts"] == 5 for t in times)
        assert all(t["frame_bytes"] == t["closest_pass_bytes"] + t["shadow_pass_bytes"]
                   + t["slice_bytes"] for t in times)
        assert record[name]["losses"][-1] < record[name]["losses"][0]
        assert max(record[name]["grad_share_of_bar"].values()) <= 1.0
