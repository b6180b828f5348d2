"""Failure detection and resumable rendering of the port
(tpurt_torch.dist.failsafe), the rank launcher and the multichip dry run,
on the CPU with gloo ranks; the bars of tests/test_dist.py:181-250.

The ranks import this module afresh: it imports no JAX."""
import json
import os
import time

import numpy as np
import pytest
import torch

import tpurt_torch
from tpurt_torch.dist import (Watchdog, WatchdogTimeout, call_with_retries, heartbeat,
                              render_resumable, spawn_ranks)
from tpurt_torch.dist.launch import init_ranks, rank_device
from tpurt_torch.entry import dryrun_multichip, entry
from tpurt_torch.scene import configs

import torch_one_thread  # noqa: F401  (one PyTorch thread)

RESUME_SHAPE, RESUME_CHUNK = (36, 32), 16   # 36 rows: chunks of 16, 16 and 4


def _resume_rank(mesh, out_dir):
    """Over the mesh: a crash after 2 chunks on every rank, then the resumed
    frame (rank 0), and the heartbeat's round trip."""
    scene, cfg = configs.config3_spheres(*RESUME_SHAPE, device="cpu")
    try:
        render_resumable(scene, cfg, out_dir, chunk_rows=RESUME_CHUNK, mesh=mesh,
                         _fail_after=2)
    except RuntimeError as e:
        crashed = str(e)
    else:
        crashed = None
    with open(os.path.join(out_dir, "manifest.json")) as f:
        after_crash = sorted(json.load(f)["chunks"])
    img = render_resumable(scene, cfg, out_dir, chunk_rows=RESUME_CHUNK, mesh=mesh)
    return {"crashed": crashed, "after_crash": after_crash, "image": img,
            "heartbeat_s": heartbeat(mesh, timeout_s=60.0)}


def _raise_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return mesh.rank


def _sleep(mesh, seconds):
    time.sleep(seconds)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("resume2"))
    return spawn_ranks(_resume_rank, 2, "gloo", out, device="cpu", timeout_s=300)


def test_render_resumable_crash_and_resume(tmp_path):
    """Single device: an injected crash after 2 of 4 chunks, then a rerun
    that resumes from the manifest and equals the direct render."""
    scene, cfg = configs.config3_spheres(32, 32, device="cpu")
    direct = tpurt_torch.render(scene, cfg).numpy()
    out = str(tmp_path / "resume")
    with pytest.raises(RuntimeError, match="injected"):
        render_resumable(scene, cfg, out, chunk_rows=8, _fail_after=2)
    with open(out + "/manifest.json") as f:
        assert sorted(json.load(f)["chunks"]) == ["0", "1"]
    img = render_resumable(scene, cfg, out, chunk_rows=8)
    np.testing.assert_array_equal(img, direct)
    with pytest.raises(ValueError, match="different render"):
        render_resumable(scene, cfg, out, chunk_rows=16)


def test_render_resumable_over_two_ranks(world2):
    """Over 2 ranks, 36 rows in ragged chunks: both ranks crash after 2
    chunks, rank 0 kept them in the manifest, the resumed frame equals the
    single-device render and the other rank returns None."""
    scene, cfg = configs.config3_spheres(*RESUME_SHAPE, device="cpu")
    direct = tpurt_torch.render(scene, cfg).numpy()
    for r in world2:
        assert r["crashed"] == "injected failure after 2 chunks"
        assert r["after_crash"] == ["0", "1"]
    np.testing.assert_array_equal(world2[0]["image"], direct)
    assert world2[1]["image"] is None


def test_heartbeat_over_two_ranks(world2):
    assert all(r["heartbeat_s"] > 0.0 for r in world2)


def test_watchdog_and_retries():
    wd = Watchdog(0.2)
    assert wd.run(lambda: 7) == 7
    with pytest.raises(WatchdogTimeout):
        wd.run(time.sleep, 5.0)

    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ValueError("transient")
        return "ok"

    assert call_with_retries(flaky, retries=3, backoff_s=0.01) == "ok"
    assert len(calls) == 3
    # WatchdogTimeout is never retried (the device is wedged)
    with pytest.raises(WatchdogTimeout):
        call_with_retries(lambda: (_ for _ in ()).throw(WatchdogTimeout("x")), retries=3)
    with pytest.raises(ValueError, match="transient"):
        call_with_retries(lambda: (_ for _ in ()).throw(ValueError("transient")),
                          retries=1, backoff_s=0.01)


def test_dryrun_multichip_over_two_gloo_ranks():
    losses = dryrun_multichip(2, "gloo", device="cpu")
    assert set(losses) == {"phase1", "clusters", "ring"}
    assert all(np.isfinite(v) for v in losses.values())


def test_entry_renders_config3_forward():
    fn, args = entry(device="cpu")
    out = fn(*args)
    assert out.shape == (256, 256, 3) and torch.isfinite(out).all()
    assert args[0].vertices.device == torch.device("cpu")


def test_a_rank_that_raises_makes_spawn_raise():
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="rank 1 fails on purpose"):
        spawn_ranks(_raise_on_rank_1, 2, "gloo", device="cpu", timeout_s=120)


def test_ranks_past_their_time_are_stopped():
    with pytest.raises(TimeoutError, match="stopped"):
        spawn_ranks(_sleep, 1, "gloo", 60.0, device="cpu", timeout_s=5.0)


@pytest.mark.parametrize("backend,device", [("mpi", "cpu"), ("gloo", "tpu")])
def test_nothing_picks_a_backend_or_device(backend, device):
    with pytest.raises(ValueError, match="expected"):
        spawn_ranks(_raise_on_rank_1, 2, backend, device=device)


def test_a_card_is_never_replaced_by_the_cpu():
    assert rank_device("cpu", 3) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no card"):
            rank_device("cuda", 0)
    with pytest.raises(ValueError, match="rank 2 is outside"):
        init_ranks("gloo", 2, 2, "file:///nonexistent")
