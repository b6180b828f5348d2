"""Failure detection and resumable rendering (``tpurt/dist/failsafe.py``).

- `Watchdog`: a wall-clock bound on any call.  A hung device call or
  collective cannot be cancelled from Python, so on timeout the caller gets
  `WatchdogTimeout` and should exit; completed work is already on disk.
- `call_with_retries`: retry a call after a transient exception;
  `WatchdogTimeout` is never retried.
- `heartbeat(mesh)`: an all_reduce of ones over the ranks under a watchdog:
  if a peer is gone or hung the collective never completes and the watchdog
  says so, instead of the job hanging silently.
- `render_resumable`: a frame rendered in slabs of rows with a manifest on
  disk: a restarted run (same out_dir) skips the chunks already done.
"""
from __future__ import annotations

import concurrent.futures as _futures
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist


class WatchdogTimeout(RuntimeError):
    """A watched call exceeded its wall-clock budget (likely a hung device
    call or a lost peer).  The call cannot be cancelled from Python; restart
    the process and resume from the chunk manifest."""


class Watchdog:
    """Run calls under a wall-clock bound in a worker thread.

    On timeout the worker thread is abandoned (a hung C or CUDA call is not
    interruptible) and `WatchdogTimeout` is raised in the caller: pair it
    with `render_resumable` so that a restart loses at most one chunk.
    """

    def __init__(self, timeout_s: float):
        self.timeout_s = float(timeout_s)
        self._pool = _futures.ThreadPoolExecutor(max_workers=1)

    def run(self, fn, *args, **kwargs):
        fut = self._pool.submit(fn, *args, **kwargs)
        try:
            return fut.result(timeout=self.timeout_s)
        except _futures.TimeoutError:
            # leave the worker behind; a fresh one takes later calls
            self._pool = _futures.ThreadPoolExecutor(max_workers=1)
            raise WatchdogTimeout(
                f"call exceeded {self.timeout_s:.1f}s wall-clock budget") from None


def call_with_retries(fn, *args, retries: int = 2, backoff_s: float = 1.0,
                      on_retry=None, **kwargs):
    """Call fn; on an exception retry up to `retries` times with linear
    backoff.  WatchdogTimeout is NOT retried (the device is wedged: retrying
    in this process races the abandoned call)."""
    for attempt in range(retries + 1):
        try:
            return fn(*args, **kwargs)
        except WatchdogTimeout:
            raise
        except Exception as e:  # noqa: BLE001 — transient runtime errors
            if attempt == retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(backoff_s * (attempt + 1))
    raise AssertionError("unreachable")


def heartbeat(mesh, timeout_s: float = 60.0) -> float:
    """All-peers liveness probe: an all_reduce of ones over the mesh's
    ranks, bounded by a watchdog.  Returns the round trip in seconds; raises
    WatchdogTimeout if a peer is gone (the collective blocks otherwise)."""
    # gloo reduces CPU tensors; NCCL reduces on the card
    dev = torch.device("cpu") if mesh.backend == "gloo" else mesh.device

    def probe():
        t0 = time.perf_counter()
        ones = torch.ones((1,), dtype=torch.int32, device=dev)
        dist.all_reduce(ones, group=mesh.group)
        if int(ones.item()) != mesh.size:
            raise RuntimeError(f"heartbeat summed {int(ones.item())} ranks of {mesh.size}")
        return time.perf_counter() - t0

    return Watchdog(timeout_s).run(probe)


# ---------------------------------------------------------------------------
# resumable chunked rendering
# ---------------------------------------------------------------------------
def _manifest_path(out_dir):
    return os.path.join(out_dir, "manifest.json")


def _read_manifest(out_dir, H, W, chunk_rows) -> dict:
    mpath = _manifest_path(out_dir)
    if not os.path.exists(mpath):
        return {}
    with open(mpath) as f:
        m = json.load(f)
    if (m["height"], m["width"], m["chunk_rows"]) != (H, W, chunk_rows):
        raise ValueError(
            f"out_dir {out_dir} holds a different render "
            f"({m['height']}x{m['width']} @{m['chunk_rows']}); use a fresh directory")
    return {k: v for k, v in m["chunks"].items()
            if os.path.exists(os.path.join(out_dir, v))}


def render_resumable(scene, config, out_dir: str, *, chunk_rows: int = 128,
                     plan=None, mesh=None, timeout_s: float | None = None,
                     retries: int = 2, _fail_after: int | None = None):
    """Render the frame in slabs of `chunk_rows` rows, saving each to
    `out_dir` and the manifest after it; a rerun with the same out_dir skips
    the chunks done and returns the assembled (H, W, 3) float32 numpy image.

    Without a mesh each chunk is `shard.render_rows` on the scene's device,
    retried up to `retries` times.  With a mesh (dist.shard.Mesh) every rank
    runs this loop with the same arguments and each chunk goes through
    `render_sharded`: rank 0 reads the manifest and broadcasts the chunks
    done, writes each chunk and then the manifest, and the ranks meet at a
    barrier after each.  Over a mesh a chunk is not retried: a rank that
    failed cannot rejoin its peers' collectives, so the run ends and a
    restart resumes from the manifest.  Rank 0 returns the image, the other
    ranks None.  `timeout_s` bounds each chunk with a Watchdog.
    `_fail_after` raises after that many chunks, on every rank alike (tests).
    """
    from tpurt_torch.dist.shard import render_rows, render_sharded

    H, W = config.height, config.width
    n_chunks = -(-H // chunk_rows)
    lead = mesh is None or mesh.rank == 0
    done: dict[str, str] = {}
    if lead:
        os.makedirs(out_dir, exist_ok=True)
        done = _read_manifest(out_dir, H, W, chunk_rows)
    if mesh is not None:
        box = [done]
        dist.broadcast_object_list(box, src=0, group=mesh.group)
        done = box[0]

    wd = Watchdog(timeout_s) if timeout_s is not None else None
    rendered = 0
    for ci in range(n_chunks):
        key = str(ci)
        if key in done:
            continue
        row0 = ci * chunk_rows
        nrows = min(chunk_rows, H - row0)

        def render_chunk(row0=row0, nrows=nrows):
            if mesh is not None:
                img = render_sharded(scene, config, mesh, plan=plan, row0=row0, nrows=nrows)
            else:
                img = render_rows(scene, config, row0, nrows, plan=plan)
            return img.detach().cpu().numpy()

        fn = (lambda: wd.run(render_chunk)) if wd is not None else render_chunk
        chunk = fn() if mesh is not None else call_with_retries(fn, retries=retries)
        done[key] = f"chunk_{ci:05d}.npy"
        if lead:
            np.save(os.path.join(out_dir, done[key]), chunk)
            with open(_manifest_path(out_dir), "w") as f:  # after EVERY chunk
                json.dump({"height": H, "width": W, "chunk_rows": chunk_rows,
                           "chunks": done}, f)
        if mesh is not None:
            dist.barrier(group=mesh.group)
        rendered += 1
        if _fail_after is not None and rendered >= _fail_after:
            raise RuntimeError(f"injected failure after {rendered} chunks")

    if not lead:
        return None
    out = np.empty((H, W, 3), np.float32)
    for ci in range(n_chunks):
        row0 = ci * chunk_rows
        out[row0:row0 + chunk_rows] = np.load(os.path.join(out_dir, done[str(ci)]))
    return out
