"""Starting the ranks of a mesh: the port's counterpart of the device set
that ``tpurt`` gets from ``jax.distributed.initialize`` (one process a host,
every device visible) and from the virtual CPU devices of its tests.

PyTorch runs one process a rank.  `init_ranks` starts the default process
group in a process that is already running (one a host, as the command line's
``multihost-render`` does); `spawn_ranks` starts `world` processes on this
host, runs a function in each and hands each rank's result back to the
parent.  The caller names the backend ("nccl" or "gloo") and the device kind
("cpu" or "cuda"): nothing here picks either, and nothing switches backend
when one fails.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("nccl", "gloo")
#: seconds a collective may wait for its peers before it raises
COLLECTIVE_TIMEOUT_S = 600.0


def rank_device(kind: str, local_rank: int) -> torch.device:
    """The device of a rank: ``cpu``, or ``cuda:{local_rank % device_count}``.
    Raises when `kind` is "cuda" and there is no card."""
    if kind == "cpu":
        return torch.device("cpu")
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' was asked for, but torch sees no card")
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    raise ValueError(f"device kind {kind!r}: expected 'cpu' or 'cuda'")


def init_ranks(backend: str, rank: int, world: int, store_or_address) -> None:
    """Start the default process group of `world` ranks as rank `rank`.

    `store_or_address` is a ``torch.distributed.Store`` or an init URL such
    as ``tcp://host:port`` (rank 0 listens there) or ``file:///path``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is outside a world of {world}")
    timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    if isinstance(store_or_address, dist.Store):
        dist.init_process_group(backend, store=store_or_address, rank=rank,
                                world_size=world, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method=store_or_address, rank=rank,
                                world_size=world, timeout=timeout)


def _rank_main(rank, fn, world, backend, device, tmp, args):
    """Body of one spawned rank: start the group, build the mesh, run fn and
    save its result where the parent reads it."""
    from tpurt_torch.dist.shard import make_mesh

    torch.set_num_threads(1)  # the ranks share the host's cores
    init_ranks(backend, rank, world, dist.FileStore(os.path.join(tmp, "store"), world))
    try:
        result = fn(make_mesh(device), *args)
        torch.save(result, os.path.join(tmp, f"result_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, backend: str, *args, device: str,
                timeout_s: float | None = None) -> list:
    """Run ``fn(mesh, *args)`` in `world` new processes, one a rank, and
    return their results in rank order.

    `fn` must be importable by name (a module-level function: each process
    imports its module afresh) and return plain CPU tensors, numpy arrays or
    Python values.  The ranks meet through a ``FileStore`` in a temporary
    directory, so no port is taken.  `device` is "cpu" or "cuda" (rank r on
    ``cuda:{r % device_count}``).  A rank that raises makes this raise (the
    other ranks are stopped); with `timeout_s`, ranks still running after it
    are stopped and TimeoutError is raised."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device kind {device!r}: expected 'cpu' or 'cuda'")
    with tempfile.TemporaryDirectory(prefix="tpurt_ranks_") as tmp:
        ctx = mp.spawn(_rank_main, args=(fn, world, backend, device, tmp, args),
                       nprocs=world, join=False)
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while not ctx.join(timeout=None if deadline is None
                           else max(deadline - time.monotonic(), 0.0)):
            if deadline is not None and time.monotonic() >= deadline:
                for proc in ctx.processes:
                    proc.kill()
                    proc.join()
                raise TimeoutError(f"{world} ranks still ran after {timeout_s} s; stopped")
        return [torch.load(os.path.join(tmp, f"result_{r}.pt"), weights_only=False)
                for r in range(world)]
