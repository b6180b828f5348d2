"""Distribution of the port over ``torch.distributed`` (``tpurt/dist``):
tile-parallel rows over a mesh of ranks, the train step on one device or
over a mesh, failure detection and resumable rendering.  The sharded scene
and its ring (``tpurt/dist/scene_shard.py``, ``make_ring_train_step``) are
not ported yet (ROADMAP.md, Queue 1 item 2)."""
from tpurt_torch.dist.failsafe import (
    Watchdog,
    WatchdogTimeout,
    call_with_retries,
    heartbeat,
    render_resumable,
)
from tpurt_torch.dist.launch import init_ranks, spawn_ranks
from tpurt_torch.dist.shard import Mesh, make_mesh, render_sharded, sum_in_rank_order
from tpurt_torch.dist.train import make_train_step, render_and_grad_sharded, sgd_update

__all__ = [
    "Mesh",
    "make_mesh",
    "init_ranks",
    "spawn_ranks",
    "render_sharded",
    "render_and_grad_sharded",
    "sum_in_rank_order",
    "make_train_step",
    "sgd_update",
    "render_resumable",
    "heartbeat",
    "call_with_retries",
    "Watchdog",
    "WatchdogTimeout",
]
