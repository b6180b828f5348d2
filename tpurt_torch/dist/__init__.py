"""Distribution of the port over ``torch.distributed`` (``tpurt/dist``):
tile-parallel rows over a mesh of ranks (Distribution A), the sharded scene
and its ring (Distribution B, ``scene_shard``), the train step on one
device, over a mesh or on the ring, failure detection and resumable
rendering."""
from tpurt_torch.dist.failsafe import (
    Watchdog,
    WatchdogTimeout,
    call_with_retries,
    heartbeat,
    render_resumable,
)
from tpurt_torch.dist.launch import init_ranks, spawn_ranks
from tpurt_torch.dist.scene_shard import (
    ShardParts,
    prepare_scene_sharded,
    render_scene_sharded,
    render_scene_sharded_prepared,
    renumber_by_clusters,
)
from tpurt_torch.dist.shard import Mesh, make_mesh, render_sharded, sum_in_rank_order
from tpurt_torch.dist.train import (
    make_ring_train_step,
    make_train_step,
    render_and_grad_scene_sharded,
    render_and_grad_sharded,
    sgd_update,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "init_ranks",
    "spawn_ranks",
    "render_sharded",
    "render_and_grad_sharded",
    "ShardParts",
    "render_scene_sharded",
    "render_scene_sharded_prepared",
    "render_and_grad_scene_sharded",
    "prepare_scene_sharded",
    "renumber_by_clusters",
    "make_ring_train_step",
    "sum_in_rank_order",
    "make_train_step",
    "sgd_update",
    "render_resumable",
    "heartbeat",
    "call_with_retries",
    "Watchdog",
    "WatchdogTimeout",
]
