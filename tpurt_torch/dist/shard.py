"""Tile-parallel rendering over ``torch.distributed`` (``tpurt/dist/shard.py``).

The image is split into horizontal slabs of rows, one a rank; the scene and
the plan are replicated.  ``tpurt`` runs one program over every device and
lets ``shard_map`` split the rows; PyTorch runs one process a rank, so here
every rank calls the same function with the same scene and plan, renders its
own rows, and the rows are gathered so that every rank returns the whole
image.  The backward of the gather hands each rank the cotangent of its own
rows (every rank computes the same loss on the same image, so the cotangent
of the whole image is the same everywhere); the scene's gradients are then
summed over the ranks in rank order (`sum_in_rank_order`), so every rank
holds the same bits and a rerun repeats them.

Rank r renders rows [row0 + r·per, row0 + (r+1)·per) of the window, per =
ceil(nrows / size), clamped to the window: no kernel runs on a pixel outside
the image, and a rank whose window is empty launches nothing but still takes
part in every collective.

Both backends take the same collective, one ``all_gather`` (`_all_gather`).
With NCCL its buffers stay on the card; gloo stages a card's tensors through
the host itself.  The sharded scene's ring (``dist/scene_shard.py``) adds one
step of point to point, `ring_shift`, and its autograd form `_RingShift`.
"""
from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from tpurt_torch.core import geom
from tpurt_torch.core.types import RenderConfig
from tpurt_torch.dist.launch import rank_device
from tpurt_torch.kernels import megakernel, traversal
from tpurt_torch.ref import oracle
from tpurt_torch.render import cap_depth
from tpurt_torch.trace import span


@dataclasses.dataclass
class Mesh:
    """This process's place in a 1-D mesh of ranks.  device: the device this
    rank renders on."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: object = None        # the process group; None is the default group


def make_mesh(device: str) -> Mesh:
    """The mesh of the initialized default process group.  `device` is "cpu"
    or "cuda"; a rank on "cuda" takes ``cuda:{rank % device_count}`` and makes
    it the process's current card, where the collectives that take no tensor
    (``barrier``, ``broadcast_object_list``) put their buffers."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call launch.init_ranks first")
    rank, size = dist.get_rank(), dist.get_world_size()
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(rank=rank, size=size, device=dev, backend=dist.get_backend())


@span("tpurt.all_gather")
def _all_gather(t: torch.Tensor, mesh: Mesh) -> list:
    """all_gather of `t` (the same shape on every rank) over the mesh: one
    tensor a rank, in rank order, on t's device."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    return parts


#: what ring_shift has done since reset_ring_stats(): calls, bytes this rank
#: sent, and host-clock seconds inside the calls (over gloo the host copies
#: make each call wait for its transfer; over NCCL a call returns once the
#: transfer is queued on the card, so the seconds undercount)
ring_stats = {"shifts": 0, "bytes": 0, "seconds": 0.0}


def reset_ring_stats() -> None:
    ring_stats.update(shifts=0, bytes=0, seconds=0.0)


@span("tpurt.ring_shift")
def ring_shift(tensors, mesh: Mesh, back: bool = False) -> list:
    """One step of the ring: every rank sends `tensors` to rank r+1 and
    returns what rank r−1 sent (with `back`, the reverse: to r−1, from r+1).
    Every rank must call it with the same shapes and dtypes.  World 1 sends
    nothing and returns the tensors.

    NCCL (one card a rank) sends CUDA tensors with ``batch_isend_irecv``.
    Gloo fails at, or aborts the process on, point to point of a CUDA tensor,
    so its ranks send host copies and copy what they receive back to the
    tensors' device.  Every send and receive is posted before any is waited
    for."""
    tensors = list(tensors)
    if mesh.size == 1:
        return tensors
    t_start = time.perf_counter()
    step = -1 if back else 1
    dst, src = (mesh.rank + step) % mesh.size, (mesh.rank - step) % mesh.size
    if mesh.backend == "nccl":
        sent = [t.contiguous() for t in tensors]
        got = [torch.empty_like(t) for t in sent]
        ops = ([dist.P2POp(dist.isend, t, dst, mesh.group) for t in sent]
               + [dist.P2POp(dist.irecv, t, src, mesh.group) for t in got])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    else:
        sent = [t.detach().to("cpu", copy=True).contiguous() for t in tensors]
        recv = [torch.empty_like(t) for t in sent]
        reqs = ([dist.isend(t, dst, group=mesh.group, tag=i) for i, t in enumerate(sent)]
                + [dist.irecv(t, src, group=mesh.group, tag=i) for i, t in enumerate(recv)])
        for req in reqs:
            req.wait()
        got = [r.to(t.device) for r, t in zip(recv, tensors)]
    ring_stats["shifts"] += 1
    ring_stats["bytes"] += sum(t.numel() * t.element_size() for t in sent)
    ring_stats["seconds"] += time.perf_counter() - t_start
    return got


class _RingShift(torch.autograd.Function):
    """ring_shift of one tensor under autograd: its backward shifts the
    cotangent the other way, back to the rank that sent the tensor.  Every
    rank must reach these backward shifts in the same order, so every rank
    must build the same graph (a rank with no pixels included)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return ring_shift([t], mesh)[0]

    @staticmethod
    def backward(ctx, g):
        return ring_shift([g], ctx.mesh, back=True)[0], None


def any_over_ranks(flag: bool, mesh: Mesh) -> bool:
    """Whether `flag` holds on any rank: one all_gather of a byte a rank (none
    at world 1), so that every rank takes the same branch."""
    if mesh.size == 1:
        return bool(flag)
    parts = _all_gather(torch.tensor([int(flag)], dtype=torch.int32, device=mesh.device), mesh)
    return bool(torch.cat(parts).any())


@span("tpurt.sum_in_rank_order")
def sum_in_rank_order(tensors, mesh: Mesh) -> list:
    """The sum over the ranks of each tensor of `tensors` (one dtype), added
    in rank order 0, 1, …, n−1: the flat buffers are gathered and their
    slices summed on every rank alike, so every rank holds the same bits and
    a rerun repeats them (an all_reduce sums in the backend's order)."""
    tensors = list(tensors)
    if len({t.dtype for t in tensors}) > 1:
        raise ValueError("sum_in_rank_order takes tensors of one dtype")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    parts = _all_gather(flat, mesh)
    total = parts[0].clone()
    for p in parts[1:]:
        total += p
    out, at = [], 0
    for t in tensors:
        out.append(total[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


def render_rows(scene, config: RenderConfig, row0: int, nrows: int, plan=None):
    """Rows [row0, row0 + nrows) of the image, (nrows, W, 3) f32: the
    single-device building block of every layout.  A clusters plan renders
    through the traversal kernel, a phase-1 plan through the phase-1 forward
    kernel, an oracle plan (or ``config.backend == "oracle"``) through the
    brute-force oracle; without a plan a scene the phase-1 kernels do not
    take raises."""
    if plan is not None and plan.kind == "clusters":
        return traversal.render_rows_clustered(
            scene, cap_depth(config, plan), plan.tri_ids, row0, nrows, tree=plan.tree)
    oracle_plan = plan is not None and plan.kind == "oracle"
    if not oracle_plan and config.backend != "oracle":
        if megakernel.supports(scene, config):
            return megakernel.render_rows_fused(scene, config, row0, nrows)
        # a big or textured scene without a plan would brute-force
        # O(pixels × primitives); that is never intended
        raise ValueError(
            f"scene with {scene.n_tris} tris (textured={scene.textured}) needs a "
            "prepared acceleration plan for sharded rendering: call "
            "tpurt_torch.render.prepare(scene, config) and pass plan=, or set "
            "config.backend='oracle' explicitly.")
    o, d = geom.generate_rays(scene.camera, config.height, config.width, row0, nrows)
    colors = oracle.trace_rays(scene, o.reshape(-1, 3), d.reshape(-1, 3),
                               max_depth=config.max_depth, shadows=config.shadows)
    return colors.reshape(nrows, config.width, 3)


def rows_per_device(height: int, n: int) -> int:
    """Rows a rank, rounding up: ceil(height / n)."""
    return -(-height // n)


def rank_rows(total: int, mesh: Mesh) -> tuple[int, int]:
    """This rank's rows [lo, hi) of a window of `total` rows, clamped to it
    (lo == hi: an empty window)."""
    per = rows_per_device(total, mesh.size)
    lo = min(mesh.rank * per, total)
    return lo, min(lo + per, total)


class _GatherRows(torch.autograd.Function):
    """Forward: every rank's rows, gathered into the whole window on every
    rank.  Backward: this rank's rows of the cotangent, with no collective
    (every rank holds the same cotangent of the whole window)."""

    @staticmethod
    def forward(ctx, rows, mesh, total):
        per = rows_per_device(total, mesh.size)
        lo, hi = rank_rows(total, mesh)
        ctx.window = (lo, hi)
        padded = rows.new_zeros((per, *rows.shape[1:]))
        padded[:hi - lo] = rows
        return torch.cat(_all_gather(padded, mesh))[:total]

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.window
        return g[lo:hi], None, None


def render_sharded(scene, config: RenderConfig, mesh: Mesh, plan=None,
                   row0: int = 0, nrows: int | None = None):
    """Rows [row0, row0 + nrows) of the image (default: all of it), rendered
    tile-parallel over `mesh` and returned whole on every rank, (nrows, W, 3)
    f32 on the mesh's device; differentiable with respect to the scene.

    Every rank must call it with the same scene, config, plan and window.
    Each pixel is computed as the single-device render computes it (each slab
    computes its rays against the whole image), so the image equals the
    single-device render.  The window lets resumable chunked rendering
    (dist/failsafe.py) shard each chunk over the same mesh."""
    if scene.vertices.device != mesh.device:
        raise ValueError(f"the scene is on {scene.vertices.device}, the mesh's rank "
                         f"{mesh.rank} renders on {mesh.device}")
    total = config.height if nrows is None else nrows
    lo, hi = rank_rows(total, mesh)
    if hi > lo:
        rows = render_rows(scene, config, row0 + lo, hi - lo, plan=plan)
    else:  # an empty window: launch nothing, join the gather with zeros
        rows = torch.zeros((0, config.width, 3), dtype=torch.float32, device=mesh.device)
    return _GatherRows.apply(rows, mesh, total)
