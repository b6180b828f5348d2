"""Inverse-rendering train step (``tpurt/dist/train.py``): gradient descent
of a pixel L2 loss against a target image, with gradients flowing to every
float scene parameter, on one device, tile-parallel over a mesh of ranks, or
on the sharded scene's ring (``make_ring_train_step``)."""
from __future__ import annotations

import torch

from tpurt_torch.core.types import RenderConfig
from tpurt_torch.dist.scene_shard import ShardParts, render_scene_sharded_prepared
from tpurt_torch.dist.shard import Mesh, render_sharded, sum_in_rank_order
from tpurt_torch.kernels import megakernel as MK
from tpurt_torch.render import RenderPlan, render_and_grad


def sgd_update(scene, grads, lr):
    """SGD on every float leaf of the scene; integer leaves (and leaves whose
    gradient is None) pass through unchanged."""
    values = {}
    grad_of = dict(MK.scene_float_leaves(grads))
    for path, p in MK.scene_float_leaves(scene):
        g = grad_of.get(path)
        values[path] = p if g is None else p - lr * g
    return MK.scene_like(scene, values, default=lambda t: t)


def _render_and_grad_summed(scene, loss_fn, mesh: Mesh, render_fn):
    """((loss, image), grads) of `render_fn(scene)` on every rank, the
    gradients summed over the ranks in rank order."""
    paths, leaves = zip(*MK.scene_float_leaves(scene))
    live = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        image = render_fn(MK.scene_like(scene, dict(zip(paths, live)), default=lambda t: t))
        loss = loss_fn(image)
    if loss.requires_grad:
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    else:  # this rank rendered no rows: nothing of its image depends on the scene
        grads = [None] * len(live)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(live, grads)]
    grads = sum_in_rank_order(grads, mesh)
    return ((loss.detach(), image.detach()), MK.scene_like(scene, dict(zip(paths, grads))))


def render_and_grad_sharded(scene, loss_fn, config: RenderConfig, mesh: Mesh,
                            plan: RenderPlan | None = None):
    """``render.render_and_grad`` over a mesh: returns ((loss, image), grads)
    on every rank, where image is the whole image from `render_sharded` and
    grads a Scene of cotangents (None on integer leaves) summed over the ranks
    in rank order, the same bits on every rank.

    Each rank differentiates its own rows only: on a phase-1 plan the
    forward kernel and the replay backward kernel over those rows, on a
    clusters plan the traversal kernel, deferred shading under autograd and
    the segment-sum kernel.  A rank whose window is empty contributes zeros."""
    return _render_and_grad_summed(scene, loss_fn, mesh,
                                   lambda s: render_sharded(s, config, mesh, plan=plan))


def render_and_grad_scene_sharded(scene2, loss_fn, config: RenderConfig,
                                  parts: ShardParts, mesh: Mesh):
    """``render_and_grad`` on the ring (``dist/scene_shard.py``): returns
    ((loss, image), grads) on every rank, grads a Scene of cotangents (None
    on integer leaves) summed over the ranks in rank order, the same bits on
    every rank.

    Every rank runs the backward, a rank with no rows too (its image still
    depends on its corner slice): it carries the other ranks' cotangents of
    its slice back through the ring's reverse rotations and hands its vertex
    rows' share to the global leaves."""
    return _render_and_grad_summed(
        scene2, loss_fn, mesh,
        lambda s: render_scene_sharded_prepared(s, config, parts, mesh))


def make_ring_train_step(config: RenderConfig, mesh: Mesh, parts: ShardParts):
    """Train step `(scene2, target, lr) -> (scene2', loss)` on the ring: the
    mean squared error of `render_scene_sharded_prepared` against `target`
    (H, W, 3), gradients to every float leaf of the renumbered scene, summed
    in rank order, so every rank holds the same scene after it.  `parts`
    comes from ``prepare_scene_sharded`` (host, once); pass the scene2 it
    returns, or any update of it with the same topology, as the step's
    scene.  Every rank calls the step with the same scene and target."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh={mesh!r}: the ring runs over a "
                        "tpurt_torch.dist.shard.Mesh (make_mesh)")

    def step(scene2, target, lr):
        with torch.no_grad():
            (loss, _), grads = render_and_grad_scene_sharded(
                scene2, lambda img: torch.mean((img - target) ** 2), config, parts, mesh)
            return sgd_update(scene2, grads, lr), loss

    return step


def make_train_step(config: RenderConfig, mesh: Mesh | None = None,
                    plan: RenderPlan | None = None):
    """Build a train step `(scene, target, lr) -> (scene', loss)` for the mean
    squared error of the render against `target` (H, W, 3).

    On one device and a phase-1 plan the loss and every gradient come from
    one pass of the hand-adjoint kernel (megakernel.l2_loss_and_grad), scaled
    from the sum to the mean.  Otherwise the step differentiates the render:
    on a clusters plan the traversal kernel, deferred shading under autograd
    and the sorted segment-sum kernel for the gradients of the gathered
    tables (vertices, materials, texels).  With a mesh (dist.shard.Mesh) every
    rank calls the step with the same scene and target: each renders its
    rows (the phase-1 forward and replay backward kernels, or the clustered
    path), the loss is computed on the gathered image alike on every rank,
    and the gradients are summed in rank order before the update, so every
    rank holds the same scene after it."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh={mesh!r}: the mesh of tile-parallel rows is a "
            "tpurt_torch.dist.shard.Mesh (make_mesh); the sharded scene's ring "
            "trains with make_ring_train_step")
    fused_ok = mesh is None and (plan is None or plan.kind == "phase1")

    def loss_fn(target):
        return lambda img: torch.mean((img - target) ** 2)

    def step(scene, target, lr):
        with torch.no_grad():
            if fused_ok and MK.supports(scene, config):
                sq_sum, grads = MK.l2_loss_and_grad(scene, target, config)
                scale = 1.0 / (config.height * config.width * 3)
                scaled = {path: g * scale for path, g in MK.scene_float_leaves(grads)}
                grads = MK.scene_like(grads, scaled)
                return sgd_update(scene, grads, lr), sq_sum * scale
            if mesh is None:
                (loss, _), grads = render_and_grad(scene, loss_fn(target), config, plan=plan)
            else:
                (loss, _), grads = render_and_grad_sharded(scene, loss_fn(target), config,
                                                           mesh, plan=plan)
            return sgd_update(scene, grads, lr), loss

    return step
