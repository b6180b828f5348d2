"""Inverse-rendering train step on one device (``tpurt/dist/train.py``):
gradient descent of a pixel L2 loss against a target image, with gradients
flowing to every float scene parameter."""
from __future__ import annotations

import torch

from tpurt_torch.core.types import RenderConfig
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


def make_train_step(config: RenderConfig, mesh=None, plan: RenderPlan | None = None):
    """Build a train step `(scene, target, lr) -> (scene', loss)` for the mean
    squared error of the render against `target` (H, W, 3).

    On a phase-1 plan the loss and every gradient come from one pass of the
    hand-adjoint kernel (megakernel.l2_loss_and_grad), scaled from the sum to
    the mean.  On a clusters plan the step is render_and_grad: the traversal
    kernel, deferred shading under autograd and the sorted segment-sum kernel
    for the gradients of the gathered tables (vertices, materials, texels).  Rendering over a device mesh is not
    ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "the tile-parallel train step over a device mesh is not ported "
            "yet (ROADMAP.md, Queue 1, 'Distribution')")
    fused_ok = plan is None or plan.kind == "phase1"

    def step(scene, target, lr):
        with torch.no_grad():
            if fused_ok and MK.supports(scene, config):
                sq_sum, grads = MK.l2_loss_and_grad(scene, target, config)
                scale = 1.0 / (config.height * config.width * 3)
                scaled = {path: g * scale for path, g in MK.scene_float_leaves(grads)}
                grads = MK.scene_like(grads, scaled)
                return sgd_update(scene, grads, lr), sq_sum * scale
            (loss, _), grads = render_and_grad(
                scene, lambda img: torch.mean((img - target) ** 2), config, plan=plan)
            return sgd_update(scene, grads, lr), loss

    return step
