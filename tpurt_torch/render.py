"""Public render API of the port: `prepare`, `render` and `render_and_grad`
(``tpurt/render.py``).

Plan kinds:
  "phase1" — the hand-written forward and backward kernels
             (tpurt_torch.kernels.megakernel) for scenes of at most 4096
             triangles and 4096 spheres, untextured.
  "oracle" — the brute-force plain PyTorch path (tpurt_torch.ref); correct
             for any untextured scene, cost O(pixels × primitives).
Larger or textured scenes need the clustered path, which is not ported yet:
asking for it raises.
"""
from __future__ import annotations

import dataclasses

import torch

from tpurt_torch.core.types import RenderConfig
from tpurt_torch.kernels import megakernel
from tpurt_torch.ref import oracle


@dataclasses.dataclass(frozen=True)
class RenderPlan:
    """How `render` draws a scene: kind is "phase1" or "oracle"."""

    kind: str


def prepare(scene, config: RenderConfig | None = None, accel=None) -> RenderPlan:
    """The render plan for `scene`.  `accel` overrides config.accel."""
    config = config or RenderConfig()
    accel = accel or config.accel
    if accel == "none":
        return RenderPlan(kind="oracle")
    if megakernel.supports(scene, config) and accel == "auto":
        return RenderPlan(kind="phase1")
    raise NotImplementedError(
        f"a scene with {scene.n_tris} triangles, {scene.n_spheres} spheres "
        f"(textured={scene.textured}, accel={accel!r}) needs the clustered "
        "path (tpurt/kernels/traversal.py:_trav_kernel and deferred "
        "shading), which is not ported yet (ROADMAP.md, Queue 2); render it "
        "with accel='none' for the oracle"
    )


def _render_oracle(scene, config: RenderConfig):
    # chunk size scales inversely with primitive count so the brute-force
    # (pixels × primitives) intermediates stay bounded at any scene size
    prims = max(scene.n_tris + scene.n_spheres, 1)
    chunk = int(max(256, min(8192, (1 << 22) // prims)))
    return oracle.render_ref(scene, config=config, chunk=chunk)


def render(scene, config: RenderConfig | None = None,
           plan: RenderPlan | None = None, **overrides):
    """Render `scene` to an (H, W, 3) float32 image in [0, 1] on the
    scene's device.  Keyword overrides are applied on top of `config`
    (e.g. ``render(scene, width=1920, height=1080)``)."""
    config = config or RenderConfig()
    if overrides:
        config = config.replace(**overrides)
    if plan is None:
        if config.backend == "oracle":
            return _render_oracle(scene, config)
        plan = prepare(scene, config)
    if plan.kind == "phase1":
        return megakernel.render_fused(scene, config)
    return _render_oracle(scene, config)


def render_and_grad(scene, loss_fn, config: RenderConfig | None = None,
                    plan: RenderPlan | None = None, **overrides):
    """Render and differentiate: returns ((loss, image), grads) where grads
    is a Scene of cotangents with None on integer leaves.

    `loss_fn(image) -> scalar` runs under autograd.  Gradients flow to every
    float leaf of the scene (vertices, normals, materials, lights, camera) at
    fixed hit topology; on a phase-1 plan the forward and the backward are
    each one kernel launch."""
    config = config or RenderConfig()
    if overrides:
        config = config.replace(**overrides)
    if plan is None:
        plan = prepare(scene, config)
    paths, leaves = zip(*megakernel.scene_float_leaves(scene))
    live = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        image = render(
            megakernel.scene_like(scene, dict(zip(paths, live)), default=lambda t: t),
            config, plan=plan)
        loss = loss_fn(image)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(live, grads)]
    return ((loss.detach(), image.detach()),
            megakernel.scene_like(scene, dict(zip(paths, grads))))
