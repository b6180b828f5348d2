"""Public render API of the port: `prepare`, `render` and `render_and_grad`
(``tpurt/render.py``).

Plan kinds:
  "phase1"   — the hand-written forward and backward kernels
               (tpurt_torch.kernels.megakernel) for scenes of at most 4096
               triangles and 4096 spheres, untextured.
  "clusters" — everything else, large scenes and textured scenes of any
               size, and any scene asked for with accel="bvh" or "grid": the
               hand-written traversal kernel (tpurt_torch.kernels.traversal)
               over cluster blocks built on the host by the C++ builders
               (tpurt_torch.accel.native: the sweep-SAH clusters, or the
               uniform grid's cells), then deferred shading in PyTorch under
               autograd (tpurt_torch.shading.deferred), whose table gathers
               (vertices, materials, texels) have the hand-written sorted
               segment sum (tpurt_torch.kernels.segsum) as their backward.
  "oracle"   — the brute-force plain PyTorch path (tpurt_torch.ref); correct
               for any scene, cost O(pixels × primitives).
"""
from __future__ import annotations

import dataclasses

import torch

from tpurt_torch.accel.clusters import ClusterSet, build_tree, slot_order
from tpurt_torch.accel.native import build_clusters_native, build_grid_native
from tpurt_torch.core.types import RenderConfig
from tpurt_torch.kernels import megakernel, traversal
from tpurt_torch.kernels.packc import DeviceTree
from tpurt_torch.ref import oracle


@dataclasses.dataclass(frozen=True)
class RenderPlan:
    """Prepared acceleration state for a scene, built on the host.

    kind: "phase1"   — the phase-1 kernels; nothing else is used
          "clusters" — traversal kernel + deferred shading; tri_ids is the
                       frozen (C, 128) cluster topology and tree the frozen
                       topology of the upper level over the clusters (binary
                       and 4 wide) with the order of each cluster's slots
                       that makes its groups of 16 compact, all on the
                       scene's device (all boxes are refit from the live
                       vertices every frame)
          "oracle"   — brute force
    depth_cap: the largest depth any path can reach (None = the config's).
          prepare() sets 0 when no material reflects: every path ends at
          the primary hit, so no bounce is traced or shaded.
    """

    kind: str
    tri_ids: torch.Tensor | None = None
    depth_cap: int | None = None
    tree: DeviceTree | None = None


ACCELS = ("none", "bvh", "grid", "auto")


def prepare(scene, config: RenderConfig | None = None, accel=None) -> RenderPlan:
    """Build the render plan for `scene` (host work: call it once on the
    template scene and pass the plan to render()).  `accel` overrides
    config.accel ("none" | "bvh" | "grid" | "auto")."""
    config = config or RenderConfig()
    accel = accel or config.accel
    if accel not in ACCELS:
        raise ValueError(f"accel={accel!r}: expected one of {ACCELS}")
    if accel == "none":
        return RenderPlan(kind="oracle")
    if megakernel.supports(scene, config) and accel == "auto":
        return RenderPlan(kind="phase1")
    # everything else, big scenes and textured scenes of any size, goes
    # through cluster traversal + deferred shading
    verts, tris = scene.vertices.detach().cpu().numpy(), scene.triangles.cpu().numpy()
    if accel == "grid":
        cs = build_grid_native(verts, tris)
    else:
        cs = build_clusters_native(verts, tris)
    return clusters_plan(scene, cs)


def clusters_plan(scene, cs: ClusterSet) -> RenderPlan:
    """The clusters plan over the blocks `cs` of the scene's triangles (from
    any builder): the upper level over the blocks' build-time boxes and each
    block's slot order, on the scene's device.  The boxes themselves are
    refit from the live vertices every frame (``kernels/packc.py``), so a
    grid block's cell clamp shapes only the upper level."""
    dev = scene.vertices.device
    verts, tris = scene.vertices.detach().cpu().numpy(), scene.triangles.cpu().numpy()
    tree = build_tree(cs.aabb_lo, cs.aabb_hi)
    # no reflective material: no path survives depth 0
    depth_cap = None if bool((scene.materials.reflectivity > 0.0).any()) else 0
    return RenderPlan(kind="clusters",
                      tri_ids=torch.from_numpy(cs.tri_ids).to(dev),
                      depth_cap=depth_cap,
                      tree=DeviceTree.from_host(tree, dev,
                                                slot_order(verts, tris, cs.tri_ids)))


def cap_depth(config: RenderConfig, plan) -> RenderConfig:
    """Apply the plan's depth cap (see RenderPlan.depth_cap).  The image is
    the same: capped depths are exactly the ones no path reaches."""
    if plan.depth_cap is not None and config.max_depth > plan.depth_cap:
        return config.replace(max_depth=plan.depth_cap)
    return config


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
    if plan.kind == "clusters":
        return traversal.render_rows_clustered(
            scene, cap_depth(config, plan), plan.tri_ids, 0, config.height,
            tree=plan.tree)
    return _render_oracle(scene, config)


def render_and_grad(scene, loss_fn, config: RenderConfig | None = None,
                    plan: RenderPlan | None = None, **overrides):
    """Render and differentiate: returns ((loss, image), grads) where grads
    is a Scene of cotangents with None on integer leaves.

    `loss_fn(image) -> scalar` runs under autograd.  Gradients flow to every
    float leaf of the scene (vertices, normals, materials, lights, camera) at
    fixed hit topology; on a phase-1 plan the forward and the backward are
    each one kernel launch.  On a clusters plan the forward launches the
    traversal kernel and the backward is autograd through deferred shading;
    the gradients of the vertex table (positions, normals, uvs), of the
    material table and of the textures are each summed by the sorted
    segment-sum kernel (tpurt_torch.kernels.segsum), once a shaded depth."""
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
