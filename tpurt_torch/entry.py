"""Entry points of the port (``__graft_entry__.py``): a forward render on the
main path's scene, and one full train step a path over a mesh of ranks."""
from __future__ import annotations

import math

import torch


def entry(device: str = "cuda"):
    """(fn, example_args): the forward render of config 3 (spheres with
    depth-2 Whitted reflections and shadows) at 256x256 on `device`."""
    from tpurt_torch.render import render
    from tpurt_torch.scene import configs

    scene, cfg = configs.config3_spheres(256, 256, device=device)

    def forward(s):
        return render(s, cfg)

    return forward, (scene,)


def _dryrun_rank(mesh, n: int) -> dict:
    """One train step a path over the mesh; raises on a non-finite loss or
    when the ring's image differs from the replicated render."""
    from tpurt_torch.dist.scene_shard import prepare_scene_sharded, render_scene_sharded_prepared
    from tpurt_torch.dist.train import make_ring_train_step, make_train_step
    from tpurt_torch.kernels import traversal as TV
    from tpurt_torch.render import prepare
    from tpurt_torch.scene import configs

    dev = mesh.device
    losses = {}
    # phase-1: every rank runs the forward and replay backward kernels on its rows
    rows = 2 * n
    scene, cfg = configs.config3_spheres(rows, 32, device=dev)
    cfg = cfg.replace(max_depth=1)
    step = make_train_step(cfg, mesh=mesh, plan=prepare(scene, cfg))
    _, loss = step(scene, torch.zeros((rows, 32, 3), device=dev), 1e-3)
    losses["phase1"] = float(loss)
    # clustered: the traversal kernel, deferred shading and the segment sum
    rows_c = 4 * n
    scene_c, cfg_c = configs.config4_bunny(rows_c, 32, subdiv=2, device=dev)
    cfg_c = cfg_c.replace(max_depth=1)
    plan = prepare(scene_c, cfg_c, accel="bvh")
    if plan.kind != "clusters":
        raise RuntimeError(f"accel='bvh' planned {plan.kind}")
    step_c = make_train_step(cfg_c, mesh=mesh, plan=plan)
    _, loss_c = step_c(scene_c, torch.zeros((rows_c, 32, 3), device=dev), 1e-4)
    losses["clusters"] = float(loss_c)
    # the sharded scene and its ring, with shadows and one bounce: the image
    # equals the replicated render of the renumbered scene bit for bit, with
    # that render's occlusion from the any-hit mode at the kernel's hit
    # points, as the ring computes it (the default in-kernel shadows may
    # differ in the last bit on the card)
    cfg_r = cfg_c.replace(max_depth=1, shadows=True)
    scene_r, parts = prepare_scene_sharded(scene_c, plan.tri_ids, mesh.size)
    img_ring = render_scene_sharded_prepared(scene_r, cfg_r, parts, mesh)
    gate = TV.SHADOW_REBIN_MIN_CLUSTERS
    TV.SHADOW_REBIN_MIN_CLUSTERS = 0
    try:
        img_ref = TV.render_rows_clustered(scene_r, cfg_r, parts.tri_ids.to(dev), 0, rows_c)
    finally:
        TV.SHADOW_REBIN_MIN_CLUSTERS = gate
    if not torch.equal(img_ring, img_ref):
        raise RuntimeError(f"rank {mesh.rank}: the ring's image differs from the replicated "
                           f"render by {float((img_ring - img_ref).abs().max())}")
    step_r = make_ring_train_step(cfg_r, mesh, parts)
    _, loss_r = step_r(scene_r, torch.zeros((rows_c, 32, 3), device=dev), 1e-4)
    losses["ring"] = float(loss_r)
    bad = {k: v for k, v in losses.items() if not math.isfinite(v)}
    if bad:
        raise RuntimeError(f"non-finite loss on rank {mesh.rank}: {bad}")
    return losses


def dryrun_multichip(n_devices: int, backend: str, device: str = "cuda") -> dict:
    """Run ONE full train step over `n_devices` spawned ranks on three paths:
    config 3 at (2n)x32 with max_depth=1 (phase-1 plan), and config 4 at
    (4n)x32 with subdiv=2 through prepare(accel="bvh") (clusters plan), image
    rows split over the ranks and the scene replicated; then the same config
    4 with shadows and one bounce on the sharded scene's ring, whose image
    must equal the replicated render of the renumbered scene bit for bit,
    with that render's shadows from the traversal kernel's any-hit mode as
    the ring takes them (``tpurt`` asserts 1e-5).  Gradients are summed in
    rank order.  Returns rank 0's losses by path; raises if a rank fails or
    a loss is not finite."""
    from tpurt_torch.dist.launch import spawn_ranks

    results = spawn_ranks(_dryrun_rank, n_devices, backend, n_devices, device=device)
    if any(r != results[0] for r in results):
        raise RuntimeError(f"the ranks' losses differ: {results}")
    return results[0]
