"""Entry points of the port (``__graft_entry__.py``): a forward render on the
main path's scene, and one full train step over a mesh of ranks."""
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
    """One train step a path over the mesh; raises on a non-finite loss."""
    from tpurt_torch.dist.train import make_train_step
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
    bad = {k: v for k, v in losses.items() if not math.isfinite(v)}
    if bad:
        raise RuntimeError(f"non-finite loss on rank {mesh.rank}: {bad}")
    return losses


def dryrun_multichip(n_devices: int, backend: str, device: str = "cuda") -> dict:
    """Run ONE full train step over `n_devices` spawned ranks on two paths:
    config 3 at (2n)x32 with max_depth=1 (phase-1 plan), and config 4 at
    (4n)x32 with subdiv=2 through prepare(accel="bvh") (clusters plan).
    Image rows split over the ranks, scene replicated, gradients summed in
    rank order.  Returns rank 0's losses by path; raises if a rank fails or a
    loss is not finite.  ``__graft_entry__``'s third path, the sharded scene
    and its ring, waits for the port of Distribution B (ROADMAP.md, Queue 1
    item 2)."""
    from tpurt_torch.dist.launch import spawn_ranks

    results = spawn_ranks(_dryrun_rank, n_devices, backend, n_devices, device=device)
    if any(r != results[0] for r in results):
        raise RuntimeError(f"the ranks' losses differ: {results}")
    return results[0]
