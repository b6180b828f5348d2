"""Carry a ``tpurt`` scene over to the port.

``scene_from_tpurt`` reads every leaf of any object with the attributes of
``tpurt.scene.Scene`` through ``np.asarray`` and builds the port's Scene, so
both packages render the same bytes.  ``leaves_as_numpy`` goes the other way
for comparisons: a flat dict of numpy arrays by field name.
``plan_from_tpurt`` carries a ``tpurt`` render plan over, so that both
packages trace the same cluster topology.  None of them imports JAX: the
object brings its arrays, and numpy reads them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpurt_torch.core.types import resolve_device
from tpurt_torch.scene.scene import Camera, Materials, Scene


def scene_from_tpurt(obj, device=None) -> Scene:
    """The port's Scene holding exactly the values of `obj`'s leaves."""
    dev = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.array(np.asarray(x))).to(dev)

    m, cam = obj.materials, obj.camera
    return Scene(
        vertices=t(obj.vertices),
        triangles=t(obj.triangles),
        tri_mat=t(obj.tri_mat),
        vnormals=t(obj.vnormals),
        uvs=t(obj.uvs),
        sph_center=t(obj.sph_center),
        sph_radius=t(obj.sph_radius),
        sph_mat=t(obj.sph_mat),
        materials=Materials(
            ka=t(m.ka), kd=t(m.kd), ks=t(m.ks), shininess=t(m.shininess),
            reflectivity=t(m.reflectivity), texture_id=t(m.texture_id),
        ),
        textures=t(obj.textures),
        light_pos=t(obj.light_pos),
        light_color=t(obj.light_color),
        ambient=t(obj.ambient),
        camera=Camera(eye=t(cam.eye), look_at=t(cam.look_at), up=t(cam.up),
                      fov_y=t(cam.fov_y)),
        smooth=bool(obj.smooth),
        textured=bool(obj.textured),
        n_real_spheres=int(obj.n_real_spheres),
    )


def leaves_as_numpy(scene_or_grads) -> dict:
    """{"vertices": array, ..., "materials.kd": array, "camera.eye": array}
    for every tensor leaf of a Scene (or of a Scene of gradients, whose None
    leaves are left out), nested dataclasses flattened with a dot."""
    out = {}
    for f in dataclasses.fields(scene_or_grads):
        v = getattr(scene_or_grads, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu().numpy()
        elif dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": a for k, a in leaves_as_numpy(v).items()})
    return out


def plan_from_tpurt(plan, scene: Scene):
    """The port's RenderPlan for a ``tpurt`` RenderPlan: the same kind, depth
    cap and (as numpy) cluster topology ``tri_ids``, on `scene`'s device.
    The upper level over the clusters, which ``tpurt`` does not have, is
    built from `scene`'s geometry."""
    from tpurt_torch.kernels.packc import tree_for
    from tpurt_torch.render import RenderPlan

    if plan.kind != "clusters":
        return RenderPlan(kind=plan.kind)
    tri_ids = torch.from_numpy(np.array(np.asarray(plan.tri_ids), np.int32)).to(
        scene.vertices.device)
    return RenderPlan(kind="clusters", tri_ids=tri_ids, depth_cap=plan.depth_cap,
                      tree=tree_for(scene, tri_ids))
