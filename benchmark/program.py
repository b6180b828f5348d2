"""The system under test, seen from the benchmark: the PyTorch and CUDA
port's public entry points, fed the benchmark's own arrays.  Nothing else
of the program is used; ``check.py`` judges what these calls return."""
from __future__ import annotations

import dataclasses

import torch

# prepare, render and make_train_step are the calls the harness times
from tpurt_torch import RenderConfig, build_scene, prepare, render  # noqa: F401
from tpurt_torch.dist.train import make_train_step  # noqa: F401
from tpurt_torch.scene.scene import Camera


def render_config(cfg: dict) -> RenderConfig:
    h, w = (int(x) for x in cfg["resolution"].split("x"))
    return RenderConfig(height=h, width=w, max_depth=cfg["max_depth"], shadows=cfg["shadows"])


def scene_from_arrays(arrays: dict, device):
    """The program's Scene of the benchmark's arrays, through its public
    ``build_scene``."""
    cam = arrays["camera"]
    return build_scene(
        vertices=arrays["vertices"], triangles=arrays["triangles"], tri_mat=arrays["tri_mat"],
        vnormals=arrays["vnormals"], uvs=arrays["uvs"], spheres=arrays["spheres"],
        materials=[dict(m) for m in arrays["materials"]], textures=arrays["textures"],
        lights=arrays["lights"], ambient=arrays["ambient"],
        camera=Camera.make(cam["eye"], cam["look_at"], cam["up"], cam["fov_y"], device=device),
        smooth=arrays["smooth"], device=device)


def with_eye(scene, eye):
    """The scene seen from `eye` (a (3,) tensor on the scene's device)."""
    cam = dataclasses.replace(scene.camera, eye=eye)
    return dataclasses.replace(scene, camera=cam)


def with_start(scene, start: dict):
    """The scene with a start's light colours and albedos."""
    dev = scene.vertices.device
    mats = dataclasses.replace(scene.materials, kd=torch.as_tensor(start["kd"], device=dev))
    return dataclasses.replace(scene, light_color=torch.as_tensor(start["light_color"], device=dev),
                               materials=mats)


def float_leaves(scene) -> dict:
    """Every float tensor of a Scene by dotted path ("materials.kd")."""
    out = {}
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            out[f.name] = v
        elif dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": t for k, t in float_leaves(v).items()})
    return out

