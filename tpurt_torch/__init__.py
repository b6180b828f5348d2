"""tpurt_torch — the PyTorch + CUDA port of tpurt, for NVIDIA Hopper.

It imports torch and numpy, never JAX and never ``tpurt``; each module
mirrors the ``tpurt`` module of the same path.  Public API:

    from tpurt_torch import render, render_and_grad, prepare, RenderConfig, build_scene
"""
from tpurt_torch.core.types import RenderConfig
from tpurt_torch.scene.scene import Camera, Materials, Scene, build_scene
# binds the functions, not the module
from tpurt_torch.render import prepare, render, render_and_grad

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Scene",
    "Camera",
    "Materials",
    "build_scene",
    "render",
    "render_and_grad",
    "prepare",
]
