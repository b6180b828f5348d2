"""Parity-critical rendering constants of the PyTorch port.

A copy of ``tpurt/constants.py``: that module imports ``jax.numpy``, and so
does every ``tpurt`` module through ``tpurt/__init__.py``, so the port cannot
import it on a machine without JAX.  ``tests/test_torch_scene.py`` holds every
name here equal to its ``tpurt.constants`` counterpart; change both together.
The conventions (camera, Phong shading, Whitted recursion, misses) are
documented there.
"""
import torch

# -- ray epsilons ------------------------------------------------------------
#: Minimum parametric distance for a primary/secondary ray hit to count.
T_MIN = 1e-4
#: Maximum parametric distance (effectively infinity).
T_MAX = 1e30
#: Sentinel "no hit" distance (compared against T_MAX to detect misses).
T_NONE = 1e30
#: Offset along the surface normal applied to shadow/secondary ray origins.
RAY_OFFSET_EPS = 1e-3
#: Determinant cutoff below which a triangle is treated as parallel to the ray.
MT_DET_EPS = 1e-9
#: Guard added to squared-length terms before rsqrt in normalize().
NORMALIZE_EPS = 1e-20

# -- shading -----------------------------------------------------------------
#: RGB returned for rays that escape the scene.
BACKGROUND = (0.05, 0.07, 0.10)
#: Scene-wide ambient light colour multiplying material ambient (ka).
AMBIENT_LIGHT = (1.0, 1.0, 1.0)
#: Clamp bounds for the final image.
CLAMP_LO = 0.0
CLAMP_HI = 1.0

# -- defaults ----------------------------------------------------------------
#: Default Whitted bounce depth (2 = primary + two reflection bounces).
DEFAULT_MAX_DEPTH = 2
#: Compute dtype for all geometry/shading math.
DTYPE = torch.float32
INDEX_DTYPE = torch.int32
