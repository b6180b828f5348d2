"""Vector math over trailing-axis-3 tensors (``tpurt/core/vec.py``)."""
from __future__ import annotations

import torch

from tpurt_torch import constants as C


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing axis, keepdims=False."""
    return (a * b).sum(-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the trailing axis."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def norm2(a: torch.Tensor) -> torch.Tensor:
    return (a * a).sum(-1)


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(norm2(a))


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Unit vector; guarded by NORMALIZE_EPS so zero vectors stay finite and
    the gradient through rsqrt never produces inf/nan."""
    return a * torch.rsqrt(norm2(a) + C.NORMALIZE_EPS)[..., None]


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Reflect direction ``d`` about unit normal ``n``: r = d - 2 (d·n) n."""
    return d - 2.0 * dot(d, n)[..., None] * n
