"""Static render options, the counterpart of ``tpurt/core/types.py``, and
the device rule of the port's scene constructors."""
from __future__ import annotations

import dataclasses

import torch


def resolve_device(device=None) -> torch.device:
    """The device a scene constructor places its tensors on.  ``None`` means
    the card: the port runs on CUDA unless the caller asks for the CPU with
    ``device="cpu"``.  Where PyTorch sees no card, ``None`` or a CUDA device
    raises instead of quietly building on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} {'is the default' if device is None else 'requested'} "
            "but torch.cuda.is_available() is False; pass device=\"cpu\" to "
            "build on the CPU"
        )
    return dev


def tensors_to(obj, device):
    """Copy of dataclass `obj` with every tensor field (and every nested
    dataclass's) moved to `device`."""
    dev = resolve_device(device)
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.to(dev)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = tensors_to(v, dev)
    return dataclasses.replace(obj, **changes)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (hashable) render options; the fields of ``tpurt``'s
    ``RenderConfig``, so a config converts field by field.  Everything that
    changes the traced program lives here, everything that changes values
    lives in the Scene."""

    width: int = 256
    height: int = 256
    max_depth: int = 2        # Whitted bounces: 0 = primary rays only
    shadows: bool = True
    accel: str = "auto"       # "none" | "bvh" | "grid" | "auto"
    wavefront: bool = True    # clustered path: one re-binned launch per bounce
    shadow_rebin: bool = True  # clustered path: shadows over re-binned hit points
    backend: str = "auto"     # "oracle" | "pallas" | "auto"

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
