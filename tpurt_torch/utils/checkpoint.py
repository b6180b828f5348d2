"""Checkpoints of scenes and optimisation state, the counterpart of
``tpurt/utils/checkpoint.py``'s npz format: the tensors as arrays of one npz
file plus a JSON spec of the structure (node kinds, class names, field
names).  No pickle: loading a file builds nothing but the port's own
dataclasses and namedtuples (from modules under ``tpurt_torch.``), tuples,
lists, dicts and Python scalars, and tensors from the arrays.

One difference from ``tpurt``'s ``load_pytree(path, like=None)``: the second
argument here is ``device``, where the tensors land (the card unless
``device="cpu"``).  ``tpurt``'s ``like`` is an example pytree that only its
orbax directories need; the port writes npz files only, whose spec already
holds the structure.
"""
from __future__ import annotations

import dataclasses
import importlib
import json

import numpy as np
import torch

from tpurt_torch.core.types import resolve_device

#: the one package whose dataclasses a spec may name
_ALLOWED_PACKAGE = "tpurt_torch"


def _to_spec(x, leaves: list):
    """Structure → JSON-able spec; tensors and arrays appended to `leaves`."""
    if x is None:
        return {"t": "none"}
    if isinstance(x, (bool, int, float, str)):
        return {"t": "py", "v": x}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        cls = type(x)
        return {"t": "dc", "cls": f"{cls.__module__}:{cls.__qualname__}",
                "fields": {f.name: _to_spec(getattr(x, f.name), leaves)
                           for f in dataclasses.fields(x)}}
    if isinstance(x, tuple) and hasattr(x, "_fields"):  # a namedtuple
        cls = type(x)
        return {"t": "nt", "cls": f"{cls.__module__}:{cls.__qualname__}",
                "items": [_to_spec(v, leaves) for v in x]}
    if isinstance(x, tuple):
        return {"t": "tuple", "items": [_to_spec(v, leaves) for v in x]}
    if isinstance(x, list):
        return {"t": "list", "items": [_to_spec(v, leaves) for v in x]}
    if isinstance(x, dict):
        items = sorted(x.items(), key=lambda kv: str(kv[0]))
        return {"t": "dict",
                "keys": [["i" if isinstance(k, int) else "s", str(k)] for k, _ in items],
                "items": [_to_spec(v, leaves) for _, v in items]}
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    leaves.append(np.asarray(x))
    return {"t": "leaf", "i": len(leaves) - 1}


def _is_namedtuple(obj) -> bool:
    return isinstance(obj, type) and issubclass(obj, tuple) and hasattr(obj, "_fields")


def _resolve_class(ref: str, kind: str):
    """The class `ref` ("module:qualname") names, from under
    ``tpurt_torch.`` only; `kind` is "dc" (a dataclass) or "nt" (a
    namedtuple)."""
    mod_name, qual = ref.split(":")
    if not (mod_name == _ALLOWED_PACKAGE or mod_name.startswith(_ALLOWED_PACKAGE + ".")):
        raise ValueError(f"checkpoint names class {ref!r} from outside {_ALLOWED_PACKAGE}.")
    obj = importlib.import_module(mod_name)
    for part in qual.split("."):
        obj = getattr(obj, part)
    if kind == "nt" and not _is_namedtuple(obj):
        raise ValueError(f"checkpoint names {ref!r}, which is not a namedtuple")
    if kind == "dc" and not (isinstance(obj, type) and dataclasses.is_dataclass(obj)):
        raise ValueError(f"checkpoint names {ref!r}, which is not a dataclass")
    return obj


def _from_spec(spec, leaves, device):
    t = spec["t"]
    if t == "none":
        return None
    if t == "py":
        return spec["v"]
    if t == "leaf":
        return torch.from_numpy(leaves[spec["i"]]).to(device)
    if t == "tuple":
        return tuple(_from_spec(s, leaves, device) for s in spec["items"])
    if t == "list":
        return [_from_spec(s, leaves, device) for s in spec["items"]]
    if t == "dict":
        keys = [int(k) if kind == "i" else k for kind, k in spec["keys"]]
        return {k: _from_spec(s, leaves, device) for k, s in zip(keys, spec["items"])}
    if t == "dc":
        cls = _resolve_class(spec["cls"], t)
        return cls(**{k: _from_spec(s, leaves, device) for k, s in spec["fields"].items()})
    if t == "nt":
        cls = _resolve_class(spec["cls"], t)
        return cls(*[_from_spec(s, leaves, device) for s in spec["items"]])
    raise ValueError(f"unknown spec node {t!r}")


def save_pytree(path, tree):
    """Save a structure of dataclasses, namedtuples, tuples, lists, dicts,
    scalars and tensors (a Scene, a Scene of gradients) as one npz file."""
    leaves: list = []
    spec = _to_spec(tree, leaves)
    spec_arr = np.frombuffer(json.dumps(spec).encode("utf-8"), np.uint8).copy()
    with open(path, "wb") as f:
        np.savez(f, __spec__=spec_arr, **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    return path


def load_pytree(path, device=None):
    """Load what save_pytree saved, every array leaf a tensor on `device`
    (the card unless ``device="cpu"``).  A dataclass or namedtuple comes back
    as its class; a spec that names a class from outside ``tpurt_torch.``
    raises.  (``tpurt``'s second argument is ``like``, an example pytree for
    its orbax directories; see the module docstring.)"""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        spec = json.loads(bytes(z["__spec__"].tobytes()).decode("utf-8"))
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]
    return _from_spec(spec, leaves, dev)
