"""Utilities of the port: image and checkpoint I/O (``tpurt/utils``) and the
H100 roofline model."""
from tpurt_torch.utils.checkpoint import load_pytree, save_pytree
from tpurt_torch.utils.image import load_png, save_png

__all__ = ["load_png", "save_png", "load_pytree", "save_pytree"]
