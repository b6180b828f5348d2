"""Image I/O, the counterpart of ``tpurt/utils/image.py``, with the standard
library only (``zlib``, ``struct``): the card's machine has no Pillow.

``save_png`` writes 8-bit RGB, non-interlaced; ``load_png`` reads that form
(any of the five scanline filters, any split into IDAT chunks) and raises on
every other: another bit depth or colour type, an interlaced file, a bad
signature or checksum.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_png(path, image):
    """(H, W, 3) float in [0, 1] or uint8 (numpy or a tensor on any device)
    → 8-bit RGB PNG file.  Floats are clipped and rounded to the nearest
    level, as ``tpurt``'s writer does."""
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"image of shape {arr.shape}: expected (H, W, 3)")
    h, w, _ = arr.shape
    # every scanline with filter type 0 (none)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)], 1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))
    return path


def _unfilter(raw: bytes, h: int, w: int) -> np.ndarray:
    """Undo the scanline filters of 8-bit RGB rows (3 bytes a pixel)."""
    stride = w * 3
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected {h * (stride + 1)}")
    lines = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, cur = int(lines[y, 0]), lines[y, 1:].astype(np.int32)
        if kind == 0:
            row = cur
        elif kind == 1:      # Sub: add the byte 3 to the left, a running sum per channel
            row = np.cumsum(cur.reshape(w, 3), 0).reshape(-1) & 0xFF
        elif kind == 2:      # Up
            row = (cur + prev) & 0xFF
        elif kind in (3, 4):  # Average, Paeth: each byte needs its left neighbour
            up, cur_l, row_l = prev.tolist(), cur.tolist(), [0] * stride
            for x in range(stride):
                a = row_l[x - 3] if x >= 3 else 0
                b = up[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - 3] if x >= 3 else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                row_l[x] = (cur_l[x] + pred) & 0xFF
            row = np.asarray(row_l, np.int32)
        else:
            raise ValueError(f"PNG scanline {y} has filter type {kind}: only 0-4 exist")
        out[y] = row
        prev = row
    return out.reshape(h, w, 3)


def load_png(path, dtype=np.float32):
    """8-bit RGB PNG file → (H, W, 3) float in [0, 1] (or uint8 if
    dtype=np.uint8), as a numpy array."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(_SIGNATURE), None, []
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated before IEND")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"{path}: bad checksum on the {kind!r} chunk")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, compression, filtering, interlace = header
    if (depth, colour, compression, filtering) != (8, 2, 0, 0):
        raise ValueError(f"{path}: bit depth {depth}, colour type {colour}, compression "
                         f"{compression}, filter method {filtering}: only 8-bit RGB "
                         "(8, 2, 0, 0) is read")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not read")
    arr = _unfilter(zlib.decompress(b"".join(idat)), h, w)
    if dtype == np.uint8:
        return arr
    return arr.astype(dtype) / 255.0
