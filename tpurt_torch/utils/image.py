"""Image I/O, the counterpart of ``tpurt/utils/image.py``, with the standard
library only (``zlib``, ``struct``): the card's machine has no Pillow.

``save_png`` writes 8-bit RGB, non-interlaced; ``load_png`` reads every PNG
that ``tpurt``'s reader (Pillow's ``convert("RGB")``) reads, as it reads it,
and raises on a bad signature or checksum and on what is not a PNG form.
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


#: colour type → (the bit depths PNG allows, samples a pixel)
_FORMS = {0: ((1, 2, 4, 8, 16), 1), 2: ((8, 16), 3), 3: ((1, 2, 4, 8), 1),
          4: ((8, 16), 2), 6: ((8, 16), 4)}
#: Adam7's seven passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the scanline filters of h rows of `stride` bytes, `bpp` bytes a
    pixel (1 below 8 bits a pixel) → (h, stride) uint8."""
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected {h * (stride + 1)}")
    lines = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, cur = int(lines[y, 0]), lines[y, 1:].astype(np.int32)
        if kind == 0:
            row = cur
        elif kind == 1:      # Sub: add the byte bpp to the left, a running sum per channel
            row = np.cumsum(cur.reshape(-1, bpp), 0).reshape(-1) & 0xFF
        elif kind == 2:      # Up
            row = (cur + prev) & 0xFF
        elif kind in (3, 4):  # Average, Paeth: each byte needs its left neighbour
            up, cur_l, row_l = prev.tolist(), cur.tolist(), [0] * stride
            for x in range(stride):
                a = row_l[x - bpp] if x >= bpp else 0
                b = up[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                row_l[x] = (cur_l[x] + pred) & 0xFF
            row = np.asarray(row_l, np.int32)
        else:
            raise ValueError(f"PNG scanline {y} has filter type {kind}: only 0-4 exist")
        out[y] = row
        prev = row
    return out


def _samples(rows: np.ndarray, w: int, depth: int, channels: int) -> np.ndarray:
    """Unfiltered rows (h, stride) → samples (h, w, channels) as int32."""
    h, n = rows.shape[0], w * channels
    if depth == 16:
        vals = rows[:, :2 * n].astype(np.int32)
        vals = (vals[:, 0::2] << 8) | vals[:, 1::2]
    elif depth == 8:
        vals = rows[:, :n].astype(np.int32)
    else:   # 1, 2 or 4 bits, the leftmost sample in the high bits
        bits = np.unpackbits(rows, axis=1)[:, :n * depth].reshape(h, n, depth)
        vals = (bits.astype(np.int32) << np.arange(depth - 1, -1, -1)).sum(-1)
    return vals.reshape(h, w, channels)


def _decode(raw: bytes, w: int, h: int, depth: int, channels: int, interlace: int):
    """The samples (h, w, channels) int32 of a zlib-inflated image stream:
    one pass, or Adam7's seven."""
    bits = depth * channels
    bpp = max(1, bits // 8)

    def stride(width):
        return (width * bits + 7) // 8

    if interlace == 0:
        return _samples(_unfilter(raw, h, stride(w), bpp), w, depth, channels)
    out = np.zeros((h, w, channels), np.int32)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = -(-max(w - x0, 0) // dx), -(-max(h - y0, 0) // dy)
        if pw == 0 or ph == 0:
            continue                 # an empty pass has no scanlines
        n = ph * (stride(pw) + 1)
        rows = _unfilter(raw[pos:pos + n], ph, stride(pw), bpp)
        out[y0::dy, x0::dx] = _samples(rows, pw, depth, channels)
        pos += n
    if pos != len(raw):
        raise ValueError(f"PNG data holds {len(raw)} bytes, the passes {pos}")
    return out


def _to_rgb8(vals, depth: int, colour: int, palette) -> np.ndarray:
    """Samples → (H, W, 3) uint8, as Pillow's ``convert("RGB")`` makes them:
    alpha dropped; grey below 8 bits scaled to 0-255; 16-bit grey clipped at
    255 (Pillow's I;16 → RGB); every other 16-bit sample its high byte; a
    palette index looked up."""
    if colour == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        if int(vals.max(initial=0)) >= palette.shape[0]:
            raise ValueError(f"palette index {int(vals.max())} past the "
                             f"{palette.shape[0]} entries of PLTE")
        return palette[vals[..., 0]]
    if colour == 0 and depth < 8:
        vals = vals * (255 // ((1 << depth) - 1))
    elif colour == 0 and depth == 16:
        vals = np.minimum(vals, 255)
    elif depth == 16:
        vals = vals >> 8
    rgb = vals[..., :1].repeat(3, -1) if colour in (0, 4) else vals[..., :3]
    return rgb.astype(np.uint8)


def load_png(path, dtype=np.float32):
    """PNG file → (H, W, 3) float in [0, 1] (or uint8 if dtype=np.uint8), as
    a numpy array, equal to Pillow's ``Image.open(path).convert("RGB")``:
    every colour type (grey, RGB, palette, grey + alpha, RGBA; alpha and
    tRNS dropped), every bit depth PNG allows (1, 2, 4, 8 and 16), Adam7
    interlacing, the five scanline filters, IDAT split over chunks."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat, palette = len(_SIGNATURE), None, [], None
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
        elif kind == b"PLTE":
            if n % 3:
                raise ValueError(f"{path}: PLTE of {n} bytes, not whole RGB entries")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, compression, filtering, interlace = header
    if colour not in _FORMS or depth not in _FORMS[colour][0]:
        raise ValueError(f"{path}: bit depth {depth} with colour type {colour} is not a "
                         "PNG form")
    if (compression, filtering) != (0, 0):
        raise ValueError(f"{path}: compression method {compression}, filter method "
                         f"{filtering}: only 0 and 0 exist")
    if interlace not in (0, 1):
        raise ValueError(f"{path}: interlace method {interlace}: only 0 (none) and 1 "
                         "(Adam7) exist")
    vals = _decode(zlib.decompress(b"".join(idat)), w, h, depth, _FORMS[colour][1],
                   interlace)
    arr = _to_rgb8(vals, depth, colour, palette)
    if dtype == np.uint8:
        return arr
    return arr.astype(dtype) / 255.0
