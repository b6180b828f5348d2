"""The port's image and checkpoint I/O (tpurt_torch.utils): PNG written and
read with the standard library, read as Pillow reads tests/golden/*.png,
every scanline filter, the forms it refuses; a Scene checkpoint round trip,
a namedtuple's, and a spec that names a class outside the port."""
import collections
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from tpurt_torch.bridge import leaves_as_numpy
from tpurt_torch.scene import configs
from tpurt_torch.utils import checkpoint, load_png, load_pytree, save_png, save_pytree

import torch_one_thread  # noqa: F401  (one PyTorch thread)

GOLDEN = Path(__file__).resolve().parent / "golden"


def test_png_roundtrip(tmp_path):
    img = np.random.default_rng(0).uniform(size=(8, 10, 3)).astype(np.float32)
    path = str(tmp_path / "x.png")
    save_png(path, torch.from_numpy(img))
    back = load_png(path)
    assert back.shape == (8, 10, 3) and back.dtype == np.float32
    np.testing.assert_allclose(back, img, atol=0.5 / 255 + 1e-6)
    # the levels: round to nearest, as tpurt's writer does
    np.testing.assert_array_equal(load_png(path, np.uint8),
                                  (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), load_png(path, np.uint8))


@pytest.mark.parametrize("name", sorted(p.stem for p in GOLDEN.glob("*.png")))
def test_load_png_equals_pillow_on_the_goldens(name):
    path = GOLDEN / f"{name}.png"
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(load_png(path, np.uint8), want)
    np.testing.assert_array_equal(load_png(path), want.astype(np.float32) / 255.0)


def _png(rows, w, h, interlace=0, colour=2):
    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, interlace)
    data = zlib.compress(rows)
    # the data split over two IDAT chunks
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", data[:7])
            + chunk(b"IDAT", data[7:]) + chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered(img, kinds):
    """img (H, W, 3) uint8 encoded with scanline filter kinds[y] for row y
    (the PNG specification's filters, written byte by byte)."""
    h, w, _ = img.shape
    flat = img.reshape(h, w * 3).astype(int)
    out = bytearray()
    for y in range(h):
        out.append(kinds[y])
        for x in range(w * 3):
            a = flat[y, x - 3] if x >= 3 else 0
            b = flat[y - 1, x] if y else 0
            c = flat[y - 1, x - 3] if y and x >= 3 else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kinds[y]]
            out.append((flat[y, x] - pred) & 0xFF)
    return bytes(out)


def test_load_png_undoes_every_filter(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (10, 7, 3), dtype=np.uint8)
    path = tmp_path / "filters.png"
    path.write_bytes(_png(_filtered(img, [0, 1, 2, 3, 4, 4, 3, 2, 1, 0]), 7, 10))
    np.testing.assert_array_equal(load_png(path, np.uint8), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


# (bit depth, colour type, interlace) of each form: grey, RGB, palette (with
# tRNS, which Pillow drops), grey + alpha, RGBA, at each depth PNG allows,
# and Adam7 over three of them
FORMS = {"grey1": (1, 0, 0), "grey2": (2, 0, 0), "grey4": (4, 0, 0), "grey8": (8, 0, 0),
         "grey16": (16, 0, 0), "rgb16": (16, 2, 0), "palette1": (1, 3, 0),
         "palette2": (2, 3, 0), "palette4": (4, 3, 0), "palette8": (8, 3, 0),
         "grey_alpha8": (8, 4, 0), "grey_alpha16": (16, 4, 0), "rgba8": (8, 6, 0),
         "rgba16": (16, 6, 0), "adam7_rgb8": (8, 2, 1), "adam7_grey2": (2, 0, 1),
         "adam7_rgba16": (16, 6, 1)}
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _scanlines(s, depth):
    """Samples (h, w, ch) → unfiltered rows (h, stride) uint8."""
    h = s.shape[0]
    if depth == 16:
        return s.astype(">u2").reshape(h, -1).view(np.uint8)
    if depth == 8:
        return s.astype(np.uint8).reshape(h, -1)
    bits = (s.reshape(h, -1)[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def _filter_rows(rows, bpp, first_kind):
    """Rows filtered with the PNG specification's filters, row y with kind
    (first_kind + y) % 5, byte by byte."""
    out = bytearray()
    flat = rows.astype(int)
    for y in range(flat.shape[0]):
        kind = (first_kind + y) % 5
        out.append(kind)
        for x in range(flat.shape[1]):
            a = flat[y, x - bpp] if x >= bpp else 0
            b = flat[y - 1, x] if y else 0
            c = flat[y - 1, x - bpp] if y and x >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
            out.append((flat[y, x] - pred) & 0xFF)
    return bytes(out)


def _encode(samples, depth, colour, interlace, palette=None, trns=None):
    """A PNG file of samples (h, w, ch) in the given form."""
    h, w, ch = samples.shape
    bpp = max(1, depth * ch // 8)
    if interlace:
        passes = [samples[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7]
        raw = b"".join(_filter_rows(_scanlines(p, depth), bpp, k)
                       for k, p in enumerate(passes) if p.size)
    else:
        raw = _filter_rows(_scanlines(samples, depth), bpp, 0)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                                              0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    data = zlib.compress(raw)
    return (out + chunk(b"IDAT", data[:5]) + chunk(b"IDAT", data[5:])
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("form", sorted(FORMS))
def test_load_png_reads_every_form_as_pillow_does(tmp_path, form):
    """Each PNG form that tpurt's reader (Pillow's convert("RGB")) takes, on
    an image of 11x13 random samples, every filter at the form's byte step."""
    depth, colour, interlace = FORMS[form]
    rng = np.random.default_rng(sum(map(ord, form)))
    palette = trns = None
    if colour == 3:
        top = 1 << depth
        palette = rng.integers(0, 256, (min(top, 200), 3), dtype=np.uint8)
        samples = rng.integers(0, palette.shape[0], (11, 13, 1))
        trns = bytes(rng.integers(0, 256, 3, dtype=np.uint8))
    else:
        samples = rng.integers(0, 1 << depth, (11, 13, CHANNELS[colour]))
        if depth == 16:   # small values too: grey16 is clipped, the rest shifted
            samples[::3] %= 300
    path = tmp_path / f"{form}.png"
    path.write_bytes(_encode(samples, depth, colour, interlace, palette, trns))
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(load_png(path, np.uint8), want)
    np.testing.assert_array_equal(load_png(path), want.astype(np.float32) / 255.0)


@pytest.mark.parametrize("kwargs,message", [
    ({"interlace": 2}, "interlace method 2"),
    ({"colour": 5}, "colour type 5"),
])
def test_load_png_refuses_what_it_does_not_read(tmp_path, kwargs, message):
    img = np.zeros((2, 2, 3), np.uint8)
    path = tmp_path / "bad.png"
    path.write_bytes(_png(_filtered(img, [0, 0]), 2, 2, **kwargs))
    with pytest.raises(ValueError, match=message):
        load_png(path)


def test_load_png_refuses_a_bad_checksum(tmp_path):
    img = np.zeros((2, 2, 3), np.uint8)
    data = bytearray(_png(_filtered(img, [0, 0]), 2, 2))
    data[20] ^= 0xFF                        # a byte of the IHDR chunk's data
    path = tmp_path / "crc.png"
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="checksum"):
        load_png(path)


def test_checkpoint_roundtrip_scene(tmp_path):
    scene, _ = configs.config5_multimesh(8, 8, n_blobs=1, subdiv=0, device="cpu")
    path = str(tmp_path / "scene.npz")
    save_pytree(path, {"scene": scene, "step": 7, "lr": 0.5, "losses": [1.0, 0.5]})
    back = load_pytree(path, device="cpu")
    assert back["step"] == 7 and back["lr"] == 0.5 and back["losses"] == [1.0, 0.5]
    got, want = back["scene"], scene
    assert type(got) is type(want) and type(got.camera) is type(want.camera)
    assert (got.smooth, got.textured, got.n_real_spheres) == \
        (want.smooth, want.textured, want.n_real_spheres)
    a, b = leaves_as_numpy(got), leaves_as_numpy(want)
    assert a.keys() == b.keys()
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_checkpoint_refuses_a_class_outside_the_port(tmp_path):
    path = tmp_path / "bad.npz"
    spec = {"t": "dc", "cls": "tpurt.scene.scene:Camera", "fields": {}}
    np.savez(path, __spec__=np.frombuffer(json.dumps(spec).encode(), np.uint8))
    with pytest.raises(ValueError, match="outside tpurt_torch"):
        load_pytree(path, device="cpu")
    # a module whose name only starts like the port's
    spec["cls"] = "tpurt_torchx:Scene"
    np.savez(path, __spec__=np.frombuffer(json.dumps(spec).encode(), np.uint8))
    with pytest.raises(ValueError, match="outside tpurt_torch"):
        load_pytree(path, device="cpu")


#: a namedtuple of this test module, which the port's loader takes only while
#: the allowed package is patched to this module's
State = collections.namedtuple("State", ["params", "step"])


def test_checkpoint_roundtrip_namedtuple(tmp_path, monkeypatch):
    monkeypatch.setattr(checkpoint, "_ALLOWED_PACKAGE", State.__module__.split(".")[0])
    params = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    path = str(tmp_path / "state.npz")
    save_pytree(path, {"state": State(params, 3), "pair": (1, 2.5)})
    back = load_pytree(path, device="cpu")
    got = back["state"]
    assert type(got) is State and got.step == 3 and got._fields == State._fields
    assert torch.equal(got.params, params)
    assert type(back["pair"]) is tuple and back["pair"] == (1, 2.5)


def test_checkpoint_refuses_a_namedtuple_outside_the_port(tmp_path):
    path = str(tmp_path / "state.npz")
    save_pytree(path, {"state": State(torch.zeros(2), 1)})
    with pytest.raises(ValueError, match="State.*outside tpurt_torch"):
        load_pytree(path, device="cpu")
