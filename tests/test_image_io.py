"""The stdlib PNG codec (io/image.py) against Pillow's."""

import io
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from snesimage.io import image as imio

H, W = 12, 16


def _pil_rgba(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"))


def _pil_png(im: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "PNG", **kw)
    return buf.getvalue()


def _images(rng):
    rgba = rng.integers(0, 256, (H, W, 4)).astype(np.uint8)
    gray = rng.integers(0, 256, (H, W)).astype(np.uint8)

    def palette_image(n):
        im = Image.fromarray(rng.integers(0, n, (H, W)).astype(np.uint8), "P")
        im.putpalette([int(v) for v in rng.integers(0, 256, n * 3)])
        return im

    p = palette_image(6)
    return {
        "1": (Image.fromarray(gray > 127).convert("1"), {}),
        "P2": (palette_image(2), {}),
        "P200": (palette_image(200), {}),
        "L": (Image.fromarray(gray, "L"), {}),
        "L+tRNS": (Image.fromarray(gray, "L"), {"transparency": int(gray[0, 0])}),
        "RGB": (Image.fromarray(rgba[..., :3], "RGB"), {}),
        "RGB+tRNS": (
            Image.fromarray(rgba[..., :3], "RGB"),
            {"transparency": tuple(int(v) for v in rgba[0, 0, :3])},
        ),
        "P": (p, {}),
        "P+tRNS": (p, {"transparency": bytes([0, 128, 255])}),
        "LA": (Image.fromarray(rgba[..., [0, 3]], "LA"), {}),
        "RGBA": (Image.fromarray(rgba, "RGBA"), {}),
    }


@pytest.mark.parametrize(
    "kind",
    ["1", "L", "L+tRNS", "RGB", "RGB+tRNS", "P", "P2", "P200", "P+tRNS", "LA",
     "RGBA"],
)
def test_decode_matches_pillow(rng, kind):
    im, kw = _images(rng)[kind]
    data = _pil_png(im, **kw)
    got = imio.decode_png(data)
    assert got is not None
    np.testing.assert_array_equal(got, _pil_rgba(data))


def _filter_rows(px: np.ndarray, ftype: int, bpp: int) -> bytes:
    """Reference PNG filter encoder, one filter type for every row."""
    h, stride = px.shape
    raw = bytearray()
    prior = [0] * stride
    for y in range(h):
        row = [int(v) for v in px[y]]
        out = []
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            if ftype == 0:
                pred = 0
            elif ftype == 1:
                pred = a
            elif ftype == 2:
                pred = b
            elif ftype == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out.append((x - pred) & 0xFF)
        raw.append(ftype)
        raw.extend(out)
        prior = row
    return bytes(raw)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [3, 4])
def test_decode_every_filter_type(rng, ftype, channels):
    img = rng.integers(0, 256, (H, W, channels)).astype(np.uint8)
    idat = zlib.compress(_filter_rows(img.reshape(H, -1), ftype, channels))
    ctype = 2 if channels == 3 else 6
    data = (imio.PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", idat[:10]) + _chunk(b"IDAT", idat[10:])
            + _chunk(b"IEND", b""))
    got = imio.decode_png(data)
    np.testing.assert_array_equal(got, _pil_rgba(data))
    np.testing.assert_array_equal(got[..., :channels], img)


@pytest.mark.parametrize("channels", [3, 4])
def test_encode_round_trips_through_pillow(rng, tmp_path, channels):
    img = rng.integers(0, 256, (H, W, channels)).astype(np.uint8)
    path = tmp_path / "x.png"
    (imio.save_rgb if channels == 3 else imio.save_rgba)(str(path), img)
    with Image.open(path) as im:
        assert im.mode == ("RGB" if channels == 3 else "RGBA")
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(imio.load_rgba(str(path))[..., :channels], img)


def test_other_formats_go_through_pillow(rng, tmp_path):
    """16-bit PNGs and non-PNG files take the Pillow path."""
    g16 = rng.integers(0, 65536, (H, W)).astype(np.uint16)
    data16 = _pil_png(Image.fromarray(g16))
    assert imio.decode_png(data16) is None
    p16 = tmp_path / "g16.png"
    p16.write_bytes(data16)
    np.testing.assert_array_equal(imio.load_rgba(str(p16)), _pil_rgba(data16))
    rgb = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    bmp = tmp_path / "x.bmp"
    Image.fromarray(rgb, "RGB").save(bmp)
    got = imio.load_rgba(str(bmp))
    np.testing.assert_array_equal(got[..., :3], rgb)
    assert (got[..., 3] == 255).all()


def test_missing_pillow_is_a_clear_error(rng, tmp_path, monkeypatch):
    bmp = tmp_path / "x.bmp"
    Image.fromarray(rng.integers(0, 256, (H, W, 3)).astype(np.uint8)).save(bmp)
    png = tmp_path / "x.png"
    imio.save_rgba(str(png), rng.integers(0, 256, (H, W, 4)).astype(np.uint8))
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert imio.load_rgba(str(png)).shape == (H, W, 4)  # PNG needs no Pillow
    with pytest.raises(ValueError, match="Pillow"):
        imio.load_rgba(str(bmp))
