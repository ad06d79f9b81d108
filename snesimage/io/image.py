"""Image loading (any format -> RGBA8), replacing the reference's
`image::open(..).into_rgba8()` (src/lib.rs:836).

PNG, the format of the CLI's main path, is read and written here with the
standard library (non-interlaced; colour types 0, 2, 3, 4 and 6 at 8 bits
per sample, types 0 and 3 also at 1, 2 and 4; tRNS transparency). Other
formats and PNG variants go through Pillow, imported only when such a
file is met.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# Colour type -> samples per pixel.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _pillow():
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            "this image format needs Pillow, which is not installed; "
            "convert the image to an 8-bit non-interlaced PNG"
        ) from None
    return Image


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG has no IEND chunk")


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (types 0-4) -> (h, stride) uint8."""
    if len(raw) < h * (stride + 1):
        raise ValueError("truncated PNG image data")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum per byte lane, mod 256
            cur = line.reshape(-1, bpp).cumsum(axis=0).reshape(-1) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prior) & 0xFF
        elif ftype in (3, 4):  # Average / Paeth: serial within the row
            cur_l = line.tolist()
            up = prior.tolist()
            for i in range(stride):
                a = cur_l[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur_l[i] = (cur_l[i] + pred) & 0xFF
            cur = np.asarray(cur_l, np.int32)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prior = cur
    return out


def decode_png(data: bytes) -> np.ndarray | None:
    """Decode PNG bytes to (H, W, 4) uint8 RGBA, or None for a variant
    this reader does not handle (16-bit samples, interlacing)."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    ihdr = None
    plte = trns = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    low = depth in (1, 2, 4) and ctype in (0, 3)
    if interlace or ctype not in _CHANNELS or not (depth == 8 or low):
        return None
    ch = _CHANNELS[ctype]
    stride = (w * ch * depth + 7) // 8
    raw = zlib.decompress(b"".join(idat))
    px = _unfilter(raw, h, stride, max(1, ch * depth // 8))
    if low:  # unpack the samples of each byte, most significant first
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        px = (px[:, :, None] >> shifts) & ((1 << depth) - 1)
        px = px.reshape(h, -1)[:, :w, None].astype(np.uint8)
    else:
        px = px.reshape(h, w, ch)
    rgba = np.empty((h, w, 4), np.uint8)
    rgba[..., 3] = 255
    if ctype == 3:
        if plte is None:
            raise ValueError("palette PNG has no PLTE chunk")
        idx = px[..., 0]
        if idx.max(initial=0) >= len(plte):
            raise ValueError("PNG palette index out of range")
        rgba[..., :3] = plte[idx]
        if trns is not None:
            alpha = np.full(len(plte), 255, np.uint8)
            t = np.frombuffer(trns, np.uint8)[: len(plte)]
            alpha[: len(t)] = t
            rgba[..., 3] = alpha[idx]
    elif ctype in (0, 4):
        rgba[..., :3] = px[..., :1] * np.uint8(255 // ((1 << depth) - 1))
        if ctype == 4:
            rgba[..., 3] = px[..., 1]
        elif trns is not None:
            (key,) = struct.unpack(">H", trns[:2])
            rgba[..., 3] = np.where(px[..., 0] == key, 0, 255)
    else:
        rgba[..., :3] = px[..., :3]
        if ctype == 6:
            rgba[..., 3] = px[..., 3]
        elif trns is not None:
            key = np.asarray(struct.unpack(">HHH", trns[:6]))
            rgba[..., 3] = np.where((px == key).all(axis=-1), 0, 255)
    return rgba


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3|4) uint8 -> PNG bytes (colour type 2 or 6, filter 0)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, ch = img.shape
    if ch not in (3, 4):
        raise ValueError(f"expected 3 or 4 channels, got {ch}")
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * ch)], axis=1
    )

    def chunk(kind: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if ch == 3 else 6, 0, 0, 0)
    return (
        PNG_SIGNATURE
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + chunk(b"IEND", b"")
    )


def load_rgba(path: str) -> np.ndarray:
    """Decode an image file to (H, W, 4) uint8 RGBA."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        rgba = decode_png(data)
        if rgba is not None:
            return rgba
    with _pillow().open(path) as im:
        return np.asarray(im.convert("RGBA"), dtype=np.uint8)


def check_size(img: np.ndarray, width: int, height: int) -> None:
    """Strict size check. The reference's check is buggy (`&&` instead of
    `||`, src/lib.rs:838: a 256x512 image passes and then corrupts tile
    indexing via the hardcoded 32-tile stride at src/lib.rs:58,565). We
    enforce the intended contract instead."""
    h, w = img.shape[:2]
    if (w, h) != (width, height):
        raise ValueError(f"Image size must be {width}x{height}, got {w}x{h}")


def _save(path: str, img: np.ndarray, mode: str) -> None:
    img = np.asarray(img, dtype=np.uint8)
    if str(path).lower().endswith(".png"):
        with open(path, "wb") as f:
            f.write(encode_png(img))
        return
    _pillow().fromarray(img, mode).save(path)


def save_rgba(path: str, img: np.ndarray) -> None:
    _save(path, img, "RGBA")


def save_rgb(path: str, img: np.ndarray) -> None:
    _save(path, img, "RGB")
