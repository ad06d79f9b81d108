"""ctypes loader/builder for the native C++ oracle (native/oracle.cpp).

The oracle is a serial f64 implementation of the reference's per-pixel
scan semantics, used by tests to validate the batched JAX ops. It is
compiled on demand with g++ and cached next to the source by content hash.
"""

from __future__ import annotations

import ctypes
import hashlib
import pathlib
import subprocess

_REPO = pathlib.Path(__file__).resolve().parent.parent
_SRC = _REPO / "native" / "oracle.cpp"
_BUILD = _REPO / "native" / "build"

_lib = None


def _build_lib() -> pathlib.Path:
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = _BUILD / f"oracle-{tag}.so"
    if not out.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", str(out)],
            check=True,
            capture_output=True,
        )
    return out


def oracle():
    """Load (building if needed) the oracle shared library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build_lib()))
        lib.oracle_red_mean.restype = ctypes.c_double
        lib.oracle_red_mean.argtypes = [ctypes.c_int] * 6
        lib.oracle_ciede2000.restype = ctypes.c_double
        lib.oracle_ciede2000.argtypes = [ctypes.c_int] * 6
        lib.oracle_srgb_to_lab.restype = None
        lib.oracle_srgb_to_lab.argtypes = [
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.oracle_remap.restype = None
        lib.oracle_remap.argtypes = [
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.oracle_assign_tiles.restype = None
        lib.oracle_assign_tiles.argtypes = [
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.oracle_recalculate.restype = None
        lib.oracle_recalculate.argtypes = [
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
    return _lib


def oracle_remap(rgba, tile_palettes, palette5, dither: bool, perceptual: bool):
    """numpy-friendly wrapper around the full remap oracle."""
    import numpy as np

    rgba = np.ascontiguousarray(rgba, dtype=np.uint8)
    tp = np.ascontiguousarray(tile_palettes, dtype=np.int32)
    pal = np.ascontiguousarray(palette5, dtype=np.int32)
    h, w, _ = rgba.shape
    c, s, _ = pal.shape
    out = np.zeros((h, w), dtype=np.int32)
    lib = oracle()
    lib.oracle_remap(
        w,
        h,
        rgba.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        tp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pal.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        c,
        s,
        int(dither),
        int(perceptual),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


def oracle_assign_tiles(rgba, sub_count, sub_size, perceptual, nes):
    """Tile-assignment + flat-fill init oracle: returns (tile_palettes
    (ht, wt), palette5 (C, S, 3))."""
    import numpy as np

    rgba = np.ascontiguousarray(rgba, dtype=np.uint8)
    h, w, _ = rgba.shape
    tp = np.zeros((h // 8) * (w // 8), dtype=np.int32)
    pal = np.zeros(sub_count * sub_size * 3, dtype=np.int32)
    oracle().oracle_assign_tiles(
        w, h,
        rgba.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sub_count, sub_size, int(perceptual), int(nes),
        tp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pal.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return tp.reshape(h // 8, w // 8), pal.reshape(sub_count, sub_size, 3)


def oracle_recalculate(rgba, tile_palettes, sub_count, sub_size, perceptual, nes):
    """Per-subpalette pixel k-means oracle: returns palette5 (C, S, 3)."""
    import numpy as np

    rgba = np.ascontiguousarray(rgba, dtype=np.uint8)
    tp = np.ascontiguousarray(tile_palettes, dtype=np.int32)
    h, w, _ = rgba.shape
    pal = np.zeros(sub_count * sub_size * 3, dtype=np.int32)
    oracle().oracle_recalculate(
        w, h,
        rgba.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        tp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        sub_count, sub_size, int(perceptual), int(nes),
        pal.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return pal.reshape(sub_count, sub_size, 3)


def oracle_red_mean(c1, c2) -> float:
    return oracle().oracle_red_mean(*map(int, c1), *map(int, c2))


def oracle_ciede2000(c1, c2) -> float:
    return oracle().oracle_ciede2000(*map(int, c1), *map(int, c2))


def oracle_srgb_to_lab(c):
    out = (ctypes.c_double * 3)()
    oracle().oracle_srgb_to_lab(int(c[0]), int(c[1]), int(c[2]), out)
    return [out[0], out[1], out[2]]
