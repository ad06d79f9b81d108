"""Floyd-Steinberg error-diffusion remap as a wavefront scan.

The reference's `optimize` (src/lib.rs:425-501) is a serial raster scan:
each pixel adds its accumulated error to the original color, picks the
nearest subpalette entry, and diffuses ``0.8 * [7,3,5,1]/16`` of the
quantization error to its E, SW, S, SE neighbors. Transparent pixels pass
their accumulated error through unchanged (src/lib.rs:463-475).

A raster scan is hostile to a vector machine, but the dependency structure
is not: pixel (x, y) only depends on (x-1, y), (x+1, y-1), (x, y-1) and
(x-1, y-1). Under the skewed coordinate ``c = x + 2*y`` every dependency
has a strictly smaller ``c``, so all pixels on an anti-diagonal ``c`` are
independent and can be processed as one vector step. A 256x256 image needs
``W + 2H - 2 = 766`` sequential steps of 256-wide vector work instead of
65,536 scalar steps — and the whole scan is `vmap`-able over a batch of
candidate palettes.

Float note: the reference accumulates error in f64 with a fixed scalar
order; we use f32 and combine the E/SW contributions in one vectorized add,
so results can differ in the last ulp of the diffused error. The dither-off
path (weights all zero) is exactly the parallel remap in ops/remap.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from snesimage.constants import DITHER_DAMPING, DITHER_WEIGHTS
from snesimage.ops.color import expand_5bit_to_8bit, srgb_u8_to_lab
from snesimage.ops.remap import entry_distances, quantize_target_u8


def _skew_indices(h: int, w: int) -> tuple[jax.Array, jax.Array]:
    y = jnp.arange(h, dtype=jnp.int32)[:, None]
    x = jnp.arange(w, dtype=jnp.int32)[None, :]
    return jnp.broadcast_to(y, (h, w)), x + 2 * y


def skew(img: jax.Array, fill=0) -> jax.Array:
    """(H, W, ...) -> (H, W + 2H - 2, ...) with A[y, x + 2y] = img[y, x]."""
    h, w = img.shape[:2]
    ws = w + 2 * (h - 1)
    yy, cc = _skew_indices(h, w)
    out = jnp.full((h, ws) + img.shape[2:], fill, dtype=img.dtype)
    return out.at[yy, cc].set(img)


def unskew(skewed: jax.Array, h: int, w: int) -> jax.Array:
    yy, cc = _skew_indices(h, w)
    return skewed[yy, cc]


@partial(jax.jit, static_argnames=("perceptual",))
def remap_dithered(
    original_rgb: jax.Array,
    alpha: jax.Array,
    tile_palettes: jax.Array,
    palette5: jax.Array,
    perceptual: bool,
) -> jax.Array:
    """Dithered nearest-entry remap; returns palette_map (H, W) int32.

    Bit-compatible (up to f32-vs-f64 error accumulation) with the
    reference's serial scan; validated against the serial oracle in tests.

    Implementation: `lax.scan` over the skewed columns. Error from column
    ``c`` only reaches columns c+1..c+3, so the carry is a rolling
    (H, 3, 3) error window instead of the full skewed error plane — the
    big arrays are scan inputs/outputs (sliced/stacked by scan itself),
    which keeps per-step work O(H * S) with a tiny carried state instead
    of dragging the whole (H, WS, 3) error plane through every step.
    """
    h, w, _ = original_rgb.shape

    entries8 = expand_5bit_to_8bit(palette5)  # (C, S, 3)
    tp_pix = jnp.repeat(jnp.repeat(tile_palettes, 8, axis=0), 8, axis=1)

    # Scan inputs, skewed and column-major: xs[c] = column c.
    def colmaj(a):
        return jnp.moveaxis(a, 1, 0)  # (H, WS, ...) -> (WS, H, ...)

    orig_sk = colmaj(skew(original_rgb.astype(jnp.float32)))  # (WS, H, 3)
    alpha_sk = colmaj(skew(alpha.astype(jnp.int32)))
    tp_sk = colmaj(skew(tp_pix.astype(jnp.int32)))
    x_of = colmaj(
        skew(
            jnp.broadcast_to(jnp.arange(w, dtype=jnp.int32)[None, :], (h, w)),
            fill=-1,
        )
    )  # source x per skewed cell, -1 outside

    wgt = jnp.asarray(DITHER_WEIGHTS) * DITHER_DAMPING

    # Hoist the per-column subpalette gather out of the sequential loop:
    # one bulk gather (WS, H, S, 3) becomes a scan input that scan slices
    # per step, so no step gathers.
    # Perceptual mode also hoists the entries' CIELAB: the (C, S, 3)
    # table converts ONCE and gathers per column, instead of a LUT +
    # 3x3 matmul + cbrt on (H, S, 3) repeated inside every one of the
    # ~W+H sequential steps (loop-invariant; the target's Lab still
    # depends on the accumulated error and stays in-loop).
    sub_sk = entries8[tp_sk]  # (WS, H, S, 3)
    sub_lab_sk = srgb_u8_to_lab(entries8)[tp_sk] if perceptual else sub_sk
    s_entries = entries8.shape[1]

    def step(err_win, xs):
        # err_win: (H, 3, 3) accumulated error for columns c, c+1, c+2.
        orig_col, alpha_col, sub, sub_lab, x_col = xs
        valid = x_col >= 0
        err_col = err_win[:, 0]

        target = orig_col + err_col
        t_u8 = quantize_target_u8(target)
        d = entry_distances(
            t_u8, sub, perceptual,
            sub_entries_lab=sub_lab if perceptual else None,
        )
        idx = jnp.argmin(d, axis=-1).astype(jnp.int32)
        # one-hot select instead of a per-step take_along_axis gather
        onehot = (idx[:, None] == jnp.arange(s_entries)[None, :]).astype(
            sub.dtype
        )
        new_color = jnp.sum(sub * onehot[..., None], axis=-2)

        opaque = alpha_col > 0
        perr = jnp.where(
            (opaque & valid)[:, None],
            target - new_color.astype(jnp.float32),
            err_col,
        )
        perr = jnp.where(valid[:, None], perr, 0.0)

        m_e = ((x_col + 1 < w) & valid)[:, None].astype(jnp.float32)
        m_sw = ((x_col > 0) & valid)[:, None].astype(jnp.float32)
        m_s = valid[:, None].astype(jnp.float32)
        m_se = m_e

        def down(a):  # contribution from row y lands on row y+1
            return jnp.concatenate([jnp.zeros_like(a[:1]), a[:-1]], axis=0)

        add1 = perr * wgt[0] * m_e + down(perr * wgt[1] * m_sw)
        add2 = down(perr * wgt[2] * m_s)
        add3 = down(perr * wgt[3] * m_se)

        new_win = jnp.stack(
            [err_win[:, 1] + add1, err_win[:, 2] + add2, add3], axis=1
        )
        col_val = jnp.where(opaque & valid, idx, 0)
        return new_win, col_val

    err0 = jnp.zeros((h, 3, 3), dtype=jnp.float32)
    with jax.named_scope("dither_scan"):  # names it in profiler traces
        _, map_cols = jax.lax.scan(
            step, err0, (orig_sk, alpha_sk, sub_sk, sub_lab_sk, x_of)
        )
    return unskew(jnp.moveaxis(map_cols, 0, 1), h, w)


def dither_candidates(
    original_rgb: jax.Array,
    alpha: jax.Array,
    tile_palettes: jax.Array,
    palette5: jax.Array,
    p,
    i,
    cand5: jax.Array,
    perceptual: bool,
) -> jax.Array:
    """Dithered palette maps for B candidate colors of slot (p, i).

    Returns (B, H, W) int32: the wavefront scan vmapped over per-candidate
    palettes.
    """

    def one(c5):
        palette = jax.lax.dynamic_update_slice(
            palette5, c5.reshape(1, 1, 3).astype(palette5.dtype), (p, i, 0)
        )
        return remap_dithered(original_rgb, alpha, tile_palettes, palette, perceptual)

    return jax.vmap(one)(cand5.astype(jnp.int32))
