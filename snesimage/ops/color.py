"""Color-space primitives as vectorized JAX ops.

Vectorized replacements for the reference's scalar color helpers:

- 5-bit <-> 8-bit channel expansion ``c*8 + c//4`` and SNES BGR555 packing
  (reference: src/lib.rs:662-681).
- Red-mean weighted RGB distance (reference: src/lib.rs:1080-1088). For exact
  argmin tie semantics we provide an integer-scaled squared variant computed
  in int32 (the true distance is monotone in it).
- sRGB(u8) <-> CIELAB (D65) and the full CIEDE2000 color difference
  (reference: src/lib.rs:1090-1100, via the `palette` crate). The reference
  memoizes CIEDE2000 in an unbounded host-side hash map ("several gigabytes
  of RAM"); here it is simply recomputed on-device, fully vectorized.
- Nearest-NES-color projection over the 56-entry master palette
  (reference: src/lib.rs:640-660).

All functions are shape-polymorphic over leading batch dimensions: color
arguments use a trailing axis of size 3 and everything broadcasts.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from snesimage.constants import NES_PALETTE_5BIT

# ---------------------------------------------------------------------------
# 5-bit SNES channels
# ---------------------------------------------------------------------------


def expand_5bit_to_8bit(c: jax.Array) -> jax.Array:
    """5-bit channel value -> 8-bit, via ``c*8 + c//4`` (31 -> 255).

    Reference: src/lib.rs:662-669. Input is clipped to [0, 31] first; the
    reference would overflow u8 for out-of-range values (a k-means mean of
    exactly 255 rounds to 32), which we fix by clamping.
    """
    c = jnp.clip(c.astype(jnp.int32), 0, 31)
    return c * 8 + c // 4


def pack_bgr555(palette5: jax.Array) -> jax.Array:
    """Pack 5-bit RGB triples (trailing axis 3) into SNES u16 ``r|g<<5|b<<10``.

    Reference: src/lib.rs:679-681. Returned as int32 (JSON-friendly).
    """
    p = palette5.astype(jnp.int32)
    return p[..., 0] + (p[..., 1] << 5) + (p[..., 2] << 10)


def round_half_away_nonneg(x: jax.Array) -> jax.Array:
    """Rust ``f64::round`` (half away from zero) for non-negative inputs."""
    return jnp.floor(x + 0.5)


# ---------------------------------------------------------------------------
# Red-mean distance
# ---------------------------------------------------------------------------


def red_mean_sq_scaled(rgb1: jax.Array, rgb2: jax.Array) -> jax.Array:
    """512 * red_mean_distance(rgb1, rgb2)**2 as an exact int32.

    Inputs are 8-bit RGB values (any integer dtype, trailing axis 3).
    The scaling makes every term integral:

        512*d^2 = (1024 + r1 + r2)*dr^2 + 2048*dg^2 + (1534 - r1 - r2)*db^2

    max value ~1e8 < 2^31, so int32 arithmetic is exact and argmin over
    these values has exactly the reference's strict-less-than tie behavior
    (reference distance: src/lib.rs:1080-1088).
    """
    c1 = rgb1.astype(jnp.int32)
    c2 = rgb2.astype(jnp.int32)
    d = c1 - c2
    rsum = c1[..., 0] + c2[..., 0]
    return (
        (1024 + rsum) * d[..., 0] * d[..., 0]
        + 2048 * d[..., 1] * d[..., 1]
        + (1534 - rsum) * d[..., 2] * d[..., 2]
    )


def red_mean_distance(rgb1: jax.Array, rgb2: jax.Array) -> jax.Array:
    """True red-mean distance (float), matching src/lib.rs:1080-1088."""
    return jnp.sqrt(red_mean_sq_scaled(rgb1, rgb2).astype(jnp.float64 if jax.config.jax_enable_x64 else jnp.float32) / 512.0)


# ---------------------------------------------------------------------------
# sRGB <-> linear <-> XYZ <-> CIELAB (D65)
# ---------------------------------------------------------------------------

# sRGB D65 RGB->XYZ matrix (same constants as the `palette` crate).
_RGB_TO_XYZ = jnp.array(
    [
        [0.4124564, 0.3575761, 0.1804375],
        [0.2126729, 0.7151522, 0.0721750],
        [0.0193339, 0.1191920, 0.9503041],
    ],
    dtype=jnp.float32,
)
_XYZ_TO_RGB = jnp.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ],
    dtype=jnp.float32,
)
_D65_WHITE = jnp.array([0.95047, 1.0, 1.08883], dtype=jnp.float32)


def srgb01_to_linear(c: jax.Array) -> jax.Array:
    """sRGB transfer decode, input/output in [0, 1]."""
    c = c.astype(jnp.float32)
    return jnp.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _srgb_u8_linear_lut() -> np.ndarray:
    """Exact f64-computed sRGB-decode table for the 256 u8 codes.

    Accelerator transcendentals (`pow`) may carry ~1e-4 relative error,
    which leaks ~0.1 absolute error into CIELAB; u8 inputs make an exact
    table lookup bit-accurate on every backend."""
    c = np.arange(256, dtype=np.float64) / 255.0
    lin = np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
    return lin.astype(np.float32)


_SRGB_U8_LINEAR_LUT = _srgb_u8_linear_lut()


def srgb_u8_to_linear(rgb_u8: jax.Array) -> jax.Array:
    """8-bit sRGB -> linear via the exact 256-entry LUT."""
    return jnp.asarray(_SRGB_U8_LINEAR_LUT)[rgb_u8.astype(jnp.int32)]


def linear_to_srgb01(c: jax.Array) -> jax.Array:
    """sRGB transfer encode, input/output in [0, 1]."""
    c = c.astype(jnp.float32)
    c = jnp.maximum(c, 0.0)
    return jnp.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055)


def _lab_f(t: jax.Array) -> jax.Array:
    delta = 6.0 / 29.0
    return jnp.where(t > delta**3, jnp.cbrt(t), t / (3.0 * delta**2) + 4.0 / 29.0)


def _lab_f_inv(t: jax.Array) -> jax.Array:
    delta = 6.0 / 29.0
    return jnp.where(t > delta, t**3, 3.0 * delta**2 * (t - 4.0 / 29.0))


def srgb_u8_to_lab(rgb: jax.Array) -> jax.Array:
    """8-bit sRGB (trailing axis 3) -> CIELAB (D65, f32).

    Matches the `palette` crate conversion used at reference
    src/lib.rs:101-103, 344-346, 1092-1097.
    """
    lin = srgb_u8_to_linear(rgb)
    xyz = jnp.matmul(lin, _RGB_TO_XYZ.T, precision=jax.lax.Precision.HIGHEST)
    f = _lab_f(xyz / _D65_WHITE)
    l = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return jnp.stack([l, a, b], axis=-1)


def lab_to_srgb_u8(lab: jax.Array) -> jax.Array:
    """CIELAB (D65) -> 8-bit sRGB with clamping and round-to-nearest.

    Matches `Srgb::from_format(Srgb::from_color(Lab::new(..)))` at reference
    src/lib.rs:140-153, 368-371 (palette crate clamps to [0,1] then rounds
    c*255 to nearest).
    """
    lab = lab.astype(jnp.float32)
    fy = (lab[..., 0] + 16.0) / 116.0
    fx = fy + lab[..., 1] / 500.0
    fz = fy - lab[..., 2] / 200.0
    xyz = jnp.stack([_lab_f_inv(fx), _lab_f_inv(fy), _lab_f_inv(fz)], axis=-1)
    xyz = xyz * _D65_WHITE
    lin = jnp.matmul(xyz, _XYZ_TO_RGB.T, precision=jax.lax.Precision.HIGHEST)
    srgb = jnp.clip(linear_to_srgb01(lin), 0.0, 1.0)
    # round_half_away_nonneg, not jnp.round: Rust's (c * 255.0).round()
    # rounds half AWAY from zero (126.5 -> 127) while jnp.round is
    # half-to-even (126.5 -> 126) — an x.5 flip here changes the 5-bit
    # palette after the caller's //8.
    return round_half_away_nonneg(srgb * 255.0).astype(jnp.int32)


# ---------------------------------------------------------------------------
# CIEDE2000
# ---------------------------------------------------------------------------


def ciede2000(lab1: jax.Array, lab2: jax.Array) -> jax.Array:
    """CIEDE2000 color difference (Sharma et al. 2005), fully vectorized.

    Matches `palette::color_difference::Ciede2000` used at reference
    src/lib.rs:8, 1090-1100. Inputs are CIELAB triples (trailing axis 3).
    """
    lab1 = lab1.astype(jnp.float32)
    lab2 = lab2.astype(jnp.float32)
    l1, a1, b1 = lab1[..., 0], lab1[..., 1], lab1[..., 2]
    l2, a2, b2 = lab2[..., 0], lab2[..., 1], lab2[..., 2]

    c1 = jnp.hypot(a1, b1)
    c2 = jnp.hypot(a2, b2)
    cbar = 0.5 * (c1 + c2)
    cbar7 = cbar**7
    g = 0.5 * (1.0 - jnp.sqrt(cbar7 / (cbar7 + 25.0**7)))
    a1p = (1.0 + g) * a1
    a2p = (1.0 + g) * a2
    c1p = jnp.hypot(a1p, b1)
    c2p = jnp.hypot(a2p, b2)

    # Hue angles in degrees in [0, 360); atan2(0, 0) == 0 by convention.
    h1p = jnp.rad2deg(jnp.arctan2(b1, a1p)) % 360.0
    h2p = jnp.rad2deg(jnp.arctan2(b2, a2p)) % 360.0

    dlp = l2 - l1
    dcp = c2p - c1p

    prod_zero = (c1p * c2p) == 0.0
    hdiff = h2p - h1p
    dhp = jnp.where(
        prod_zero,
        0.0,
        jnp.where(
            jnp.abs(hdiff) <= 180.0,
            hdiff,
            jnp.where(hdiff > 180.0, hdiff - 360.0, hdiff + 360.0),
        ),
    )
    dHp = 2.0 * jnp.sqrt(c1p * c2p) * jnp.sin(jnp.deg2rad(dhp) * 0.5)

    lbar = 0.5 * (l1 + l2)
    cbarp = 0.5 * (c1p + c2p)
    hsum = h1p + h2p
    hbarp = jnp.where(
        prod_zero,
        hsum,
        jnp.where(
            jnp.abs(h1p - h2p) <= 180.0,
            0.5 * hsum,
            jnp.where(hsum < 360.0, 0.5 * (hsum + 360.0), 0.5 * (hsum - 360.0)),
        ),
    )

    t = (
        1.0
        - 0.17 * jnp.cos(jnp.deg2rad(hbarp - 30.0))
        + 0.24 * jnp.cos(jnp.deg2rad(2.0 * hbarp))
        + 0.32 * jnp.cos(jnp.deg2rad(3.0 * hbarp + 6.0))
        - 0.20 * jnp.cos(jnp.deg2rad(4.0 * hbarp - 63.0))
    )
    dtheta = 30.0 * jnp.exp(-(((hbarp - 275.0) / 25.0) ** 2))
    cbarp7 = cbarp**7
    rc = 2.0 * jnp.sqrt(cbarp7 / (cbarp7 + 25.0**7))
    lm50 = (lbar - 50.0) ** 2
    sl = 1.0 + 0.015 * lm50 / jnp.sqrt(20.0 + lm50)
    sc = 1.0 + 0.045 * cbarp
    sh = 1.0 + 0.015 * cbarp * t
    rt = -jnp.sin(jnp.deg2rad(2.0 * dtheta)) * rc

    tl = dlp / sl
    tc = dcp / sc
    th = dHp / sh
    return jnp.sqrt(jnp.maximum(tl * tl + tc * tc + th * th + rt * tc * th, 0.0))


def ciede2000_srgb_u8(rgb1: jax.Array, rgb2: jax.Array) -> jax.Array:
    """CIEDE2000 between 8-bit sRGB colors (reference src/lib.rs:1090-1100)."""
    return ciede2000(srgb_u8_to_lab(rgb1), srgb_u8_to_lab(rgb2))


# ---------------------------------------------------------------------------
# NES projection
# ---------------------------------------------------------------------------


def nes_palette_rgb8() -> jax.Array:
    """The 56 NES colors expanded to 8-bit RGB, shape (56, 3) int32."""
    return expand_5bit_to_8bit(jnp.asarray(NES_PALETTE_5BIT))


def nes_quantize(rgb5: jax.Array, perceptual: bool) -> jax.Array:
    """Project 5-bit RGB triples onto the nearest of the 56 NES colors.

    Matches ``SnesColor::new_nes_only`` (reference src/lib.rs:640-660):
    the candidate is expanded to 8-bit, compared against each NES color's
    8-bit expansion with red-mean (or CIEDE2000 when ``perceptual``), and
    the first index achieving the minimum wins (strict less-than scan).
    Returns 5-bit NES triples with the input's batch shape.
    """
    nes5 = jnp.asarray(NES_PALETTE_5BIT)
    nes8 = expand_5bit_to_8bit(nes5)
    rgb8 = expand_5bit_to_8bit(rgb5)
    if perceptual:
        d = ciede2000(
            srgb_u8_to_lab(rgb8)[..., None, :], srgb_u8_to_lab(nes8)
        )
    else:
        d = red_mean_sq_scaled(rgb8[..., None, :], nes8)
    best = jnp.argmin(d, axis=-1)
    return nes5[best]
