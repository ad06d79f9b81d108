"""Where an NVIDIA GPU and the CPU backend part ways in the two float
objectives: SSIMULACRA2 scores and CIEDE2000 distances.

Needs a GPU; every comparison runs the same jitted function on the card
and on jax.devices("cpu")[0] in this one process.

  metric     scores of noisy and of palette-perturbed frames on both
             backends; then one stage at a time computed on the card with
             every other stage on the CPU (XYB conversion, blurred moments
             of the frame, SSIM/edge maps through the score, the
             reference pyramid), to find whose rounding the gap comes
             from; the ulps between the two backends' blurred moments; and
             the CPU score's response to a random 1-ulp change of those
             moments.
  ciede2000  distances from random 8-bit targets to the bench image's
             clustered 8x15 palette: largest relative difference, argmin
             flips, and the CPU's relative gap between the two picks at
             each flip.
  dither     the perceptual dithered map of the bench image: agreement of
             the card with the CPU and the first differing pixel in scan
             order (x + 2y).

Usage: python tools/backend_gap.py
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bench import _test_image  # noqa: E402
from snesimage.config import QuantConfig  # noqa: E402
from snesimage.core import pipeline  # noqa: E402
from snesimage.core.state import new_state  # noqa: E402
from snesimage.ops import ssimulacra2 as m  # noqa: E402
from snesimage.ops.color import expand_5bit_to_8bit, srgb_u8_to_linear  # noqa: E402
from snesimage.ops.dither import remap_dithered  # noqa: E402
from snesimage.ops.remap import entry_distances, render_rgb8  # noqa: E402

CPU = jax.devices("cpu")[0]


def on(dev, fn, *args):
    return jax.device_get(fn(*jax.device_put(args, dev)))


@jax.jit
def xyb_stage(frames):
    lin, out = srgb_u8_to_linear(frames), []
    for s in range(m.NUM_SCALES):
        if s:
            lin = m.downsample2(lin)
        out.append(m.linear_rgb_to_positive_xyb(lin))
    return tuple(out)


@jax.jit
def moment_stage(refp, img2s):
    return tuple(m._distorted_moments(refp[s][0], img2s[s])
                 for s in range(m.NUM_SCALES))


@jax.jit
def finish_stage(refp, img2s, moms):
    feats = [m._features_from_moments(*refp[s], img2s[s], *moms[s])
             for s in range(m.NUM_SCALES)]
    return m.score_from_features(jnp.stack(feats, axis=-3))


def ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))


def metric_case(gpu, name, ref_u8, frames, rng):
    refp = {d: on(d, jax.jit(m.reference_pyramid), ref_u8) for d in (CPU, gpu)}
    x = {d: on(d, xyb_stage, frames) for d in (CPU, gpu)}
    mom = {d: on(d, moment_stage, refp[d], x[d]) for d in (CPU, gpu)}
    base = on(CPU, finish_stage, refp[CPU], x[CPU], mom[CPU])
    whole = {d: on(d, jax.jit(jax.vmap(m.ssimulacra2_from_ref, (None, 0))),
                   refp[d], frames) for d in (CPU, gpu)}
    rows = {
        "whole metric, card vs CPU": np.abs(whole[gpu] - whole[CPU]),
        "staged, all stages on the card": np.abs(
            on(gpu, finish_stage, refp[gpu], x[gpu], mom[gpu]) - base),
        "XYB conversion on the card": np.abs(on(
            CPU, finish_stage, refp[CPU], x[gpu],
            on(CPU, moment_stage, refp[CPU], x[gpu])) - base),
        "blurred moments on the card": np.abs(on(
            CPU, finish_stage, refp[CPU], x[CPU],
            on(gpu, moment_stage, refp[CPU], x[CPU])) - base),
        "maps through score on the card": np.abs(
            on(gpu, finish_stage, refp[CPU], x[CPU], mom[CPU]) - base),
        "reference pyramid on the card": np.abs(on(
            CPU, finish_stage, refp[gpu], x[CPU],
            on(CPU, moment_stage, refp[gpu], x[CPU])) - base),
    }
    bumped = jax.tree.map(
        lambda a: (a * (1 + rng.choice([-1.0, 1.0], a.shape) * 2.0**-23))
        .astype(np.float32), mom[CPU])
    rows["CPU only, moments moved by 1 ulp"] = np.abs(
        on(CPU, finish_stage, refp[CPU], x[CPU], bumped) - base)
    print(f"metric {name}: {len(frames)} frames, CPU scores "
          f"{np.round(whole[CPU], 4).tolist()}")
    for what, d in rows.items():
        print(f"metric {name}: {what}: max |dscore| {d.max():.3g}, "
              f"mean {d.mean():.3g}")
    u = np.concatenate([ulps(a, b).ravel() for a, b in zip(
        jax.tree.leaves(on(gpu, moment_stage, refp[CPU], x[CPU])),
        jax.tree.leaves(mom[CPU]))])
    print(f"metric {name}: blurred moments card vs CPU (same inputs): "
          f"{(u > 0).mean():.4f} of values differ, max {u.max():.0f} ulp, "
          f"99.9th percentile {np.percentile(u, 99.9):.1f} ulp")


def main() -> int:
    gpu = jax.devices()[0]
    if gpu.platform != "gpu":
        print(f"no GPU: JAX's default device is {gpu.platform}")
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card (nvidia-smi name, power.limit): {card}")
    report(gpu)
    return 0


def report(gpu) -> None:
    rng = np.random.default_rng(0)

    # The 64x64 gradient image of the tests (tests/conftest.py small_image).
    y, x = np.mgrid[0:64, 0:64]
    small = np.stack([(x * 4) % 256, (y * 4) % 256, ((x + y) * 2) % 256],
                     axis=-1).astype(np.uint8)
    small[8:16, 8:16] = (200, 50, 30)
    small[40:56, 40:56] = (20, 180, 220)
    img = _test_image()
    cfg = QuantConfig(subpalette_count=8, subpalette_size=15)
    with jax.default_device(CPU):
        st = jax.device_get(
            pipeline.cluster(pipeline.initialize(new_state(img, cfg), cfg), cfg))

    def noisy(base, n=8):
        return np.clip(base[None].astype(np.int32)
                       + rng.integers(-12, 13, (n,) + base.shape), 0, 255
                       ).astype(np.uint8)

    pals = np.clip(st.palette[None] + rng.integers(-2, 3, (8,) + st.palette.shape),
                   0, 31)
    with jax.default_device(CPU):
        rendered = np.stack([np.asarray(render_rgb8(
            st.palette_map, img[..., 3], st.tile_palettes, p)) for p in pals]
        ).astype(np.uint8)
    metric_case(gpu, "noise +-12 64x64 gradient", small, noisy(small), rng)
    metric_case(gpu, "noise +-12 256x256 bench", img[..., :3],
                noisy(img[..., :3]), rng)
    metric_case(gpu, "palette +-2 256x256 bench", img[..., :3], rendered, rng)

    n = 1 << 18
    targets = rng.integers(0, 256, (n, 3)).astype(np.int32)
    entries = np.asarray(expand_5bit_to_8bit(st.palette))[rng.integers(0, 8, n)]
    dist = jax.jit(lambda t, e: entry_distances(t, e, True))
    dc, dg = (on(d, dist, targets, entries) for d in (CPU, gpu))
    rel = np.abs(dg - dc) / np.maximum(np.abs(dc), 1e-30)
    ac, ag = dc.argmin(-1), dg.argmin(-1)
    flips = np.flatnonzero(ac != ag)
    rows = np.arange(n)
    gap = (dc[rows, ag] - dc[rows, ac]) / np.maximum(dc[rows, ac], 1e-30)
    print(f"ciede2000 {n} targets x 15 entries: max relative difference "
          f"card vs CPU {rel.max():.3g}, {(rel > 0).mean():.4f} of distances "
          f"differ; argmin flips {len(flips)}"
          + (f", CPU relative gap of the two picks at the flips: max "
             f"{gap[flips].max():.3g}" if len(flips) else ""))

    args = (img[..., :3], img[..., 3], st.tile_palettes, st.palette)
    dith = jax.jit(lambda *a: remap_dithered(*a, True))
    mc, mg = (on(d, dith, *args) for d in (CPU, gpu))
    diff = np.argwhere(mc != mg)
    first = diff[np.argmin(diff[:, 1] + 2 * diff[:, 0])] if len(diff) else None
    print(f"dither perceptual 256x256 8x15: card vs CPU agreement "
          f"{(mc == mg).mean():.6f}, {len(diff)} pixels differ, first in scan "
          f"order at (y, x) = {None if first is None else tuple(first)}")


if __name__ == "__main__":
    sys.exit(main())
