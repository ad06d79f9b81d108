"""Coarse-to-fine (multigrid) warm-start experiment (round 5).

Goal: the literal <1 s BASELINE north star. The balanced recipe is
in-band at 1.73 s / 8 full-res steps; no measured recipe crosses the
reference band (<=115.78) before ~1.5 s because every step pays
full-resolution metric cost. Multigrid attacks the structure: run the
same descent on a 2x2-mean HALF-RESOLUTION image first (~4x cheaper
per step — the metric dominates undithered step cost and scales with
pixels; SSIMULACRA2 is multi-scale, so half-res scores approximate the
full image's scales 1..5), then LIFT (tile assignments kron-upsampled,
palettes carried verbatim, full remap) and polish with a few full-res
steps.

Usage: python tools/multigrid_exp.py [n1,n2 ...]   (default sweep)
Prints one JSON line per variant: phase errors, final full-res exact
error, wall seconds (warm; compile excluded by a throwaway variant).
"""
import json
import os
import sys
import time
from dataclasses import replace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from bench import _test_image
from snesimage.config import QuantConfig
from snesimage.core import pipeline, refine
from snesimage.core.state import new_state
from snesimage.utils.cache import enable_compile_cache

# The 'balanced' recipe's optimizer fields (cli.OPT_PROFILES), budgets
# supplied per phase.
BAL = dict(
    schedule="channel", prescreen=8, prescreen_full=2, channel_explore=16,
    converge_tol=0.0, accept_margin=0.005,
)
CAP = 10  # shared static step-buffer bound -> one compilation per phase


def downsample_rgba(img: np.ndarray) -> np.ndarray:
    """2x2 box mean; a block is opaque iff its mean alpha >= 128."""
    h, w, _ = img.shape
    blk = img.astype(np.float32).reshape(h // 2, 2, w // 2, 2, 4).mean(
        axis=(1, 3)
    )
    out = np.zeros((h // 2, w // 2, 4), np.uint8)
    out[..., :3] = np.clip(np.floor(blk[..., :3] + 0.5), 0, 255)
    out[..., 3] = np.where(blk[..., 3] >= 128, 255, 0)
    return out


def run_multigrid(img: np.ndarray, n1: int, n2: int, seed: int = 0):
    """Returns (seconds, final full-res exact error, half errs, full errs)."""
    h, w = img.shape[:2]
    half = downsample_rgba(img)
    cfg_h = QuantConfig(
        subpalette_count=8, subpalette_size=15, width=w // 2, height=h // 2,
        max_steps=CAP, seed=seed, **BAL,
    )
    cfg_f = QuantConfig(
        subpalette_count=8, subpalette_size=15, width=w, height=h,
        max_steps=CAP, seed=seed, **BAL,
    )
    t0 = time.perf_counter()
    st_h, errs_h, _ = pipeline.run_fused(half, cfg_h, max_steps=n1)
    # Lift: each half-res 8x8 tile covers exactly four full-res tiles.
    tp = np.kron(
        np.asarray(st_h.tile_palettes), np.ones((2, 2), np.int32)
    )
    st = new_state(img, cfg_f)
    st = st._replace(
        tile_palettes=jnp.asarray(tp), palette=st_h.palette
    )
    st = refine.full_remap(st, cfg_f)
    refp = refine.make_reference_pyramid(st)
    st, summary = pipeline._optimize_fused_summary(
        st, cfg_f, refp, n2, n1, CAP
    )
    s = np.asarray(summary)  # host sync 2
    elapsed = time.perf_counter() - t0
    nf = int(s[CAP])
    return elapsed, float(s[CAP + 1]), errs_h, [float(e) for e in s[:nf]]


def run_baseline(img: np.ndarray, steps: int, seed: int = 0):
    cfg = QuantConfig(
        subpalette_count=8, subpalette_size=15, max_steps=CAP, seed=seed,
        **BAL,
    )
    t0 = time.perf_counter()
    _, errs, meta = pipeline.run_fused(img, cfg, max_steps=steps)
    return time.perf_counter() - t0, meta["final_error"], errs


def main():
    enable_compile_cache()
    variants = [tuple(int(x) for x in a.split(",")) for a in sys.argv[1:]]
    if not variants:
        variants = [(6, 2), (6, 3), (8, 2), (8, 3), (4, 3), (8, 4)]
    img = _test_image()

    run_multigrid(img, 1, 1)  # compile both phase programs
    run_baseline(img, 1)
    for n1, n2 in variants:
        best = None
        for _ in range(2):
            sec, err, eh, ef = run_multigrid(img, n1, n2)
            if best is None or sec < best[0]:
                best = (sec, err, eh, ef)
        sec, err, eh, ef = best
        print(json.dumps({
            "variant": f"mg_{n1}+{n2}",
            "sec": round(sec, 3),
            "final_error": round(err, 4),
            "in_band": err <= 115.78,
            "half_errs": [round(e, 2) for e in eh],
            "full_errs": [round(e, 2) for e in ef],
        }), flush=True)
    for steps in (6, 7, 8):
        sec, err, errs = run_baseline(img, steps)
        print(json.dumps({
            "variant": f"baseline_{steps}",
            "sec": round(sec, 3),
            "final_error": round(err, 4),
            "in_band": err <= 115.78,
        }), flush=True)


if __name__ == "__main__":
    main()
