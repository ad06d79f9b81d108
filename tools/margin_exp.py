"""Gate/accept-margin experiment harness: timed margin sweeps across
three content types (gradient / photo-like / flat poster). Produced the
rank1-gate margin tables. Run from the repo
root: python tools/margin_exp.py gate 0.0 0.01 0.05"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

import numpy as np

from bench import _test_image
from snesimage.config import QuantConfig
from snesimage.core import pipeline
from snesimage.utils.cache import enable_compile_cache


def photo_image(seed=3):
    """Photo-like: smooth low-freq fields + texture noise."""
    rng = np.random.default_rng(seed)
    h = w = 256
    base = rng.normal(0, 1, (3, 8, 8)).astype(np.float32)
    up = np.kron(base, np.ones((32, 32), np.float32))
    img = np.zeros((h, w, 4), np.uint8)
    for c in range(3):
        field = up[c] + 0.35 * rng.normal(0, 1, (h, w))
        img[..., c] = np.clip(128 + 60 * field, 0, 255)
    img[..., 3] = 255
    return img


def poster_image(seed=5):
    """Flat poster art: few solid colors in blocky shapes."""
    rng = np.random.default_rng(seed)
    h = w = 256
    img = np.zeros((h, w, 4), np.uint8)
    colors = rng.integers(0, 256, (12, 3))
    img[..., :3] = colors[0]
    for k in range(1, 12):
        cy, cx = rng.integers(0, h, 2)
        hh, ww = rng.integers(24, 120, 2)
        img[cy : cy + hh, cx : cx + ww, :3] = colors[k]
    img[..., 3] = 255
    return img


def text_ui_image(seed=7):
    """Hard-edged UI/text-like content: panels, 1px rules, checkerboard
    textures, glyph-ish speckle. Improvements here are scale-0-dominated
    — the rank1 gate's blind spot (found the +27-error premature-stop
    failure that motivated the EXACT-confirmation stop rule)."""
    rng = np.random.default_rng(seed)
    h = w = 256
    img = np.zeros((h, w, 4), np.uint8)
    img[..., :3] = 24
    for _ in range(10):
        cy, cx = rng.integers(0, h - 40, 2)
        hh, ww = rng.integers(30, 100, 2)
        img[cy:cy + hh, cx:cx + ww, :3] = rng.integers(40, 230, 3)
    for _ in range(30):
        y = rng.integers(0, h)
        x0, x1 = sorted(rng.integers(0, w, 2))
        img[y, x0:x1, :3] = rng.integers(0, 256, 3)
    for _ in range(6):
        cy, cx = rng.integers(0, h - 32, 2)
        yy, xx = np.mgrid[0:32, 0:32]
        mask = ((yy + xx) % 2).astype(bool)
        img[cy:cy + 32, cx:cx + 32, :3][mask] = rng.integers(0, 256, 3)
    for row in range(16, 240, 24):
        cols = rng.integers(0, w, 300)
        img[row:row + 6, cols % w, :3] = 235
    img[..., 3] = 255
    return img


CONTENTS = {
    "gradient": _test_image(),
    "photo": photo_image(),
    "poster": poster_image(),
    "text-ui": text_ui_image(),
}


def main():
    enable_compile_cache()
    mode = sys.argv[1] if len(sys.argv) > 1 else "gate"
    vals = [float(m) for m in sys.argv[2:]] or [0.0]
    for val in vals:
        if mode == "gate":
            kw = {"gate_margin": val}
        elif mode == "coarse":  # round-4 coarse gate (QuantConfig.gate_coarse)
            kw = {"gate_margin": val, "gate_coarse": val > 0}
        else:
            kw = {"coarse_rank_scale": int(val)}
        config = QuantConfig(
            subpalette_count=8, subpalette_size=15, max_steps=10,
            converge_tol=0.5, seed=0, schedule="channel", prescreen=8,
            prescreen_full=2, **kw,
        )
        pipeline.run_fused(CONTENTS["gradient"], config)  # compile
        for name, img in CONTENTS.items():
            runs, res = [], None
            for _ in range(3):
                t0 = time.perf_counter()
                res = pipeline.run_fused(img, config)
                runs.append(time.perf_counter() - t0)
            _, errors, info = res
            print(json.dumps({
                mode: val, "content": name,
                "sec": round(min(runs), 3),
                "final": round(info["final_error"], 4),
                "steps": len(errors),
                "step_errors": [round(e, 3) for e in errors],
            }), flush=True)


if __name__ == "__main__":
    main()
