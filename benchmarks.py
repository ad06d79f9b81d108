"""Run every BASELINE.json config end-to-end on the accelerator.

Prints one JSON line per config, each naming the device (bench.py remains
the single-line flagship benchmark). Refuses to time on a CPU backend.
Usage: python benchmarks.py [--steps N] [--batch N]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from bench import _test_image, device_info


def run_single(name: str, config, img, max_steps: int) -> dict:
    import jax

    from snesimage.core import pipeline
    from snesimage.core.refine import error_of, make_reference_pyramid
    from snesimage.core.state import new_state

    # warm-up (compile)
    st = new_state(img, config)
    st = pipeline.initialize(st, config)
    st = pipeline.cluster(st, config)
    refp = make_reference_pyramid(st)
    st, _ = pipeline.optimize(st, config, refp=refp, max_steps=1)
    jax.block_until_ready(st.palette_map)

    t0 = time.perf_counter()
    st = new_state(img, config)
    st = pipeline.initialize(st, config)
    st = pipeline.cluster(st, config)
    refp = make_reference_pyramid(st)
    st, errors = pipeline.optimize(st, config, refp=refp, max_steps=max_steps)
    jax.block_until_ready(st.palette_map)
    elapsed = time.perf_counter() - t0
    return {
        "config": name,
        "seconds": round(elapsed, 3),
        "images_per_sec": round(1.0 / elapsed, 4),
        "final_error": round(float(error_of(st, config, refp)), 4),
        "step_errors": [round(e, 3) for e in errors],
    }


def run_batched(name: str, config, imgs, max_steps: int, chunk: int) -> dict:
    import jax

    from snesimage.parallel import batch as pb

    # warm-up on one chunk
    _ = pb.batched_run(imgs[:chunk], config, max_steps=max_steps)
    t0 = time.perf_counter()
    errors = []
    for lo in range(0, len(imgs), chunk):
        states, errs = pb.batched_run(
            imgs[lo : lo + chunk], config, max_steps=max_steps
        )
        jax.block_until_ready(states.palette_map)
        errors.append(errs[-1])
    elapsed = time.perf_counter() - t0
    return {
        "config": name,
        "seconds": round(elapsed, 3),
        "images": len(imgs),
        "images_per_sec": round(len(imgs) / elapsed, 3),
        "mean_final_error": round(float(np.mean(errors)), 4),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument(
        "--only", help="comma-separated subset: c1,c2,c3,c4,c5 (default all)"
    )
    args = ap.parse_args()

    from snesimage.config import QuantConfig

    device = device_info()
    if device["platform"] == "cpu":
        raise SystemExit("no accelerator: refusing to time on the CPU")

    img = _test_image()
    only = set(args.only.split(",")) if args.only else None

    def wanted(tag):
        return only is None or tag in only

    # BASELINE.json configs 1-4 (single image)
    singles = [
        ("c1", "1x15 RGB no-dither", QuantConfig(subpalette_count=1, subpalette_size=15)),
        ("c2", "8x15 SNES BG", QuantConfig(subpalette_count=8, subpalette_size=15)),
        ("c3", "8x15 dither", QuantConfig(subpalette_count=8, subpalette_size=15, dither=True)),
        ("c4", "8x15 perceptual", QuantConfig(subpalette_count=8, subpalette_size=15, perceptual_palettes=True)),
    ]
    for tag, name, config in singles:
        if not wanted(tag):
            continue
        res = run_single(name, config, img, args.steps)
        print(json.dumps({**res, "device": device}), flush=True)

    # Config 5: NES 4x3, batched images
    if wanted("c5"):
        rng = np.random.default_rng(1)
        imgs = np.stack(
            [_test_image(seed=int(s)) for s in rng.integers(0, 1 << 31, args.batch)]
        )
        config = QuantConfig(subpalette_count=4, subpalette_size=3, nes=True)
        res = run_batched(
            f"4x3 NES batched x{args.batch}", config, imgs, args.steps,
            args.chunk,
        )
        print(json.dumps({**res, "device": device}), flush=True)


if __name__ == "__main__":
    main()
