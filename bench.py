"""Benchmark: 256x256 image optimized on the flagship SNES BG workload.

Measures wall-clock for the full pipeline (k-means init + clustering +
candidate-batched refinement sweeps over all 8x15 slots — the
'balanced' profile: 8 fixed channel-descent sweeps with 16 explore
candidates per visit) on one accelerator, and reports images/sec; the
'fast' gated recipe is also timed and reported as a secondary field. The
baseline is the reference's serial CPU loop, which "generally stops
improving within a few minutes" (README.md:52-54) — anchored at ~180 s,
see BASELINE.md.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...,
"device"}. Refuses to time on a CPU backend (exit 1).

Usage: python bench.py
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

REFERENCE_SECONDS = 180.0  # "a few minutes" (README.md:52-54), lower bound
REFERENCE_BAND_MAX = 115.78  # reference schedule's seed band, upper edge


def _test_image(seed: int = 0) -> np.ndarray:
    """Deterministic natural-ish 256x256 RGBA image (gradients + shapes)."""
    rng = np.random.default_rng(seed)
    h = w = 256
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 4), dtype=np.uint8)
    img[..., 0] = (128 + 90 * np.sin(x / 17) + 30 * np.cos(y / 31)).clip(0, 255)
    img[..., 1] = (128 + 80 * np.cos((x + y) / 23)).clip(0, 255)
    img[..., 2] = (128 + 100 * np.sin(y / 13) * np.cos(x / 41)).clip(0, 255)
    img[..., 3] = 255
    blob = rng.integers(0, 256, (8, 8, 3))
    for _ in range(24):
        cy, cx = rng.integers(0, h - 32), rng.integers(0, w - 32)
        img[cy : cy + 32, cx : cx + 32, :3] = (
            img[cy : cy + 32, cx : cx + 32, :3] // 2
            + np.kron(blob, np.ones((4, 4, 1), dtype=np.uint8)) // 2
        )
    return img


def device_info() -> dict:
    """platform / device_kind / count of the default JAX backend."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def main() -> int:
    from snesimage.config import QuantConfig
    from snesimage.core import pipeline
    from snesimage.utils.cache import enable_compile_cache

    device = device_info()
    if device["platform"] == "cpu":
        print(
            json.dumps({"error": "no accelerator: refusing to time on the CPU",
                        "device": device})
        )
        return 1
    enable_compile_cache()

    # The 'balanced' profile (cli.OPT_PROFILES).
    config = QuantConfig(
        subpalette_count=8, subpalette_size=15, max_steps=8,
        converge_tol=0.0, seed=0, schedule="channel", prescreen=8,
        prescreen_full=2, channel_explore=16, accept_margin=0.005,
    )
    # The 'fast' profile (rank1 gate 0.01, tol 0.5).
    config_fast = QuantConfig(
        subpalette_count=8, subpalette_size=15, max_steps=10,
        converge_tol=0.5, seed=0, schedule="channel", prescreen=8,
        prescreen_full=2, gate_margin=0.01,
    )
    img = _test_image()

    t0 = time.perf_counter()
    pipeline.run_fused(img, config)
    pipeline.run_fused(img, config_fast)
    warmup = time.perf_counter() - t0

    # run_fused ends in a host fetch of the packed summary, so each timing
    # covers the device work. Best of 3.
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, errors, info = pipeline.run_fused(img, config)
        runs.append(time.perf_counter() - t0)
    elapsed = min(runs)

    fast_runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, _, fast_info = pipeline.run_fused(img, config_fast)
        fast_runs.append(time.perf_counter() - t0)
    fast_elapsed = min(fast_runs)

    final_error = info["final_error"]
    print(
        json.dumps(
            {
                "metric": "256x256_images_per_sec_to_converged_ssimulacra2",
                "value": 1.0 / elapsed,
                "unit": "images/sec (8x15 palettes, balanced profile, 1 device)",
                "vs_baseline": REFERENCE_SECONDS / elapsed,
                "elapsed_seconds": elapsed,
                "all_runs_seconds": runs,
                "warmup_seconds": warmup,
                "final_error": final_error,
                "in_band": bool(final_error <= REFERENCE_BAND_MAX),
                "step_errors": errors,
                "fast_config": {
                    "elapsed_seconds": fast_elapsed,
                    "final_error": fast_info["final_error"],
                },
                "device": device,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
