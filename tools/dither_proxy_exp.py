"""Dither-proxy prescreen QUALITY experiment (round 4,
QuantConfig.dither_proxy): run-level finals of the dithered fast config
with the proxy off vs K=8/12, across contents. The proxy ranks a
dithered visit's candidates by their exact undithered coarse-scale
score and wavefront-dithers only the top K — CPU decides QUALITY (CPU
wall-times are not device times; time it with bench.py-style runs on
the GPU).

Usage: python tools/dither_proxy_exp.py [K ...] [--contents a,b]
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

from margin_exp import CONTENTS
from snesimage.config import QuantConfig
from snesimage.core import pipeline
from snesimage.utils.cache import enable_compile_cache

BASE = dict(
    subpalette_count=8, subpalette_size=15, max_steps=6, converge_tol=0.5,
    seed=0, schedule="channel", prescreen=8, prescreen_full=2, dither=True,
)


def main():
    enable_compile_cache()
    args = [a for a in sys.argv[1:] if not a.startswith("--contents")]
    names = list(CONTENTS)
    for a in sys.argv[1:]:
        if a.startswith("--contents"):
            names = a.split("=", 1)[1].split(",")
    ks = [int(a) for a in args] or [0, 8]
    for k in ks:
        config = QuantConfig(**BASE, dither_proxy=k)
        for name in names:
            t0 = time.perf_counter()
            _, errors, info = pipeline.run_fused(CONTENTS[name], config)
            print(json.dumps({
                "exp": "dither_proxy", "k": k, "content": name,
                "sec": round(time.perf_counter() - t0, 1),
                "final": round(info["final_error"], 4),
                "steps": len(errors),
                "step_errors": [round(e, 3) for e in errors],
            }), flush=True)


if __name__ == "__main__":
    main()
