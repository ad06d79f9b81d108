"""Three-level prescreen timing/quality experiment (run on the GPU).

Rows: the headline fast config (gate 0.01) and the explore quality
config, each without / with --prescreen-pre. Prints one JSON line per
(config, content) with best-of-3 wall-clock and the final plateau error
— the selection-perfection argument says quality should be unchanged;
wall-clock is the point (the 1/8-res pre-rank skips ~75% of the coarse
stage's pixels for candidates outside the top P).

Usage: python tools/prescreen_pre_exp.py [fast|quality|both]
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

FAST = dict(
    subpalette_count=8, subpalette_size=15, max_steps=10, converge_tol=0.5,
    seed=0, schedule="channel", prescreen=8, prescreen_full=2,
    gate_margin=0.01,
)
QUALITY = dict(
    subpalette_count=8, subpalette_size=15, max_steps=14, converge_tol=0.1,
    seed=0, schedule="channel", prescreen=8, prescreen_full=2,
    channel_explore=16, accept_margin=0.005,
)


def main():
    enable_compile_cache()
    which = sys.argv[1] if len(sys.argv) > 1 else "both"
    rows = []
    if which in ("fast", "both"):
        rows += [("fast", FAST, 0), ("fast+pre16", FAST, 16)]
    if which in ("quality", "both"):
        rows += [("quality", QUALITY, 0), ("quality+pre24", QUALITY, 24)]
    for name, base, pre in rows:
        config = QuantConfig(**base, prescreen_pre=pre)
        pipeline.run_fused(CONTENTS["gradient"], config)  # compile
        for cname, img in CONTENTS.items():
            runs, res = [], None
            for _ in range(3):
                t0 = time.perf_counter()
                res = pipeline.run_fused(img, config)
                runs.append(time.perf_counter() - t0)
            _, errors, info = res
            print(json.dumps({
                "config": name, "content": cname,
                "sec": round(min(runs), 3),
                "final": round(info["final_error"], 4),
                "steps": len(errors),
            }), flush=True)


if __name__ == "__main__":
    main()
