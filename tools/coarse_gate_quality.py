"""Coarse-gate QUALITY experiment (round 4, QuantConfig.gate_coarse):
the fast config (tol 0.5) with gate_margin=V and the coarse gate ON,
across the content matrix. Compare against tools/margin_exp_quality.py's
plain-gate rows at the same margins. Runs on the CPU backend, which
decides quality only; its timing fields are not device times.

Usage: python tools/coarse_gate_quality.py 0.01 0.005
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


def main():
    enable_compile_cache()
    vals = [float(m) for m in sys.argv[1:]] or [0.01]
    for val in vals:
        config = QuantConfig(
            subpalette_count=8, subpalette_size=15, max_steps=10,
            converge_tol=0.5, seed=0, schedule="channel", prescreen=8,
            prescreen_full=2, gate_margin=val, gate_coarse=True,
        )
        for name, img in CONTENTS.items():
            t0 = time.perf_counter()
            _, errors, info = pipeline.run_fused(img, config)
            print(json.dumps({
                "coarse_gate": val, "content": name,
                "sec": round(time.perf_counter() - t0, 1),
                "final": round(info["final_error"], 4),
                "steps": len(errors),
                "step_errors": [round(e, 3) for e in errors],
            }), flush=True)


if __name__ == "__main__":
    main()
