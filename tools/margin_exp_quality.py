"""Gate-margin QUALITY experiment: single rep per config —
final plateau error is deterministic, so speed-only reps are skipped.
Runs on the CPU backend; its timing fields are not device times."""
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
    vals = [float(m) for m in sys.argv[1:]] or [0.0]
    for val in vals:
        config = QuantConfig(
            subpalette_count=8, subpalette_size=15, max_steps=10,
            converge_tol=0.5, seed=0, schedule="channel", prescreen=8,
            prescreen_full=2, gate_margin=val,
        )
        for name, img in CONTENTS.items():
            t0 = time.perf_counter()
            _, errors, info = pipeline.run_fused(img, config)
            print(json.dumps({
                "gate": val, "content": name,
                "sec": round(time.perf_counter() - t0, 1),
                "final": round(info["final_error"], 4),
                "steps": len(errors),
                "step_errors": [round(e, 3) for e in errors],
            }), flush=True)


if __name__ == "__main__":
    main()
