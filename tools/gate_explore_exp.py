"""Quality experiment: the rank1 gate WITH the explore exemption on the
deep-quality config (channel_explore 16, tol 0.1, accept_margin 0.005).

Round 3 measured gate+explore as a heavy quality loss (photo 89.17 ->
97.36) and auto-disabled the pair;
round 4 exempts explore rows from the gate (any explore candidate among
the scale-0 finalists forces exact scoring — core/refine.py), which
removes the diagnosed harm mechanism by construction. This re-measures
the content matrix. The config guard still disables the pair, so the
experiment force-sets gate_margin post-construction.

Runs on the CPU backend; its timing fields are not device times.
Usage: python tools/gate_explore_exp.py 0.0 0.01
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
    vals = [float(m) for m in sys.argv[1:]] or [0.0, 0.01]
    for val in vals:
        config = QuantConfig(
            subpalette_count=8, subpalette_size=15, max_steps=14,
            converge_tol=0.1, seed=0, schedule="channel", prescreen=8,
            prescreen_full=2, channel_explore=16, accept_margin=0.005,
        )
        if val:
            object.__setattr__(config, "gate_margin", val)  # bypass guard
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
