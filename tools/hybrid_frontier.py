"""Hybrid frontier sweep (round 5).

The full hybrid recipe (fast gated descent to plateau + explore polish,
tools/hybrid_exp.py) measures final error 112.53 on the bench image on
CPU — well inside the reference schedule's seed band (113.37-115.78).
This sweep probes SHORTER variants: cap phase 2 at 2-4 explore steps,
stop phase 1 earlier (tol 1.0), and cheaper explore widths. A variant
is a candidate iff its CPU final stays <= 115.8 (in-band); `--time`
then times the candidates on the accelerator (best-of-3 wall-clock).

Usage:
  python tools/hybrid_frontier.py [content ...]       # CPU quality sweep
  python tools/hybrid_frontier.py --time [content]    # GPU timing
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

import jax.numpy as jnp
import numpy as np

from margin_exp import CONTENTS
from snesimage.config import QuantConfig
from snesimage.core import pipeline
from snesimage.core.state import new_state
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

# name -> (fast overrides, quality overrides). converge_tol=0 in phase 2
# disables its plateau test: the cap IS the budget (fixed-length polish).
VARIANTS = {
    "full": ({}, {}),  # control = hybrid_exp recipe
    "cap2_4": ({}, dict(max_steps=4, converge_tol=0.0)),
    "cap2_3": ({}, dict(max_steps=3, converge_tol=0.0)),
    "cap2_2": ({}, dict(max_steps=2, converge_tol=0.0)),
    "tol1_cap2_3": (dict(converge_tol=1.0),
                    dict(max_steps=3, converge_tol=0.0)),
    "tol1_cap2_2": (dict(converge_tol=1.0),
                    dict(max_steps=2, converge_tol=0.0)),
    "explore8_cap2_3": ({}, dict(max_steps=3, converge_tol=0.0,
                                 channel_explore=8)),
}


def run_variant(img: np.ndarray, name: str):
    df, dq = VARIANTS[name]
    cfg_f = QuantConfig(**{**FAST, **df})
    cfg_q = QuantConfig(**{**QUALITY, **dq})
    t0 = time.perf_counter()
    _, _, info = pipeline.run_fused_hybrid(img, cfg_f, cfg_q)
    sec = time.perf_counter() - t0
    return {
        "sec": round(sec, 3),
        "final": round(info["final_error"], 4),
        "steps": list(info["phase_steps"]),
    }


def main():
    enable_compile_cache()
    timing = "--time" in sys.argv
    names = [a for a in sys.argv[1:] if not a.startswith("--")]
    contents = names or (["gradient"] if timing else list(CONTENTS))
    for vname in VARIANTS:
        for cname in contents:
            img = CONTENTS[cname]
            if timing:
                best = None
                for _ in range(3):
                    row = run_variant(img, vname)
                    if best is None or row["sec"] < best["sec"]:
                        best = row
                row = best
            else:
                row = run_variant(img, vname)
            out = {"exp": "hybrid_frontier", "variant": vname,
                   "content": cname}
            out.update(row)
            print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
