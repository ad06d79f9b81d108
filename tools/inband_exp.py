"""In-band (<=115.8) accelerator recipe search (round 5).

Accelerator f32 numerics can land the gated fast descent in another
basin than the CPU backend, so CPU quality tables need not transfer —
the in-band recipe must be found on the device that runs it (not
measured on the H100). This tool runs the candidate recipes with converge_tol=0
(fixed budgets) and prints the FULL per-step error trajectory plus
steady-state wall-clock, so one run per recipe reads off (a) whether it
crosses 115.8 and (b) at which step — i.e. at what wall-clock a capped
config would land in-band.

Candidates (all channel descent + prescreen 8/2):
- quality_e16 — the round-3 quality config (explore 16), budget 14
- quality_e32 / quality_e64 — wider explore: candidates are batched
  into the same prescreen/score kernels, so widening is nearly free on
  the MXU and searches more basins per visit
- gate005 — fast gate at margin 0.005 (CPU round-3: 112.5-114)
- hybrid_e64 — gated fast phase then a 4-step explore-64 polish

Usage: python tools/inband_exp.py [--seeds 0,1,2] [--reps 2] [name ...]
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

import numpy as np

from margin_exp import CONTENTS
from snesimage.config import QuantConfig
from snesimage.core import pipeline
from snesimage.utils.cache import enable_compile_cache

BASE = dict(
    subpalette_count=8, subpalette_size=15, seed=0, schedule="channel",
    prescreen=8, prescreen_full=2,
)
FAST = dict(BASE, max_steps=10, converge_tol=0.5, gate_margin=0.01)

RECIPES = {
    "quality_e16": dict(BASE, max_steps=14, channel_explore=16,
                        accept_margin=0.005),
    "quality_e32": dict(BASE, max_steps=14, channel_explore=32,
                        accept_margin=0.005),
    "quality_e64": dict(BASE, max_steps=12, channel_explore=64,
                        accept_margin=0.005),
    "gate005": dict(BASE, max_steps=12, converge_tol=0.5,
                    gate_margin=0.005),
}
HYBRIDS = {
    "hybrid_e64": (FAST, dict(BASE, max_steps=4, channel_explore=64,
                              accept_margin=0.005)),
}


def run_single(img, cfg_dict, seed, reps):
    cfg = QuantConfig(**{**cfg_dict, "seed": seed})
    best = None
    errors = None
    for _ in range(reps):
        t0 = time.perf_counter()
        _, errs, info = pipeline.run_fused(img, cfg)
        sec = time.perf_counter() - t0
        if best is None or sec < best:
            best = sec
        errors = errs
    return best, errors, info["final_error"]


def run_hybrid(img, pair, seed, reps):
    df, dq = pair
    cfg_f = QuantConfig(**{**df, "seed": seed})
    cfg_q = QuantConfig(**{**dq, "seed": seed})
    best = None
    errors = None
    final = None
    for _ in range(reps):
        t0 = time.perf_counter()
        _, errs, info = pipeline.run_fused_hybrid(img, cfg_f, cfg_q)
        sec = time.perf_counter() - t0
        if best is None or sec < best:
            best = sec
        errors = errs
        final = info["final_error"]
    return best, errors, final


def main():
    enable_compile_cache()
    seeds = [0]
    reps = 2
    names = []
    for a in sys.argv[1:]:
        if a.startswith("--seeds"):
            seeds = [int(s) for s in a.split("=", 1)[1].split(",")]
        elif a.startswith("--reps"):
            reps = int(a.split("=", 1)[1])
        else:
            names.append(a)
    names = names or (list(RECIPES) + list(HYBRIDS))
    img = CONTENTS["gradient"]
    for name in names:
        for seed in seeds:
            if name in HYBRIDS:
                sec, errs, final = run_hybrid(img, HYBRIDS[name], seed, reps)
            else:
                sec, errs, final = run_single(img, RECIPES[name], seed, reps)
            errs = [round(float(e), 3) for e in errs]
            n = len(errs)
            cross = next(
                (i + 1 for i, e in enumerate(errs) if e <= 115.8), None
            )
            print(json.dumps({
                "exp": "inband", "recipe": name, "seed": seed,
                "sec": round(sec, 3), "steps": n,
                "final": round(float(final), 4),
                "sec_per_step": round(sec / max(n, 1), 4),
                "inband_at_step": cross,
                "errors": errs,
            }), flush=True)


if __name__ == "__main__":
    main()
