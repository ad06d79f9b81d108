"""Racing seed portfolio experiment (round 5, late session).

Question: can a K-seed portfolio be made cheaper by RACING — run all K
seeds batched for only the first r steps, keep the seed with the lowest
carried error, and finish the remaining (max_steps - r) steps on that
single survivor? The full K=2 balanced portfolio pays the K x batched
cost on every step (its time on the H100 is not measured); racing pays
K x for r steps and 1 x after, so it is a win
iff the carried error at step r predicts the final seed ranking.

Two parts, one GPU run each:
1. `diagnose`: a K-seed balanced portfolio stepped one fused segment at
   a time, printing the PER-SEED error after every step — reads off the
   earliest step at which argmin(cur) is stable (and how many points a
   wrong early pick would cost).
2. `race`: the actual racing recipe (r batched steps via
   _portfolio_fused at K, select, finish via _portfolio_fused at k=1
   with the carried RNG key), timed, vs the full portfolio. The
   survivor's post-selection RNG stream differs from its in-portfolio
   stream (split(sub, 1) vs split(sub, K) per step) — racing is its own
   recipe, not a prefix-equal shortcut, so quality is measured, not
   assumed.

The reference has no portfolio at all (single OS-seeded trajectory,
src/lib.rs:201); this probes a cheaper robustness point than
--opt-profile robust.

Usage: python tools/race_exp.py [diagnose|race] [--k 4] [--r 4]
       [--seeds-base 0] [--reps 2]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from margin_exp import CONTENTS
from snesimage.config import QuantConfig
from snesimage.core import refine
from snesimage.core.init import assign_tiles, recalculate_palettes
from snesimage.core.state import QuantState, new_state
from snesimage.parallel import batch
from snesimage.utils.cache import enable_compile_cache

BALANCED = dict(
    subpalette_count=8, subpalette_size=15, schedule="channel",
    prescreen=8, prescreen_full=2, channel_explore=16,
    converge_tol=0.0, max_steps=8, accept_margin=0.005,
)


def setup(img, cfg):
    """Deterministic init shared by every seed (mirrors portfolio_run)."""
    state = new_state(img, cfg)
    if cfg.subpalette_count == 1:
        state = recalculate_palettes(state, cfg)
    else:
        state = assign_tiles(state, cfg)
    state = refine.full_remap(state, cfg)
    state = recalculate_palettes(state, cfg)
    state = refine.full_remap(state, cfg)
    refp = refine.make_reference_pyramid(state)
    return state, refp


def fresh_carry(state, cfg, refp, k, cap):
    bc = lambda x: jnp.broadcast_to(x[None], (k,) + x.shape)
    cur0 = refine.frame_error_fused(state, cfg, refp)
    return (
        bc(state.palette), bc(state.palette_map),
        jax.random.key(cfg.seed), jnp.broadcast_to(cur0, (k,)),
        jnp.full((cap,), jnp.nan, jnp.float32), jnp.bool_(False),
    )


def diagnose(img, k, seed_base, reps):
    cfg = QuantConfig(**{**BALANCED, "seed": seed_base})
    state, refp = setup(img, cfg)
    cap = cfg.max_steps
    per_step = []  # [step][seed] error
    t0 = None
    for rep in range(reps):
        carry = fresh_carry(state, cfg, refp, k, cap)
        per_step = []
        t0 = time.perf_counter()
        for step in range(cfg.max_steps):
            carry, _ = batch._portfolio_fused(
                state, cfg, refp, k, jnp.int32(step), jnp.int32(step + 1),
                cap, carry,
            )
            per_step.append(np.asarray(jax.device_get(carry[3])))
        sec = time.perf_counter() - t0
    finals = per_step[-1]
    best_final = int(finals.argmin())
    picks = [int(e.argmin()) for e in per_step]
    # Regret of picking at step r: final error of the step-r argmin seed
    # minus the true best final.
    regret = [round(float(finals[p] - finals[best_final]), 3) for p in picks]
    print(json.dumps({
        "exp": "race_diagnose", "k": k, "seed_base": seed_base,
        "sec_last_rep": round(sec, 3),
        "per_step_errors": [[round(float(x), 3) for x in e]
                            for e in per_step],
        "argmin_by_step": picks, "best_final_seed": best_final,
        "finals": [round(float(x), 3) for x in finals],
        "pick_regret_by_step": regret,
    }), flush=True)


def race(img, k, r, seed_base, reps):
    cfg = QuantConfig(**{**BALANCED, "seed": seed_base})
    state, refp = setup(img, cfg)
    cap = cfg.max_steps
    best_sec = None
    out = None
    for rep in range(reps):
        t0 = time.perf_counter()
        carry = fresh_carry(state, cfg, refp, k, cap)
        carry, _ = batch._portfolio_fused(
            state, cfg, refp, k, jnp.int32(0), jnp.int32(r), cap, carry,
        )
        pals, pms, key, cur, errs, stop = carry
        best = int(np.asarray(jax.device_get(cur)).argmin())
        solo = (
            pals[best:best + 1], pms[best:best + 1], key,
            cur[best:best + 1], errs, stop,
        )
        solo, _ = batch._portfolio_fused(
            state, cfg, refp, 1, jnp.int32(r), jnp.int32(cfg.max_steps),
            cap, solo,
        )
        final = float(jax.device_get(solo[3])[0])
        sec = time.perf_counter() - t0
        if best_sec is None or sec < best_sec:
            best_sec = sec
        out = dict(final=round(final, 4), picked_seed_lane=best)
    print(json.dumps({
        "exp": "race", "k": k, "r": r, "seed_base": seed_base,
        "sec": round(best_sec, 3), **out,
    }), flush=True)


def main():
    enable_compile_cache()
    mode = "diagnose"
    k, r, seed_base, reps = 4, 4, 0, 2
    for a in sys.argv[1:]:
        if a in ("diagnose", "race"):
            mode = a
        elif a.startswith("--k="):
            k = int(a.split("=", 1)[1])
        elif a.startswith("--r="):
            r = int(a.split("=", 1)[1])
        elif a.startswith("--seeds-base="):
            seed_base = int(a.split("=", 1)[1])
        elif a.startswith("--reps="):
            reps = int(a.split("=", 1)[1])
    img = CONTENTS["gradient"]
    if mode == "diagnose":
        diagnose(img, k, seed_base, reps)
    else:
        race(img, k, r, seed_base, reps)


if __name__ == "__main__":
    main()
