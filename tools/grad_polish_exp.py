"""Differentiable palette polish experiment (round 5).

A quality lever the reference cannot reach (its metric is a black-box
Rust crate, /root/reference/src/lib.rs:503-548): our SSIMULACRA2 is
differentiable by construction (guarded norms, ops/ssimulacra2.py), so
the C*S palette colors can be optimized JOINTLY by gradient descent
through render+metric — 360 continuous dims at once, where the discrete
channel sweeps move one entry, one channel, 32 candidates at a time.

Mechanics: freeze the final pixel->entry assignment (palette_map and
tile_palettes), parameterize each palette entry by its LINEAR-RGB color
(the frozen render is then a pure gather — gradients flow through the
XLA metric path; the sRGB-decode LUT never needs differentiating), run
Adam on `100 - ssimulacra2(gather(params))` with per-iter clamping to
[0,1], then PROJECT each channel to the exactly-nearest 5-bit SNES code
(argmin over the 32 codes' exact f64-derived linear values) and score
exactly, accepting only a strict improvement.

KEY FINDING (round 5, CPU 64x64 case): the assignment must STAY frozen
through the projection — `full_remap` after projection rebuilds the
pixel map by nearest-COLOR distance and destroys the metric-optimal
structure (116.5 -> 154.4 on the debug case; 22% of pixels flip). A
non-nearest-entry palette_map is a perfectly legal final artifact (the
JSON serializes whatever map the state holds), but it means the polish
must be the LAST phase: any later discrete sweep or remap would undo
it. Plain projection off the continuous optimum costs only ~+0.2; the
annealed-quantization variant was measured unnecessary.

Usage: python tools/grad_polish_exp.py [--iters 30,60,150] [--lr 0.002]
           [--seeds 0,1] [--caps 8] [--contents gradient]
"""
import json
import os
import sys
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

from margin_exp import CONTENTS
from snesimage.config import QuantConfig
from snesimage.core import pipeline, refine
from snesimage.ops.color import (
    expand_5bit_to_8bit,
    srgb_u8_to_linear,
)
from snesimage.ops.ssimulacra2 import ssimulacra2_from_ref_linear
from snesimage.utils.cache import enable_compile_cache

# The in-band recipe (the 'balanced' profile, tools/inband_exp.py):
# channel descent + prescreen 8/2 + 16 explore candidates, fixed budget.
RECIPE = dict(
    subpalette_count=8, subpalette_size=15, seed=0, schedule="channel",
    prescreen=8, prescreen_full=2, channel_explore=16, accept_margin=0.005,
    max_steps=8,
)

# Exact linear value of each of the 32 5-bit codes (via the 8-bit
# expansion and the exact f64-derived decode LUT used by the renderer).
_CODES_LIN = srgb_u8_to_linear(
    expand_5bit_to_8bit(jnp.arange(32, dtype=jnp.int32))
)  # (32,)


@partial(jax.jit, static_argnames=("config", "iters", "lr"))
def polish_palette(state, config: QuantConfig, refp, iters: int, lr: float):
    """Jointly gradient-polish all palette entries in linear space with a
    FROZEN pixel assignment; return the projected 5-bit palette."""
    c, s = config.subpalette_count, config.subpalette_size
    flat0 = srgb_u8_to_linear(expand_5bit_to_8bit(state.palette)).reshape(
        c * s, 3
    )
    tp_pix = jnp.repeat(jnp.repeat(state.tile_palettes, 8, axis=0), 8, axis=1)
    color_index = tp_pix * s + state.palette_map  # frozen assignment
    amask = (state.alpha > 0)[..., None]

    def loss(flat):
        lin = jnp.where(amask, flat[color_index], 0.0)
        return 100.0 - ssimulacra2_from_ref_linear(refp, lin)

    opt = optax.adam(lr)

    def body(_, carry):
        flat, ostate = carry
        g = jax.grad(loss)(flat)
        upd, ostate = opt.update(g, ostate, flat)
        flat = jnp.clip(flat + upd, 0.0, 1.0)
        return flat, ostate

    flat, _ = jax.lax.fori_loop(0, iters, body, (flat0, opt.init(flat0)))
    # Exact nearest-5-bit projection per channel: argmin over the 32
    # codes' true linear values (not a rounding heuristic).
    pal5 = jnp.argmin(
        jnp.abs(flat[..., None] - _CODES_LIN), axis=-1
    ).astype(jnp.int32)
    return pal5.reshape(c, s, 3)


def polish_state(state, config, refp, iters=60, lr=0.002):
    """Polish + project + exact rescore with the assignment kept frozen;
    returns (state, exact_error, accepted)."""
    base_err = float(refine.frame_error_fused(state, config, refp))
    pal5 = polish_palette(state, config, refp, iters, lr)
    cand = state._replace(palette=pal5)  # NO remap — see module docstring
    cand_err = float(refine.frame_error_fused(cand, config, refp))
    if cand_err < base_err:  # strict-less-than, like every extension
        return cand, cand_err, True
    return state, base_err, False


def run_one(img, iters, lr, seed, cap):
    cfg = QuantConfig(**{**RECIPE, "seed": seed, "max_steps": cap})
    t0 = time.perf_counter()
    state, errs, info = pipeline.run_fused(img, cfg)
    base_sec = time.perf_counter() - t0
    base_err = info["final_error"]
    refp = refine.make_reference_pyramid(state)

    # First call compiles; time the steady state with a second call.
    polish_state(state, cfg, refp, iters, lr)
    t1 = time.perf_counter()
    _, cand_err, accepted = polish_state(state, cfg, refp, iters, lr)
    polish_sec = time.perf_counter() - t1
    return {
        "base_sec": round(base_sec, 3),
        "base_err": round(float(base_err), 4),
        "polish_sec": round(polish_sec, 3),
        "polished_err": round(cand_err, 4),
        "accepted": bool(accepted),
        "delta": round(float(base_err - cand_err), 4),
    }


def main():
    enable_compile_cache()
    iters_list = [30, 60, 150]
    lr = 0.002
    seeds = [0]
    caps = [8]
    contents = ["gradient"]
    for a in sys.argv[1:]:
        if a.startswith("--iters"):
            iters_list = [int(x) for x in a.split("=", 1)[1].split(",")]
        elif a.startswith("--lr"):
            lr = float(a.split("=", 1)[1])
        elif a.startswith("--seeds"):
            seeds = [int(x) for x in a.split("=", 1)[1].split(",")]
        elif a.startswith("--caps"):
            caps = [int(x) for x in a.split("=", 1)[1].split(",")]
        elif a.startswith("--contents"):
            contents = a.split("=", 1)[1].split(",")
    for name in contents:
        for cap in caps:
            for seed in seeds:
                for iters in iters_list:
                    row = {"exp": "grad_polish", "content": name,
                           "cap": cap, "seed": seed, "iters": iters,
                           "lr": lr}
                    row.update(
                        run_one(CONTENTS[name], iters, lr, seed, cap)
                    )
                    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
