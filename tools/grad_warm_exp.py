"""Gradient WARM-START experiment (round 5): MEASURED DEAD END.

Question: can ~0.1-0.3 s of Adam on the continuous palette replace the
first 2-3 discrete sweeps? (Gradient polish on CONVERGED states was
already dead — tools/grad_polish_exp.py; at the
START the post-cluster error is 153.8 and moves are large, so the
other end deserved its own probe.)

Verdict (CPU mechanism measurements, gap far too wide for backend
divergence to flip):

- Frozen-assignment Adam from init saturates at ~148.5 continuous
  (any lr in 0.002-0.03, 10-300 iters; projection+remap 150.3-152.9)
  while ONE discrete sweep reaches 133.9 — the early
  gains come from jointly CHANGING the pixel assignment, which a
  frozen-map gradient cannot touch (`run_one` below).
- The soft-assignment annealed relaxation (`soft_probe` below:
  per-pixel softmax over the subpalette's S entries, tau annealed,
  palette descended through the blended render) shows the classic
  relaxation gap: soft loss 45-102, hard projection 154-164 — WORSE
  than init. The palette degrades into a blending basis.

Kept as the experiment record; nothing here is shipped in any profile.

Mechanics per warm round: freeze the post-cluster pixel assignment,
Adam on all C*S palette entries in LINEAR RGB through render+metric
(manual Adam so lr and iters are TRACED — one compile covers the whole
sweep matrix), project each channel
to the exactly-nearest 5-bit code, then full_remap. Unlike the polish
(which must stay frozen because it is the LAST phase), remapping here
is the normal entry condition of the discrete sweeps that follow.

Usage: python tools/grad_warm_exp.py [--seeds 0] [--reps 2]
           [--rounds 1,2] [--iters 30,100] [--lr 0.002,0.01]
           [--budget 8] [--contents gradient] [--baseline] [--soft]
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

from margin_exp import CONTENTS
from snesimage.config import QuantConfig
from snesimage.core import pipeline, refine
from snesimage.ops.color import expand_5bit_to_8bit, srgb_u8_to_linear
from snesimage.ops.ssimulacra2 import ssimulacra2_from_ref_linear
from snesimage.utils.cache import enable_compile_cache

# The balanced profile (in-band on the bench image at 8 steps):
# channel descent + prescreen 8/2 + 16 explore candidates + 0.005 margin.
RECIPE = dict(
    subpalette_count=8, subpalette_size=15, seed=0, schedule="channel",
    prescreen=8, prescreen_full=2, channel_explore=16, accept_margin=0.005,
)

_CODES_LIN = srgb_u8_to_linear(
    expand_5bit_to_8bit(jnp.arange(32, dtype=jnp.int32))
)  # (32,) exact linear value of each 5-bit code


@partial(jax.jit, static_argnames=("config",))
def warm_round(state, config: QuantConfig, refp, iters, lr):
    """One warm round: frozen-assignment Adam -> nearest-code projection.
    `iters` and `lr` are traced (dynamic), so every matrix point shares
    one compiled program. Returns the projected 5-bit palette."""
    c, s = config.subpalette_count, config.subpalette_size
    flat0 = srgb_u8_to_linear(expand_5bit_to_8bit(state.palette)).reshape(
        c * s, 3
    )
    tp_pix = jnp.repeat(jnp.repeat(state.tile_palettes, 8, axis=0), 8, axis=1)
    color_index = tp_pix * s + state.palette_map
    amask = (state.alpha > 0)[..., None]

    def loss(flat):
        lin = jnp.where(amask, flat[color_index], 0.0)
        return 100.0 - ssimulacra2_from_ref_linear(refp, lin)

    grad = jax.grad(loss)
    b1, b2, eps = 0.9, 0.999, 1e-8

    def body(carry):
        flat, m, v, t = carry
        g = grad(flat)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1 ** (t + 1))
        vh = v / (1 - b2 ** (t + 1))
        flat = jnp.clip(flat - lr * mh / (jnp.sqrt(vh) + eps), 0.0, 1.0)
        return flat, m, v, t + 1

    z = jnp.zeros_like(flat0)
    flat, _, _, _ = jax.lax.while_loop(
        lambda cy: cy[3] < iters, body, (flat0, z, z, jnp.float32(0))
    )
    pal5 = jnp.argmin(
        jnp.abs(flat[..., None] - _CODES_LIN), axis=-1
    ).astype(jnp.int32)
    return pal5.reshape(c, s, 3)


def run_one(img, cfg, rounds, iters, lr, budget, measure_warm_err):
    cap = max(budget, 1)
    t0 = time.perf_counter()
    state = pipeline.new_state(img, cfg)
    state, refp = pipeline._prep_fused(state, cfg)
    for _ in range(rounds):
        pal5 = warm_round(
            state, cfg, refp, jnp.float32(iters), jnp.float32(lr)
        )
        state = refine.full_remap(state._replace(palette=pal5), cfg)
    warm_err = (
        refine.frame_error_fused(state, cfg, refp) if measure_warm_err
        else None
    )
    state, summary = pipeline._optimize_fused_summary(
        state, cfg, refp, budget, 0, cap
    )
    s = np.asarray(summary)  # the one host sync
    sec = time.perf_counter() - t0
    n = int(s[cap])
    return {
        "sec": round(sec, 3),
        "warm_err": (
            round(float(np.asarray(warm_err)), 3) if measure_warm_err
            else None
        ),
        "steps": n,
        "errors": [round(float(e), 3) for e in s[:n]],
        "final": round(float(s[cap + 1]), 4),
    }


def soft_probe(img, cfg):
    """Soft-assignment annealed relaxation (measured dead end, see module
    docstring): per-pixel softmax over its subpalette's S entries in
    linear RGB, palette descended through the blended render, hard
    projection scored exactly after projection + full_remap."""
    import optax

    state = pipeline.new_state(img, cfg)
    state, refp = pipeline._prep_fused(state, cfg)
    c, s = cfg.subpalette_count, cfg.subpalette_size
    flat0 = srgb_u8_to_linear(expand_5bit_to_8bit(state.palette)).reshape(
        c * s, 3
    )
    tp_pix = jnp.repeat(jnp.repeat(state.tile_palettes, 8, axis=0), 8, axis=1)
    ref_lin = srgb_u8_to_linear(state.rgb)
    amask = (state.alpha > 0)[..., None]

    def soft_loss(flat, tau):
        pp = flat.reshape(c, s, 3)[tp_pix]  # (H, W, S, 3)
        d = jnp.sum((pp - ref_lin[..., None, :]) ** 2, axis=-1)
        w = jax.nn.softmax(-d / tau, axis=-1)
        lin = jnp.where(amask, jnp.einsum("hws,hwsc->hwc", w, pp), 0.0)
        return 100.0 - ssimulacra2_from_ref_linear(refp, lin)

    gfun = jax.jit(jax.grad(soft_loss))
    lfun = jax.jit(soft_loss)

    def project_and_score(flat):
        pal5 = jnp.argmin(
            jnp.abs(flat[..., None] - _CODES_LIN), axis=-1
        ).astype(jnp.int32).reshape(c, s, 3)
        st2 = refine.full_remap(state._replace(palette=pal5), cfg)
        return float(refine.frame_error_fused(st2, cfg, refp))

    print(json.dumps({"exp": "grad_warm_soft", "init_err":
                      round(project_and_score(flat0), 3)}), flush=True)
    for lr, tau0, tau1, iters in (
        (0.01, 0.02, 0.002, 200), (0.02, 0.05, 0.001, 200),
    ):
        opt = optax.adam(lr)
        ost = opt.init(flat0)
        flat = flat0
        marks = {}
        for t in range(1, iters + 1):
            tau = jnp.float32(tau0 * (tau1 / tau0) ** (t / iters))
            upd, ost = opt.update(gfun(flat, tau), ost, flat)
            flat = jnp.clip(flat + upd, 0.0, 1.0)
            if t in (50, 100, 200):
                marks[t] = (round(float(lfun(flat, tau)), 2),
                            round(project_and_score(flat), 2))
        print(json.dumps({
            "exp": "grad_warm_soft", "lr": lr, "tau": [tau0, tau1],
            "iter_to_soft_and_projected": marks,
        }), flush=True)


def run_baseline(img, cfg, budget):
    t0 = time.perf_counter()
    _, errs, info = pipeline.run_fused(img, cfg, max_steps=budget)
    sec = time.perf_counter() - t0
    return {
        "sec": round(sec, 3),
        "steps": len(errs),
        "errors": [round(float(e), 3) for e in errs],
        "final": round(float(info["final_error"]), 4),
    }


def main():
    enable_compile_cache()
    seeds = [0]
    reps = 2
    rounds_list = [1, 2]
    iters_list = [30, 100]
    lr_list = [0.002, 0.01]
    budget = 8
    contents = ["gradient"]
    baseline = False
    soft = False
    for a in sys.argv[1:]:
        if a.startswith("--seeds"):
            seeds = [int(x) for x in a.split("=", 1)[1].split(",")]
        elif a.startswith("--reps"):
            reps = int(a.split("=", 1)[1])
        elif a.startswith("--rounds"):
            rounds_list = [int(x) for x in a.split("=", 1)[1].split(",")]
        elif a.startswith("--iters"):
            iters_list = [int(x) for x in a.split("=", 1)[1].split(",")]
        elif a.startswith("--lr"):
            lr_list = [float(x) for x in a.split("=", 1)[1].split(",")]
        elif a.startswith("--budget"):
            budget = int(a.split("=", 1)[1])
        elif a.startswith("--contents"):
            contents = a.split("=", 1)[1].split(",")
        elif a == "--baseline":
            baseline = True
        elif a == "--soft":
            soft = True
    if soft:
        for name in contents:
            soft_probe(CONTENTS[name],
                       QuantConfig(**{**RECIPE, "max_steps": budget}))
        return
    for name in contents:
        img = CONTENTS[name]
        for seed in seeds:
            cfg = QuantConfig(**{**RECIPE, "seed": seed, "max_steps": budget})
            if baseline:
                best = None
                for _ in range(reps):
                    row = run_baseline(img, cfg, budget)
                    if best is None or row["sec"] < best["sec"]:
                        best = row
                print(json.dumps({
                    "exp": "grad_warm", "recipe": "baseline",
                    "content": name, "seed": seed, "budget": budget, **best,
                }), flush=True)
            for rounds in rounds_list:
                for iters in iters_list:
                    for lr in lr_list:
                        best = None
                        for rep in range(reps):
                            row = run_one(
                                img, cfg, rounds, iters, lr, budget,
                                measure_warm_err=(rep == 0),
                            )
                            if best is None or row["sec"] < best["sec"]:
                                warm = best["warm_err"] if best else None
                                best = row
                                if best["warm_err"] is None:
                                    best["warm_err"] = warm
                        print(json.dumps({
                            "exp": "grad_warm", "content": name,
                            "seed": seed, "rounds": rounds, "iters": iters,
                            "lr": lr, "budget": budget, **best,
                        }), flush=True)


if __name__ == "__main__":
    main()
