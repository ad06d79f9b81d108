"""End-to-end pipeline driver.

The reference's three GUI phases (TileAssignment -> Clustering ->
Optimization, src/lib.rs:825-830, advanced by green-button clicks at
src/lib.rs:982-997) become explicit pipeline stages:

  1. `initialize`  — tile->subpalette assignment + flat palette fill +
                     first remap (reference `initialize_tiles`).
  2. `cluster`     — per-subpalette pixel k-means + remap (reference
                     `recalculate_palettes`).
  3. `optimize`    — the scheduler loop over (subpalette, entry) slots
                     (reference src/lib.rs:888-933), with explicit
                     stopping criteria instead of running forever.

The GUI's manual tile reassignment (clicking a tile cycles its subpalette,
src/lib.rs:1005-1024) is exposed as `reassign_tile`.

Scheduler parity (src/lib.rs:888-932): steps with ``step % 5 < 4`` use the
random method, the fifth uses the channel sweep; in channel steps each slot
is visited three times (channels 0,1,2) before advancing. `--nes` always
uses the NES sweep; the reference's counter quirk that NES-sweeps a slot
three times during channel steps is coalesced to one sweep here — the NES
sweep is deterministic and idempotent, so repeats are provable no-ops
(src/lib.rs:242-284: same 56 evaluations, same argmin).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from functools import partial
from typing import Callable, Iterator

import jax
import jax.numpy as jnp
import numpy as np

from snesimage.config import QuantConfig
from snesimage.constants import RANDOM_STEPS_PER_CYCLE, SCHEDULE_CYCLE
from snesimage.core.init import assign_tiles, recalculate_palettes
from snesimage.core import refine
from snesimage.core.refine import (
    error_of,
    full_remap,
    make_reference_pyramid,
    refine_slot_channel,
    refine_slot_nes,
    refine_slot_random,
    sweep_channel,
    sweep_nes,
    sweep_random,
)
from snesimage.core.state import QuantState, new_state

log = logging.getLogger("snesimage")


@dataclasses.dataclass
class SlotVisit:
    """One scheduler position: which slot, which method."""

    step: int
    palette: int
    index: int
    method: str  # "random" | "channel" | "nes"
    channel: int  # only meaningful for "channel"


def _stop_cycle(config: QuantConfig) -> int:
    """Steps per convergence-comparison window: the reference schedule
    mixes weak random steps with strong channel steps, so the stop rule
    compares errors one full 5-step cycle apart; the homogeneous channel
    and NES schedules compare successive steps."""
    if config.nes or config.schedule == "channel":
        return 1
    return SCHEDULE_CYCLE


def _is_random_step(config: QuantConfig, step: int) -> bool:
    """Effective method selector for a step: reference cycle (4 random, 1
    channel; src/lib.rs:890) unless the channel-descent schedule extension
    forces pure coordinate descent."""
    if config.schedule == "channel":
        return False
    return step % SCHEDULE_CYCLE < RANDOM_STEPS_PER_CYCLE


def _windowing_active(config: QuantConfig) -> bool:
    """Whether the windowed channel-descent extension applies at all
    (see QuantConfig.channel_window)."""
    return (
        config.channel_window > 0
        and config.schedule == "channel"
        and not config.nes
    )


def _is_window_step(config: QuantConfig, step):
    """Windowed-vs-exhaustive selector for a channel-descent step.

    Works on Python ints (host-stepped loop) and traced int32 (the fused
    loop's lax.cond): the first `channel_window_warmup` sweeps and every
    `channel_window_period`-th post-warmup sweep are exhaustive; the rest
    are windowed. Exhaustive sweeps keep the large-jump escapes windowing
    loses; the convergence test fires only on them."""
    if not _windowing_active(config):
        return False if isinstance(step, int) else jnp.bool_(False)
    warm = config.channel_window_warmup
    per = config.channel_window_period
    return (step >= warm) & ((step - warm) % per != per - 1)


def _step_visits(config: QuantConfig, step: int) -> Iterator[SlotVisit]:
    """Slot visits of one scheduler step, reference order."""
    is_random = _is_random_step(config, step)
    for palette in range(config.subpalette_count):
        for index in range(config.subpalette_size):
            if config.nes:
                yield SlotVisit(step, palette, index, "nes", 0)
            elif is_random:
                yield SlotVisit(step, palette, index, "random", 0)
            else:
                for channel in range(3):
                    yield SlotVisit(step, palette, index, "channel", channel)


def schedule(config: QuantConfig, max_steps: int) -> Iterator[SlotVisit]:
    """Reference scheduler order (src/lib.rs:888-932) for `max_steps` full
    steps. Yields slot visits in the exact reference sequence (with the
    NES triple-visit quirk coalesced; see module docstring)."""
    for step in range(max_steps):
        yield from _step_visits(config, step)


def initialize(state: QuantState, config: QuantConfig) -> QuantState:
    """Stage 1: tile assignment + initial palettes + remap
    (reference `initialize_tiles`, src/lib.rs:79-189)."""
    if config.subpalette_count == 1:
        state = recalculate_palettes(state, config)
    else:
        state = assign_tiles(state, config)
    return full_remap(state, config)


def cluster(state: QuantState, config: QuantConfig) -> QuantState:
    """Stage 2: per-subpalette k-means + remap
    (reference `recalculate_palettes`, src/lib.rs:407-415)."""
    state = recalculate_palettes(state, config)
    return full_remap(state, config)


def reassign_tile(
    state: QuantState,
    config: QuantConfig,
    tile_x: int,
    tile_y: int,
    recluster: bool = True,
) -> QuantState:
    """Cycle one tile's subpalette id (GUI click, src/lib.rs:1005-1024)."""
    if not (
        0 <= tile_x < config.width_tiles and 0 <= tile_y < config.height_tiles
    ):
        # JAX silently drops out-of-bounds scatters (and clamps the
        # read), which would make a bad coordinate a no-op; validate
        # like apply_tile_reassignments does.
        raise ValueError(
            f"tile ({tile_x}, {tile_y}) out of range for a "
            f"{config.width_tiles}x{config.height_tiles} tile grid"
        )
    tp = state.tile_palettes.at[tile_y, tile_x].set(
        (state.tile_palettes[tile_y, tile_x] + 1) % config.subpalette_count
    )
    state = state._replace(tile_palettes=tp)
    if recluster:
        state = cluster(state, config)
    return state


def apply_tile_reassignments(
    state: QuantState,
    config: QuantConfig,
    assignments: list[tuple],
    recluster: bool = True,
) -> QuantState:
    """Apply a batch of manual tile reassignments — the CLI/file surface
    for the GUI's only state-editing interaction (clicking a tile cycles
    its subpalette, src/lib.rs:1005-1024).

    Each item is `(tile_x, tile_y)` — cycle that tile's subpalette once,
    exactly like one GUI click — or `(tile_x, tile_y, palette)` — set it
    directly (what a user clicking repeatedly is actually after). Applied
    on the host in one pass (the map is a tiny int32 grid; per-element
    device updates would cost one dispatch each), then reclustered once,
    mirroring the reference's recalculate_palettes-after-click."""
    tp = np.asarray(state.tile_palettes).copy()
    for item in assignments:
        if len(item) == 2:
            x, y = item
            pal = None
        elif len(item) == 3:
            x, y, pal = item
        else:
            raise ValueError(
                f"reassignment must be (x, y) or (x, y, palette), got {item!r}"
            )
        if not (0 <= x < config.width_tiles and 0 <= y < config.height_tiles):
            raise ValueError(
                f"tile ({x}, {y}) outside the {config.width_tiles}x"
                f"{config.height_tiles} tile grid"
            )
        if pal is None:
            tp[y, x] = (tp[y, x] + 1) % config.subpalette_count
        else:
            if not 0 <= pal < config.subpalette_count:
                raise ValueError(
                    f"palette {pal} outside [0, {config.subpalette_count})"
                )
            tp[y, x] = pal
    state = state._replace(tile_palettes=jnp.asarray(tp))
    if recluster:
        state = cluster(state, config)
    return state


def parse_reassignments(text: str) -> list[tuple]:
    """Parse a tile-reassignment spec: one tile per line, `x y` (cycle
    once) or `x y palette` (set directly); blank lines and #-comments
    ignored."""
    out: list[tuple] = []
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        if len(parts) not in (2, 3):
            raise ValueError(
                f"line {ln}: expected 'x y' or 'x y palette', got {raw!r}"
            )
        try:
            out.append(tuple(int(p) for p in parts))
        except ValueError:
            raise ValueError(f"line {ln}: non-integer field in {raw!r}")
    return out


@partial(jax.jit, static_argnames=("config", "cap"))
def _optimize_fused(
    state: QuantState, config: QuantConfig, refp, max_steps, start_step, cap: int
):
    """The whole refinement loop as ONE XLA program: a while_loop over
    full-sweep steps with the convergence check on-device.

    The host-driven fast path dispatches one sweep per step and syncs on
    its error for the plateau test. Here the host sees only the final
    (state, per-step errors, step count). Schedule and RNG
    stream (fold_in(seed, start_step), split-per-random-step) mirror
    `optimize` exactly.

    Stop rule (round-3 semantics, see `optimize`): every slot visit
    carries the EXACT error of its resulting state (refine._pick — the
    accepted candidate's exact two-level score, or the carried baseline
    on reject), so a sweep's final error IS the exact post-step
    full-frame error. It is compared against the exact error one full
    schedule cycle ago — 1 step for the channel/NES schedules,
    SCHEDULE_CYCLE (5) for the reference schedule, so a single weak
    random step inside a cycle can never fire the stop while the channel
    step still improves. Logged per-step errors stay the reference-format
    last-slot values (identical to the carried exact error).

    `max_steps` and `start_step` are DYNAMIC (one compilation serves any
    step budget up to the static buffer bound `cap`, so a short warm-up
    run compiles the program a full run reuses)."""
    key0 = jax.random.fold_in(jax.random.key(config.seed), start_step)
    tol = jnp.float32(config.converge_tol)
    max_steps = jnp.minimum(jnp.int32(max_steps), cap)
    cycle = _stop_cycle(config)

    explore = config.channel_explore > 0

    gating = refine._gating_active(config)

    def step_fn(st, key, step, cur_err, use_gate):
        if config.nes:
            res = sweep_nes(st, config, refp, cur_err)
            return res.state, res.error, key
        if config.schedule == "channel":
            sub = None
            if explore:
                key, sub = jax.random.split(key)
            if _windowing_active(config):
                res = jax.lax.cond(
                    _is_window_step(config, step),
                    lambda op: sweep_channel(
                        op[0], config, refp, op[1], key=op[2], window=True,
                        use_gate=op[3],
                    ),
                    lambda op: sweep_channel(
                        op[0], config, refp, op[1], key=op[2],
                        use_gate=op[3],
                    ),
                    (st, cur_err, sub, use_gate),
                )
            else:
                res = sweep_channel(
                    st, config, refp, cur_err, key=sub, use_gate=use_gate
                )
            return res.state, res.error, key
        def do_random(operand):
            st, key, cur_err, use_gate = operand
            key, sub = jax.random.split(key)
            res = sweep_random(st, config, refp, sub, cur_err, use_gate)
            return res.state, res.error, key
        def do_channel(operand):
            st, key, cur_err, use_gate = operand
            sub = None
            if explore:
                key, sub = jax.random.split(key)
            res = sweep_channel(
                st, config, refp, cur_err, key=sub, use_gate=use_gate
            )
            return res.state, res.error, key
        return jax.lax.cond(
            step % SCHEDULE_CYCLE < RANDOM_STEPS_PER_CYCLE,
            do_random,
            do_channel,
            (st, key, cur_err, use_gate),
        )

    def cond(carry):
        _, _, local, _, _, _, done, _ = carry
        return (local < max_steps) & ~done

    def body(carry):
        st, key, local, cur, window, errs, _, need_exact = carry
        step = start_step + local
        is_win = (
            _is_window_step(config, step)
            if _windowing_active(config)
            else jnp.bool_(False)
        )
        # A pending confirmation only lands on an EXHAUSTIVE sweep: a
        # windowed sweep can never fire the stop (below), so running it
        # exact would consume the confirmation without being able to
        # conclude anything — measured: the stop then almost never
        # aligns and every run churns to the step cap.
        this_exact = need_exact & ~is_win
        st, full, key = step_fn(st, key, step, cur, ~this_exact)
        errs = errs.at[local].set(full)
        slot = local % cycle
        prev = jax.lax.dynamic_index_in_dim(window, slot, 0, keepdims=False)
        starved = (tol > 0) & (prev - full < tol)
        # A windowed sweep's small delta must not fire the stop: the
        # next exhaustive sweep may still make large-jump escapes.
        starved = starved & ~is_win
        if gating:
            # EXACT confirmation before any stop: a gated sweep that
            # improves < tol does not fire the stop — it forces the NEXT
            # exhaustive sweep to run ungated (every visit fully
            # scored), and only an exact sweep's sub-tol improvement
            # converges the run. On hard-edged content gated sweeps can
            # starve while real (scale-0-dominated) improvements remain
            # — measured +27 error on a text/UI image without
            # confirmation; with it, the gate is a pure
            # speed heuristic and the stop rule stays exact.
            done = starved & this_exact
            need_exact = (need_exact & is_win) | (starved & ~this_exact)
        else:
            done = starved
        window = jax.lax.dynamic_update_index_in_dim(window, full, slot, 0)
        return st, key, local + 1, full, window, errs, done, need_exact

    full0 = refine.frame_error_fused(state, config, refp)
    init = (
        state,
        key0,
        jnp.int32(0),
        full0,
        jnp.full((cycle,), jnp.inf, jnp.float32),
        jnp.full((cap,), jnp.inf, jnp.float32),
        jnp.bool_(False),
        jnp.bool_(False),
    )
    st, _, n, _, _, errs, _, _ = jax.lax.while_loop(cond, body, init)
    return st, errs, n


@partial(jax.jit, static_argnames=("config",))
def _prep_fused(state: QuantState, config: QuantConfig):
    """initialize + cluster + reference pyramid as ONE dispatched program
    instead of four jitted dispatches and an eager pyramid. The optimize
    loop stays a separate program."""
    state = initialize(state, config)
    state = cluster(state, config)
    return state, make_reference_pyramid(state)


@partial(jax.jit, static_argnames=("config", "cap"))
def _optimize_fused_summary(
    state: QuantState, config: QuantConfig, refp, max_steps, start_step,
    cap: int,
):
    """`_optimize_fused` plus the final exact frame error, with the scalar
    results packed into ONE (cap+2,) vector = [step_errors, n_steps,
    final_error] so the host fetches everything in a single sync.

    With carried exact errors (refine._pick) the last step's error IS the
    exact final frame error, so it is reused; a fresh evaluation only
    runs for zero-step budgets. The reused value can differ from a
    recomputation by f32 rounding (~1e-5 relative — same math, different
    XLA program), which is below every logging/stop-rule tolerance."""
    state, errs, n = _optimize_fused(
        state, config, refp, max_steps, start_step, cap
    )
    final = jax.lax.cond(
        n > 0,
        lambda: jax.lax.dynamic_index_in_dim(
            errs, jnp.maximum(n - 1, 0), 0, keepdims=False
        ),
        lambda: refine.frame_error_fused(state, config, refp),
    )
    summary = jnp.concatenate(
        [errs, jnp.stack([n.astype(jnp.float32), final])]
    )
    return state, summary


def run_fused(
    source_rgba: np.ndarray,
    config: QuantConfig,
    *,
    max_steps: int | None = None,
    start_step: int = 0,
) -> tuple[QuantState, list[float], dict]:
    """Full pipeline with exactly ONE host sync.

    Init, clustering and the pyramid dispatch asynchronously, the whole
    refinement loop runs as one XLA program, and the host fetches one
    packed summary vector (step errors + step count + the final exact
    error computed in-program). Semantically equal to `run` (same stages,
    same RNG stream, same stop rule)."""
    state = new_state(source_rgba, config)
    if max_steps is None:
        max_steps = config.max_steps
    # cap >= 1 so the step-error buffer is indexable at trace time even
    # for zero-step budgets (the while_loop body is traced regardless).
    cap = max(config.max_steps, max_steps, 1)
    t0 = time.perf_counter()
    state, refp = _prep_fused(state, config)
    state, summary = _optimize_fused_summary(
        state, config, refp, max_steps, start_step, cap
    )
    s = np.asarray(summary)  # the one host sync
    elapsed = time.perf_counter() - t0
    n = int(s[cap])
    errors = [float(e) for e in s[:n]]
    for local, err in enumerate(errors):
        log.info("step %d error: %f", start_step + local, err)
    return state, errors, {
        "total_seconds": elapsed,
        "final_error": float(s[cap + 1]),
    }


def run_fused_hybrid(
    source_rgba: np.ndarray,
    config_fast: QuantConfig,
    config_quality: QuantConfig,
) -> tuple[QuantState, list[float], dict]:
    """Two-phase schedule as chained fused programs with ONE host sync.

    Phase 1 runs ``config_fast`` (the gated channel-descent recipe) to
    its plateau; phase 2 runs ``config_quality`` (explore polish)
    CONTINUING from phase 1's state. Rationale (round 4, tools/
    hybrid_exp.py): the quality recipe's early sweeps pay explore-
    candidate cost for coarse progress the gated fast sweeps make
    cheaper — chaining reached a better plateau than either recipe
    alone ON THE CPU BACKEND (bench image: 112.53 vs 115.04
    quality-alone vs the reference schedule's 113.4-115.8 seed band).
    The gain did not carry over to an accelerator backend, where f32
    trajectory divergence can land phase 1 in a worse basin the polish
    cannot escape; 'balanced' is the recommended profile there. Not
    measured on the H100.

    Phase 2's RNG stream starts after phase 1's step count, consumed as
    a DYNAMIC on-device start_step — no host fetch between the phases;
    the packed summaries of both phases are fetched in one sync. Both
    configs must agree on geometry and mode flags (same state layout
    and reference pyramid)."""
    for field in (
        "width", "height", "subpalette_count", "subpalette_size",
        "dither", "perceptual_palettes", "nes",
    ):
        if getattr(config_fast, field) != getattr(config_quality, field):
            raise ValueError(
                f"hybrid phases disagree on {field}: "
                f"{getattr(config_fast, field)!r} vs "
                f"{getattr(config_quality, field)!r}"
            )
    state = new_state(source_rgba, config_fast)
    cap1 = max(config_fast.max_steps, 1)
    cap2 = max(config_quality.max_steps, 1)
    t0 = time.perf_counter()
    state, refp = _prep_fused(state, config_fast)
    state, s1 = _optimize_fused_summary(
        state, config_fast, refp, cap1, 0, cap1
    )
    n1 = s1[cap1].astype(jnp.int32)
    state, s2 = _optimize_fused_summary(
        state, config_quality, refp, cap2, n1, cap2
    )
    s = np.asarray(jnp.concatenate([s1, s2]))  # the one host sync
    elapsed = time.perf_counter() - t0
    k1 = int(s[cap1])
    k2 = int(s[cap1 + 2 + cap2])
    errors = [float(e) for e in s[:k1]] + [
        float(e) for e in s[cap1 + 2 : cap1 + 2 + k2]
    ]
    for local, err in enumerate(errors):
        log.info("step %d error: %f", local, err)
    return state, errors, {
        "total_seconds": elapsed,
        "final_error": float(s[cap1 + 2 + cap2 + 1]),
        "phase_steps": (k1, k2),
    }


def optimize(
    state: QuantState,
    config: QuantConfig,
    *,
    refp=None,
    max_steps: int | None = None,
    start_step: int = 0,
    reassign_every: int = 0,
    on_slot: Callable[[SlotVisit, float], None] | None = None,
    on_step: Callable[[int, QuantState, list[float]], None] | None = None,
    on_step_state: Callable[
        [int, QuantState, list[float]], QuantState | None
    ] | None = None,
) -> tuple[QuantState, list[float]]:
    """Stage 3: the refinement loop.

    `on_step(step, state, errors_so_far)` is called after every completed
    sweep — the CLI's periodic mid-run output dump (the reference's blue
    button writes output at any moment of its indefinite run,
    src/lib.rs:999-1003). Like `on_slot` it forces the host-stepped loop
    (one dispatch+sync per sweep) instead of the fully fused one, but the
    stop rule is unchanged.

    `on_step_state(step, state, errors_so_far)` may return a REPLACEMENT
    state the loop continues from (None = unchanged) — the mid-run
    mutation channel behind the CLI's live `--reassign-tiles` re-read
    (the reference GUI accepts a tile click at any moment of the
    optimization phase and re-clusters on the spot, src/lib.rs:1005-1024).
    It runs after `on_step`, and the plateau test evaluates the replaced
    state, so an injected edit cannot stop the run on a stale error.

    Returns (final_state, per-step errors). Stops after `max_steps` full
    steps or when the EXACT post-step full-frame error improves by less
    than `config.converge_tol` over one full schedule cycle (1 step for
    the channel/NES schedules, 5 for the reference schedule — see
    `_stop_cycle`; the reference runs indefinitely, README.md:52-54 notes
    it "generally stops improving within a few minutes"). Logged per-step
    errors remain the reference-format last-slot values; the stop test
    uses a freshly computed frame error so in-batch evaluation noise and
    schedule heterogeneity cannot fire it early.

    `start_step` advances the RNG stream on resume — without it a resumed
    run would re-draw the exact candidate colors it already evaluated and
    make no progress.
    """
    if refp is None:
        refp = make_reference_pyramid(state)
    if max_steps is None:
        max_steps = config.max_steps

    if (
        on_slot is None
        and on_step is None
        and on_step_state is None
        and reassign_every == 0
        and max_steps > 0
    ):
        # Fully fused path: one dispatch for the whole loop (see
        # _optimize_fused). The host-stepped loop below remains for the
        # observed (-v) and periodic-reassignment modes.
        cap = max(config.max_steps, max_steps)
        state, errs, n = _optimize_fused(
            state, config, refp, max_steps, start_step, cap
        )
        step_errors = [float(e) for e in np.asarray(errs)[: int(n)]]
        for local, err in enumerate(step_errors):
            log.info("step %d error: %f", start_step + local, err)
        return state, step_errors

    key = jax.random.fold_in(jax.random.key(config.seed), start_step)
    step_errors: list[float] = []
    cycle = _stop_cycle(config)
    full_errors: list[float] = []
    gating = refine._gating_active(config)
    need_exact = False  # EXACT confirmation state, see _optimize_fused

    for local in range(max_steps):
        step = start_step + local
        is_random = _is_random_step(config, step)
        step_key = None
        if not config.nes and (
            is_random or config.channel_explore > 0
        ):
            key, step_key = jax.random.split(key)

        if on_slot is None:
            # Fast path: the whole step runs as ONE jitted fori_loop over
            # all slots (no per-slot host round-trips).
            is_win = _is_window_step(config, step)
            this_exact = gating and need_exact and not is_win
            if config.nes:
                res = sweep_nes(state, config, refp)
            elif is_random:
                res = sweep_random(
                    state, config, refp, step_key,
                    use_gate=not this_exact if gating else None,
                )
            else:
                res = sweep_channel(
                    state, config, refp, key=step_key, window=is_win,
                    use_gate=not this_exact if gating else None,
                )
            state = res.state
            err = float(res.error)
        else:
            # Observed path: one dispatch per slot visit so the callback
            # sees every slot (reference logging granularity,
            # src/lib.rs:906-915). Key-split order matches the fast path
            # (same visits, same candidate draws); states can diverge on
            # f32 near-ties because the sweep and the slot functions are
            # separate XLA compilations — see tests/test_refine.py.
            err = float("inf")
            for visit in _step_visits(config, step):
                if visit.method == "nes":
                    res = refine_slot_nes(
                        state, config, refp, visit.palette, visit.index
                    )
                elif visit.method == "random":
                    step_key, sub = jax.random.split(step_key)
                    res = refine_slot_random(
                        state, config, refp, sub, visit.palette, visit.index
                    )
                else:
                    sub = None
                    if config.channel_explore > 0:
                        step_key, sub = jax.random.split(step_key)
                    res = refine_slot_channel(
                        state, config, refp, visit.palette, visit.index,
                        visit.channel, key=sub,
                        window=_is_window_step(config, step),
                    )
                state = res.state
                err = float(res.error)
                on_slot(visit, err)

        step_errors.append(err)
        log.info("step %d error: %f", step, err)
        if on_step is not None:
            on_step(step, state, step_errors)
        if on_step_state is not None:
            replacement = on_step_state(step, state, step_errors)
            if replacement is not None:
                state = replacement
                # The state changed OUTSIDE the descent (a mid-run tile
                # reassignment typically worsens the metric before it
                # pays off): restart the plateau window and the gating
                # confirmation state so the edit gets re-optimized
                # instead of tripping an immediate converge_tol stop.
                full_errors.clear()
                need_exact = False
        if config.converge_tol > 0:
            # full_errors feeds only the plateau test below; with tol=0
            # the exact per-step frame error would be a pure waste (one
            # full SSIMULACRA2 + a host sync per step on this path).
            full_errors.append(float(error_of(state, config, refp)))
        starved = (
            config.converge_tol > 0
            and len(full_errors) > cycle
            and full_errors[-1 - cycle] - full_errors[-1] < config.converge_tol
            and not _is_window_step(config, step)
        )
        if gating and on_slot is None:
            # EXACT confirmation before any stop (see _optimize_fused):
            # a starved GATED sweep forces the next EXHAUSTIVE sweep
            # ungated; only an exact sweep's sub-tol improvement stops
            # the run. (The observed per-slot path never gates, so its
            # stop is already exact.)
            this_exact = need_exact and not _is_window_step(config, step)
            if starved and this_exact:
                break
            need_exact = (
                need_exact and _is_window_step(config, step)
            ) or (starved and not this_exact)
        elif starved:
            break

        # Extension (the reference wishes for this, TODO.md:36-37):
        # periodically re-fit tile->subpalette assignments to the evolved
        # palettes, then remap.
        if reassign_every > 0 and (local + 1) % reassign_every == 0:
            from snesimage.core.reassign import auto_reassign_tiles

            state = full_remap(auto_reassign_tiles(state, config), config)
            log.info("step %d: tiles reassigned", step)
            # Same rationale as the on_step_state replacement above.
            full_errors.clear()
            need_exact = False

    return state, step_errors


def run(
    source_rgba: np.ndarray,
    config: QuantConfig,
) -> tuple[QuantState, list[float], dict]:
    """Full pipeline: init -> cluster -> optimize. Returns the final state,
    the per-step error history, and timing info."""
    t0 = time.perf_counter()
    state = new_state(source_rgba, config)
    state = initialize(state, config)
    state = cluster(state, config)
    jax.block_until_ready(state.palette_map)
    t_init = time.perf_counter() - t0

    refp = make_reference_pyramid(state)
    t1 = time.perf_counter()
    state, errors = optimize(state, config, refp=refp)
    jax.block_until_ready(state.palette_map)
    t_opt = time.perf_counter() - t1

    final_error = float(error_of(state, config, refp))
    return state, errors, {
        "init_seconds": t_init,
        "optimize_seconds": t_opt,
        "final_error": final_error,
    }
