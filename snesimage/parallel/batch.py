"""Multi-image batching and multi-chip scale-out.

The reference is strictly single-image, single-threaded (SURVEY.md §2.5).
The scale-out axis here is the *image batch*: every stage of the
pipeline (k-means init, remap, candidate evaluation, SSIMULACRA2) is
vmapped over a leading batch axis and sharded over a 1-D device mesh with
`jax.sharding` — images are embarrassingly parallel, so XLA partitions the
whole step with zero communication, and the only collective is a `psum`
for the aggregate error metric (used for logging/convergence). This covers
BASELINE.json config 5 ("batched 256-image run").

Scheduling note: all images in a batch share the slot schedule (same
(subpalette, entry) visited together with per-image RNG keys and per-image
accept decisions), which keeps the computation SPMD across the mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from snesimage.config import QuantConfig
from snesimage.core import pipeline, refine
from snesimage.core.init import assign_tiles, recalculate_palettes
from snesimage.core.state import QuantState

BATCH_AXIS = "batch"


def make_mesh(devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (BATCH_AXIS,))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(BATCH_AXIS))


def make_batched_states(images: np.ndarray, config: QuantConfig) -> QuantState:
    """Stack B images into one batched state pytree (leading batch axis)."""
    images = jnp.asarray(images, dtype=jnp.uint8)
    b = images.shape[0]
    return QuantState(
        original=images,
        tile_palettes=jnp.zeros(
            (b, config.height_tiles, config.width_tiles), jnp.int32
        ),
        palette=jnp.zeros(
            (b, config.subpalette_count, config.subpalette_size, 3), jnp.int32
        ),
        palette_map=jnp.zeros((b, config.height, config.width), jnp.int32),
    )


def shard_states(states: QuantState, mesh: Mesh) -> QuantState:
    """Place the batched state on the mesh, batch axis sharded."""
    sh = batch_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sh), states)


# Batched versions of the pipeline stages: vmap over the state, config
# static. jit(vmap(...)) lets XLA partition over the sharded batch axis.


@partial(jax.jit, static_argnames=("config",))
def binit(states: QuantState, config: QuantConfig) -> QuantState:
    if config.subpalette_count == 1:
        states = jax.vmap(lambda s: recalculate_palettes(s, config))(states)
    else:
        states = jax.vmap(lambda s: assign_tiles(s, config))(states)
    return jax.vmap(lambda s: refine.full_remap(s, config))(states)


@partial(jax.jit, static_argnames=("config",))
def bcluster(states: QuantState, config: QuantConfig) -> QuantState:
    states = jax.vmap(lambda s: recalculate_palettes(s, config))(states)
    return jax.vmap(lambda s: refine.full_remap(s, config))(states)


@partial(jax.jit, static_argnames=("config",))
def brefp(states: QuantState, config: QuantConfig):
    return jax.vmap(refine.make_reference_pyramid)(states)


@partial(jax.jit, static_argnames=("config",))
def bslot_random(states, config: QuantConfig, refp, keys, p, i):
    return jax.vmap(
        lambda s, r, k: refine.refine_slot_random(s, config, r, k, p, i)
    )(states, refp, keys)


@partial(jax.jit, static_argnames=("config",))
def bslot_channel(states, config: QuantConfig, refp, p, i, ch):
    return jax.vmap(
        lambda s, r: refine.refine_slot_channel(s, config, r, p, i, ch)
    )(states, refp)


@partial(jax.jit, static_argnames=("config",))
def bslot_nes(states, config: QuantConfig, refp, p, i):
    return jax.vmap(lambda s, r: refine.refine_slot_nes(s, config, r, p, i))(
        states, refp
    )


def _plateau_stop(errs, local, mean, cycle, tol, config: QuantConfig):
    """Shared converge_tol rule of the two fused batch loops: stop when
    the aggregate error improved by less than `tol` over one full
    schedule cycle (inf sentinel before a full cycle exists; never fires
    on a windowed sweep). Sound ONLY because every batched/portfolio
    sweep scores exactly (gate=False everywhere — see the note
    below): a gated sweep's sub-tol improvement can mean visits were
    skipped, not that the run converged, which is why the single-image
    loop needs its exact-confirmation pass and these loops don't."""
    prev = jnp.where(local >= cycle, errs[local - cycle], jnp.inf)
    return (prev - mean < tol) & ~pipeline._is_window_step(config, local)


# The batched paths pass gate=False everywhere (the portfolio loop
# too): under vmap the gate's lax.cond lowers to a select that computes
# both branches, so there is no speed win — only the content-dependent
# quality risk of skipped visits (and these loops have no
# exact-confirmation stop; see _plateau_stop). Batched sweeps therefore
# always score exactly.
@partial(jax.jit, static_argnames=("config",))
def bsweep_random(states, config: QuantConfig, refp, keys):
    """One full random step for every image, fully on-device."""
    return jax.vmap(lambda s, r, k: refine.sweep_random(s, config, r, k, gate=False))(
        states, refp, keys
    )


@partial(jax.jit, static_argnames=("config",))
def bsweep_channel(states, config: QuantConfig, refp):
    return jax.vmap(lambda s, r: refine.sweep_channel(s, config, r, gate=False))(states, refp)


@partial(jax.jit, static_argnames=("config",))
def bsweep_nes(states, config: QuantConfig, refp):
    return jax.vmap(lambda s, r: refine.sweep_nes(s, config, r))(states, refp)


@partial(jax.jit, static_argnames=("config",))
def bmean_error(states, config: QuantConfig, refp) -> jax.Array:
    """Mean error across the (sharded) batch — the one cross-image
    reduction; XLA lowers it to an all-reduce over the mesh."""
    errs = jax.vmap(lambda s, r: refine.error_of(s, config, r))(states, refp)
    return jnp.mean(errs)


@partial(jax.jit, static_argnames=("config", "cap", "n_real"))
def _boptimize_fused(
    config: QuantConfig, refp, stop_at, cap: int, n_real: int, carry
):
    """Scheduler steps [0, stop_at) for the whole batch as ONE XLA
    program (one host sync per run instead of one per step).
    Mirrors the schedule and RNG stream of the single-image fused
    loop: a while_loop over steps with the schedule as lax.cond, so one
    compilation serves ANY step budget up to the static buffer bound
    `cap` (the previous Python unroll recompiled per distinct max_steps
    and grew the program linearly).

    `carry` = (states, key, cur, errs, stop): the images, the RNG key,
    the per-image current errors, the per-step error buffer and the stop
    flag.

    `n_real`: the number of genuine images at the front of the batch —
    callers pad to a multiple of the mesh size with replicas, and those
    replicas must not bias the logged/convergence-tested mean error. The
    per-step error history is the mean over the first `n_real` images only.

    With `config.converge_tol > 0`, stops early when the real-mean exact
    error improves by less than tol over one full schedule cycle
    (pipeline._stop_cycle; same rule as the single-image fused loop, on
    the batch mean). Batched sweeps always score exactly (gate=False
    everywhere — see the note above bsweep_random), so no gated
    exact-confirmation pass is needed before stopping. The test never
    fires on a windowed sweep.

    With `config.channel_explore > 0`, channel sweeps draw per-image
    explore keys (split-per-step, then per image — same discipline as the
    random sweeps' key stream)."""
    from snesimage.constants import RANDOM_STEPS_PER_CYCLE, SCHEDULE_CYCLE

    b = jax.tree.leaves(carry[0])[0].shape[0]
    stop_at = jnp.minimum(jnp.int32(stop_at), cap)
    # Real-image weights: mean over the first n_real entries only.
    w = (jnp.arange(b) < n_real).astype(jnp.float32) / jnp.float32(n_real)
    cycle = pipeline._stop_cycle(config)
    tol = jnp.float32(config.converge_tol)
    explore = config.channel_explore > 0

    def step_fn(states, key, step, cur):
        if config.nes:
            res = jax.vmap(
                lambda s, r, e: refine.sweep_nes(s, config, r, e)
            )(states, refp, cur)
            return res.state, res.error, key
        if config.schedule == "channel":
            keys = None
            if explore:
                key, sub = jax.random.split(key)
                keys = jax.random.split(sub, b)

            def bchan(operand, window=False):
                states, cur, keys = operand
                if explore:
                    res = jax.vmap(
                        lambda s, r, e, k: refine.sweep_channel(
                            s, config, r, e, key=k, window=window,
                            gate=False,
                        )
                    )(states, refp, cur, keys)
                else:
                    res = jax.vmap(
                        lambda s, r, e: refine.sweep_channel(
                            s, config, r, e, window=window, gate=False
                        )
                    )(states, refp, cur)
                return res.state, res.error

            if pipeline._windowing_active(config):
                st, err = jax.lax.cond(
                    pipeline._is_window_step(config, step),
                    partial(bchan, window=True),
                    bchan,
                    (states, cur, keys),
                )
            else:
                st, err = bchan((states, cur, keys))
            return st, err, key

        def do_random(operand):
            states, key, cur = operand
            key, sub = jax.random.split(key)
            keys = jax.random.split(sub, b)
            res = jax.vmap(
                lambda s, r, k, e: refine.sweep_random(s, config, r, k, e, gate=False)
            )(states, refp, keys, cur)
            return res.state, res.error, key

        def do_channel(operand):
            states, key, cur = operand
            if explore:
                key, sub = jax.random.split(key)
                keys = jax.random.split(sub, b)
                res = jax.vmap(
                    lambda s, r, k, e: refine.sweep_channel(
                        s, config, r, e, key=k, gate=False
                    )
                )(states, refp, keys, cur)
            else:
                res = jax.vmap(
                    lambda s, r, e: refine.sweep_channel(s, config, r, e, gate=False)
                )(states, refp, cur)
            return res.state, res.error, key

        return jax.lax.cond(
            step % SCHEDULE_CYCLE < RANDOM_STEPS_PER_CYCLE,
            do_random,
            do_channel,
            (states, key, cur),
        )

    def cond(c):
        _, _, local, _, _, stop = c
        return (local < stop_at) & ~stop

    def body(c):
        states, key, local, cur, errs, stop = c
        states, err, key = step_fn(states, key, local, cur)
        mean = jnp.sum(err * w)  # sharded batch: XLA lowers to an all-reduce
        errs = errs.at[local].set(mean)
        if config.converge_tol > 0:
            stop = _plateau_stop(errs, local, mean, cycle, tol, config)
        return states, key, local + 1, err, errs, stop

    states0, key0, cur0, errs0, stop0 = carry
    init = (states0, key0, jnp.int32(0), cur0, errs0, stop0)
    states, key, n, cur, errs, stop = jax.lax.while_loop(cond, body, init)
    return (states, key, cur, errs, stop), n


def batched_optimize(
    states: QuantState,
    config: QuantConfig,
    *,
    mesh: Mesh | None = None,
    max_steps: int | None = None,
    n_real: int | None = None,
) -> tuple[QuantState, list[float]]:
    """Run the full scheduler over a batch of images in SPMD lockstep,
    as one dispatch with one host sync.

    `n_real`: genuine images at the front of the batch (the rest being
    mesh-padding replicas, excluded from the reported/convergence-tested
    mean error); None = the whole batch is real."""
    if mesh is not None:
        states = shard_states(states, mesh)
    if max_steps is None:
        max_steps = config.max_steps
    b = int(jax.tree.leaves(states)[0].shape[0])
    if n_real is None:
        n_real = b

    refp = brefp(states, config)
    cap = max(config.max_steps, max_steps)
    # Exact per-image errors carried across sweeps (refine._pick): each
    # visit compares candidates against the carried value instead of
    # re-scoring the current color in-batch.
    cur0 = jax.vmap(
        lambda s, r: refine.frame_error_fused(s, config, r)
    )(states, refp)
    carry = (
        states, jax.random.key(config.seed), cur0,
        jnp.full((cap,), jnp.nan, jnp.float32), jnp.bool_(False),
    )
    (states, _, _, errs, _), n = _boptimize_fused(
        config, refp, jnp.int32(max_steps), cap, n_real, carry
    )
    errs, done = jax.device_get((errs, n))  # the run's one host sync
    return states, [float(e) for e in errs[:done]]


def batched_run(
    images: np.ndarray,
    config: QuantConfig,
    *,
    mesh: Mesh | None = None,
    max_steps: int | None = None,
    n_real: int | None = None,
) -> tuple[QuantState, list[float]]:
    """init -> cluster -> optimize for a batch of images."""
    states = make_batched_states(images, config)
    if mesh is not None:
        states = shard_states(states, mesh)
    states = binit(states, config)
    states = bcluster(states, config)
    # Re-applying the same sharding in batched_optimize is a no-op.
    return batched_optimize(
        states, config, mesh=mesh, max_steps=max_steps, n_real=n_real
    )


@partial(jax.jit, static_argnames=("config", "k", "cap"))
def _portfolio_fused(state: QuantState, config: QuantConfig, refp, k: int,
                     start, stop_at, cap: int, carry):
    """K seed trajectories of ONE shared image as one XLA program.

    Runs steps [start, stop_at) from `carry` = (per-seed palettes,
    per-seed palette maps, RNG key, per-seed current errors, seed-mean
    error history, stop flag) and returns the advanced carry.
    portfolio_run starts at 0; tools/race_exp.py resumes a survivor at
    step r with the carry of a K-seed run.

    With `config.converge_tol > 0`, stops early when the SEED-MEAN error
    improves by less than tol over one full schedule cycle — the same
    rule as _boptimize_fused applies over the batch mean.

    The image-derived fields (`original`, `tile_palettes` — deterministic
    init, identical across seeds) stay UNBATCHED: only the per-seed
    palette and palette map carry the vmap axis, and the shared fields
    enter each vmapped sweep via closure, so the image-derived
    precomputation is shared and the dithered wavefront scan is vmapped
    over seeds x candidates. Schedule and RNG stream
    mirror _boptimize_fused exactly (same per-seed keys), so trajectories
    match the image-batched portfolio up to f32 reassociation."""
    from snesimage.constants import RANDOM_STEPS_PER_CYCLE, SCHEDULE_CYCLE

    stop_at = jnp.minimum(jnp.int32(stop_at), cap)
    cycle = pipeline._stop_cycle(config)
    tol = jnp.float32(config.converge_tol)
    shared = state

    def seed_state(pal, pm):
        return QuantState(shared.original, shared.tile_palettes, pal, pm)

    def step_fn(pals, pms, key, step, cur):
        def unpack(res):
            return res.state.palette, res.state.palette_map, res.error

        if config.nes:
            res = jax.vmap(
                lambda pal, pm, e: refine.sweep_nes(
                    seed_state(pal, pm), config, refp, e
                )
            )(pals, pms, cur)
            return unpack(res) + (key,)
        if config.schedule == "channel":
            # channel_explore draws PER-SEED keys (split-per-step, then
            # per seed — the same discipline as _boptimize_fused; without
            # this, sweep_channel's key=None silently disables explore
            # and all K trajectories collapse into one).
            explore = config.channel_explore > 0
            keys = None
            if explore:
                key, sub = jax.random.split(key)
                keys = jax.random.split(sub, k)

            def kchan(operand, window=False):
                pals, pms, cur, keys = operand
                if explore:
                    res = jax.vmap(
                        lambda pal, pm, e, kk: refine.sweep_channel(
                            seed_state(pal, pm), config, refp, e, key=kk,
                            window=window, gate=False,
                        )
                    )(pals, pms, cur, keys)
                else:
                    res = jax.vmap(
                        lambda pal, pm, e: refine.sweep_channel(
                            seed_state(pal, pm), config, refp, e,
                            window=window, gate=False,
                        )
                    )(pals, pms, cur)
                return unpack(res)

            if pipeline._windowing_active(config):
                out = jax.lax.cond(
                    pipeline._is_window_step(config, step),
                    partial(kchan, window=True),
                    kchan,
                    (pals, pms, cur, keys),
                )
            else:
                out = kchan((pals, pms, cur, keys))
            return out + (key,)

        def do_random(operand):
            pals, pms, key, cur = operand
            key, sub = jax.random.split(key)
            keys = jax.random.split(sub, k)
            res = jax.vmap(
                lambda pal, pm, kk, e: refine.sweep_random(
                    seed_state(pal, pm), config, refp, kk, e,
                    gate=False,
                )
            )(pals, pms, keys, cur)
            return unpack(res) + (key,)

        def do_channel(operand):
            pals, pms, key, cur = operand
            if config.channel_explore > 0:
                key, sub = jax.random.split(key)
                keys = jax.random.split(sub, k)
                res = jax.vmap(
                    lambda pal, pm, e, kk: refine.sweep_channel(
                        seed_state(pal, pm), config, refp, e, key=kk,
                        gate=False,
                    )
                )(pals, pms, cur, keys)
            else:
                res = jax.vmap(
                    lambda pal, pm, e: refine.sweep_channel(
                        seed_state(pal, pm), config, refp, e,
                        gate=False,
                    )
                )(pals, pms, cur)
            return unpack(res) + (key,)

        return jax.lax.cond(
            step % SCHEDULE_CYCLE < RANDOM_STEPS_PER_CYCLE,
            do_random,
            do_channel,
            (pals, pms, key, cur),
        )

    def cond(c):
        local, stop = c[3], c[6]
        return (local < stop_at) & ~stop

    def body(c):
        pals, pms, key, local, cur, errs, stop = c
        pals, pms, cur, key = step_fn(pals, pms, key, local, cur)
        mean = jnp.mean(cur)
        errs = errs.at[local].set(mean)
        if config.converge_tol > 0:
            stop = _plateau_stop(errs, local, mean, cycle, tol, config)
        return pals, pms, key, local + 1, cur, errs, stop

    pals0, pms0, key0, cur0, errs0, stop0 = carry
    init = (pals0, pms0, key0, jnp.int32(start), cur0, errs0, stop0)
    pals, pms, key, n, cur, errs, stop = jax.lax.while_loop(cond, body, init)
    return (pals, pms, key, cur, errs, stop), n


def portfolio_seeds_degenerate(config: QuantConfig) -> bool:
    """True when a K-seed portfolio of this config runs K IDENTICAL
    trajectories: the per-seed RNG streams only matter to random visits
    and to channel-explore draws, so the NES sweep (always-replace,
    deterministic) and the plain channel schedule (deterministic
    coordinate descent, explore off) have nothing for the seeds to
    diverge on — `--portfolio K` would just multiply cost by K."""
    return bool(config.nes) or (
        config.schedule == "channel" and config.channel_explore == 0
    )


def portfolio_run(
    image: np.ndarray,
    config: QuantConfig,
    k: int,
    *,
    mesh: Mesh | None = None,
    max_steps: int | None = None,
) -> tuple[QuantState, np.ndarray, list[float]]:
    """Seed portfolio (extension): optimize K trajectories of ONE image —
    identical schedule, independent RNG streams — and keep the best.

    The reference runs a single OS-seeded trajectory (src/lib.rs:201);
    random-schedule dithered outcomes vary several error points across
    seeds. On one device the K seeds share the image and vmap the sweeps
    over per-seed palettes (_portfolio_fused). With a mesh the K copies
    shard as an image batch instead. Either way the run is one dispatch
    with one host sync.

    Returns (best state (unbatched), per-seed final errors, per-step
    seed-mean error history).
    """
    if k > 1 and portfolio_seeds_degenerate(config):
        import logging

        logging.getLogger("snesimage").warning(
            "portfolio K=%d on a deterministic schedule (%s%s): the K "
            "trajectories are identical — use the reference/random "
            "schedule or --channel-explore to make seeds diverge",
            k, config.schedule,
            ", explore off" if config.schedule == "channel" else "",
        )
    if mesh is not None:
        images = np.ascontiguousarray(
            np.broadcast_to(image[None], (k,) + image.shape)
        )
        states = make_batched_states(images, config)
        states = shard_states(states, mesh)
        states = binit(states, config)
        states = bcluster(states, config)
        refp = brefp(states, config)
        states, step_errors = batched_optimize(
            states, config, mesh=None, max_steps=max_steps
        )
        errs = jax.vmap(lambda s, r: refine.error_of(s, config, r))(
            states, refp
        )
        errs = np.asarray(errs)
        best = int(errs.argmin())
        best_state = jax.tree.map(lambda x: x[best], states)
        return best_state, errs, step_errors

    # One device: the K seeds share the image.
    from snesimage.core.state import new_state

    state = new_state(image, config)
    if config.subpalette_count == 1:
        state = recalculate_palettes(state, config)
    else:
        state = assign_tiles(state, config)
    state = refine.full_remap(state, config)
    state = recalculate_palettes(state, config)
    state = refine.full_remap(state, config)
    refp = refine.make_reference_pyramid(state)
    if max_steps is None:
        max_steps = config.max_steps
    cap = max(config.max_steps, max_steps, 1)
    bc = lambda x: jnp.broadcast_to(x[None], (k,) + x.shape)
    cur0 = refine.frame_error_fused(state, config, refp)
    carry = (
        bc(state.palette), bc(state.palette_map),
        jax.random.key(config.seed), jnp.broadcast_to(cur0, (k,)),
        jnp.full((cap,), jnp.nan, jnp.float32), jnp.bool_(False),
    )
    (pals, pms, _, cur, errs, _), n = _portfolio_fused(
        state, config, refp, k, jnp.int32(0), jnp.int32(max_steps), cap, carry
    )
    errs, done, seed_errs = jax.device_get((errs, n, cur))  # one host sync
    step_errors = [float(e) for e in errs[:done]]
    best = int(seed_errs.argmin())
    best_state = QuantState(
        state.original, state.tile_palettes, pals[best], pms[best]
    )
    return best_state, seed_errs, step_errors
