"""Run configuration.

Mirrors the reference CLI surface (reference: src/config.rs:3-31) — two
positional filenames plus `-c/--subpalette-count` (default 1),
`-s/--subpalette-size` (default 7), `-d/--dither`, `--perceptual-palettes`,
`--nes` — and adds framework extensions the reference lacks (explicit
stopping criteria, seeds, checkpointing; the reference optimizes forever,
README.md:52-54, and has no resume path, TODO.md:38-39).

The config is a frozen (hashable) dataclass so it can be a static argument
to jitted functions.
"""

from __future__ import annotations

import dataclasses

from snesimage.constants import RANDOM_TRIALS


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    # Reference-parity knobs (src/config.rs:13-30).
    subpalette_count: int = 1
    subpalette_size: int = 7
    dither: bool = False
    perceptual_palettes: bool = False
    nes: bool = False

    # Geometry. The reference hardcodes 256x256 (src/lib.rs:29-31) and has
    # inconsistent indexing for anything else (src/lib.rs:58, 565); here
    # any multiple-of-8 size works.
    width: int = 256
    height: int = 256

    # Framework extensions (not in the reference).
    seed: int = 0  # jax.random seed for the random candidate search
    max_steps: int = 8  # full sweeps over all slots; reference runs forever
    # Stop early when the exact post-step frame error improves by less
    # than this over one full schedule cycle (1 step for channel/NES
    # schedules, 5 for the reference schedule; core/pipeline.py
    # _stop_cycle). 0 disables early stopping.
    converge_tol: float = 0.0
    random_trials: int = RANDOM_TRIALS  # candidates per random slot visit
    # Candidate prescreening: 0 = score every candidate with the full
    # SSIMULACRA2 (reference behavior); K > 0 = rank candidates with a
    # coarse metric (two finest pyramid scales skipped) and run the full
    # metric only on the top K plus the batch's first entry (the current
    # color for random/channel visits; NES color 0 for the always-replace
    # NES sweep, which then picks the best among the screened set).
    # Measured to preserve the full metric's selections with zero regret;
    # random/channel acceptance stays strict-less-than
    # against the fully-scored current color.
    prescreen: int = 0
    # Second prescreen level (only with prescreen > 0): rank the K
    # finalists by their EXACT scale-1..5 score (the feature block
    # downsamples the full-resolution finalist frames itself; scale 0
    # holds ~4/5 of a finalist's metric pixels) and run scale 0 only for the
    # top `prescreen_full` of them plus the in-batch baseline. 0 = score
    # every finalist fully. Acceptance still compares fully-scored
    # candidates against the fully-scored current color, and a misrank
    # only costs a missed improvement on the strict-less-than paths (NES
    # opts out). Validated across content types: 2 is
    # plateau-identical for red-mean runs; perceptual runs need >= 4
    # (at 2 the scale-1 rank misses up to ~1.2 error of improvements).
    prescreen_full: int = 0
    # Third prescreen level (only with prescreen > 0, undithered): before
    # the quarter-res coarse rank, pre-rank ALL candidates by their EXACT
    # scale-3..5 score from 1/8-res frames (the quarter-res coarse frame
    # pooled 2x2 once more) and run the scale-2 stage — ~75%
    # of the coarse stage's pixels — only for the top `prescreen_pre`
    # (plus the in-batch baseline in legacy mode). Same
    # missed-improvement-only safety argument as the other levels;
    # selection-perfection validated in tests/test_refine.py. Must exceed
    # `prescreen` when set; 0 = two-level cascade (every candidate runs
    # the full coarse stage).
    prescreen_pre: int = 0
    # Step schedule: "reference" = the reference's 4-random-then-1-channel
    # cycle (src/lib.rs:890); "channel" = pure exhaustive channel sweeps
    # (coordinate descent) — measured to converge several times faster
    # than the reference schedule; without `channel_explore` it can stop
    # in a coordinate-descent local minimum a few error points above the
    # reference schedule's plateau. NES mode always
    # uses NES sweeps regardless.
    schedule: str = "reference"
    # Channel-descent exploration (extension, only with
    # schedule="channel"): append this many uniform-random full-RGB
    # candidates to every channel visit's 32-value sweep. The joint moves
    # let coordinate descent escape single-channel (Voronoi) equilibria
    # the reference schedule escapes with its random steps, at a fraction
    # of their cost — acceptance stays strict-less-than, so per-visit
    # quality can only improve. 0 keeps the channel schedule
    # deterministic.
    channel_explore: int = 0
    # Windowed channel descent (extension, only with schedule="channel"):
    # after `channel_window_warmup` exhaustive sweeps, most sweeps
    # restrict each visit to the 2*channel_window values nearest the
    # current one (clamped to [0, 31]) instead of all 32 — the coarse
    # prescreen stage scales
    # with the candidate count. Every `channel_window_period`-th
    # post-warmup sweep stays exhaustive, preserving the large-jump
    # escapes that pure windowing catastrophically loses on few-color
    # content (+50 error on flat poster art), and the
    # convergence test fires only on exhaustive sweeps. 0 = every sweep
    # exhaustive (reference-faithful candidate coverage).
    channel_window: int = 0
    channel_window_period: int = 3
    channel_window_warmup: int = 2
    # Rank1 visit gating (extension, only effective with prescreen > 0
    # AND prescreen_full > 0 on the undithered strict-less-than
    # random/channel paths): skip a visit's exact scale-0 stage unless
    # its best finalist's PREDICTED full error — the carried scale-0
    # weighted-feature term of the current state plus the finalist's
    # exact scale-1..5 score, i.e. exact up to the candidate's own
    # scale-0 feature delta — beats the carried exact error by more
    # than this margin (in real error units). Late sweeps are almost
    # all-reject, so this skips most of their finest-scale cost. A
    # SMALLER margin is safer (0 disables gating); the only possible
    # harm is a missed improvement whose gain lives almost entirely in
    # the finest scale — acceptance itself always compares fully-scored
    # candidates, so a regression is impossible.
    gate_margin: float = 0.0
    # Dither proxy prescreen (extension, round 4; dithered runs only):
    # rank a dithered visit's candidates by their EXACT undithered
    # coarse-scale score (scales 2..5 — FS dither noise pools out
    # there) and run the wavefront remap + exact dithered scoring only
    # for the top K (0 = off, all candidates dithered). Same
    # missed-improvement-only safety as --prescreen (acceptance
    # compares exactly scored dithered candidates, the NES sweep opts
    # out, the legacy baseline row is always scored). Its speed is not
    # measured on the H100; its weak undithered rank was measured to
    # perturb the descent in both directions (poster +46 error at
    # K=12). Experimental only.
    dither_proxy: int = 0
    # Coarse gate (extension, round 4; only with gate_margin > 0): add a
    # FIRST gate at the coarse stage — predict each visit's best possible
    # full error from the coarse candidates' exact scale-2..5 sums plus
    # the carried scale-0 AND scale-1 terms of the current state, and
    # skip the entire finalist pipeline (frame build + scale-1 rank +
    # scale-0) when nothing is predicted to improve by more than
    # gate_margin. Strictly larger blind spot than the rank1 gate
    # (candidate scale-0 AND scale-1 deltas are invisible), strictly
    # larger skip (~all non-coarse work of a reject visit); acceptance
    # and the EXACT-confirmation stop rule are unchanged.
    gate_coarse: bool = False
    # Exact accept threshold (extension, all strict-less-than paths —
    # random and channel visits, any schedule, prescreened or not; NES
    # keeps its always-replace semantics): accept a candidate only if it
    # improves the exact error by MORE than this. 0 = the reference's
    # plain strict-less-than rule. Unlike gate_margin it never skips
    # scoring work — a pure acceptance knob. Measured: weaker than the gate's prediction-based filter at equal thresholds
    # (it also rejects genuine multi-scale progress); 0.005 was mildly
    # beneficial, 0.01 mixed. Prefer gate_margin where prescreening is
    # on; this knob exists for no-prescreen schedules.
    accept_margin: float = 0.0

    def __post_init__(self):
        if self.width % 8 or self.height % 8:
            raise ValueError("width and height must be multiples of 8")
        if not 1 <= self.subpalette_count <= 16:
            raise ValueError("subpalette_count must be in [1, 16]")
        if not 1 <= self.subpalette_size <= 15:
            raise ValueError("subpalette_size must be in [1, 15]")
        if self.schedule not in ("reference", "channel"):
            raise ValueError("schedule must be 'reference' or 'channel'")
        if self.prescreen_full < 0:
            raise ValueError("prescreen_full must be >= 0")
        if self.prescreen_pre < 0:
            raise ValueError("prescreen_pre must be >= 0")
        if self.prescreen_pre and self.prescreen_pre <= self.prescreen:
            # The 1/8-res pre-rank must keep MORE candidates than the
            # quarter-res rank selects, or the cascade degenerates (and
            # the legacy in-batch-baseline mode needs one spare row).
            raise ValueError("prescreen_pre must be > prescreen when set")
        if self.channel_explore < 0:
            raise ValueError("channel_explore must be >= 0")
        if self.gate_margin < 0:
            raise ValueError("gate_margin must be >= 0")
        if self.gate_coarse and self.gate_margin == 0:
            raise ValueError("gate_coarse requires gate_margin > 0")
        if self.dither_proxy < 0:
            raise ValueError("dither_proxy must be >= 0")
        if self.accept_margin < 0:
            raise ValueError("accept_margin must be >= 0")
        if not 0 <= self.channel_window <= 15:
            raise ValueError("channel_window must be in [0, 15]")
        if self.channel_window and self.channel_window_period < 2:
            raise ValueError("channel_window_period must be >= 2")
        if self.channel_window and self.channel_window_warmup < 1:
            # The first sweep must be exhaustive: initial palettes are
            # k-means means, often far from their slot's optimum.
            raise ValueError("channel_window_warmup must be >= 1")
        if self.perceptual_palettes and 0 < self.prescreen_full < 4:
            # Measured: the scale-1 finalist rank under
            # CIEDE2000 misses up to ~1.2 error of improvements at
            # prescreen_full < 4. Auto-bump instead of erroring so preset
            # configs tuned for red-mean stay usable in perceptual mode.
            import logging

            logging.getLogger("snesimage").warning(
                "perceptual_palettes with prescreen_full=%d loses quality; "
                "bumping prescreen_full to 4",
                self.prescreen_full,
            )
            object.__setattr__(self, "prescreen_full", 4)
        if self.gate_margin > 0 and self.channel_window > 0:
            # Measured: the two mechanisms fight — windowed sweeps starve
            # the gate's carried-error updates, convergence stretches to
            # 11-12 steps vs 7-8 for either alone. Keep the
            # gate (the stronger, quality-validated win) and disable the
            # window. Warn-and-disable instead of erroring so tuned
            # configs stay usable.
            import logging

            logging.getLogger("snesimage").warning(
                "gate_margin=%g with channel_window=%d stacks to more "
                "steps (11-12 vs 7-8); disabling the window",
                self.gate_margin,
                self.channel_window,
            )
            object.__setattr__(self, "channel_window", 0)
        if self.gate_margin > 0 and (
            self.channel_explore > 0 or 0 < self.converge_tol < 0.25
        ):
            # (converge_tol == 0 disables the plateau test entirely —
            # a fixed step budget — and is not a deep-quality run.)
            # Measured: the gate's
            # scale-1..5 prediction blocks the small/scale-0-heavy
            # improvements that deep quality runs (tight tol,
            # channel-explore joint-RGB jumps) live on — plateaus fire
            # 2x early, losing up to ~8 error. Warn-and-disable instead
            # of erroring so speed-tuned configs stay usable.
            import logging

            logging.getLogger("snesimage").warning(
                "gate_margin=%g with %s loses quality (premature "
                "plateau); disabling the gate",
                self.gate_margin,
                "channel_explore" if self.channel_explore > 0
                else f"converge_tol={self.converge_tol}",
            )
            object.__setattr__(self, "gate_margin", 0.0)
            object.__setattr__(self, "gate_coarse", False)
        if self.gate_coarse:
            # Measured quality LOSS: worse finals AND more steps on every content at margin
            # 0.01, structurally (scales 0+1 carry most of the score).
            # Warn-only — the knob ships for experimentation, not tuning.
            import logging

            logging.getLogger("snesimage").warning(
                "gate_coarse is a measured quality loss on every content; "
                "experimental only — it is in no tuned profile"
            )
        if self.prescreen_pre:
            # Measured NOT equal-or-better: fewer pixels per sweep but a
            # perturbed descent path (gradient content converges in more
            # steps). Warn-only.
            import logging

            logging.getLogger("snesimage").warning(
                "prescreen_pre gives cheaper sweeps but a perturbed "
                "descent path that needs more steps on some content; "
                "experimental only — it is in no tuned profile"
            )
        if self.dither_proxy:
            # Its weak undithered rank perturbs the descent both ways;
            # its speed is not measured on the H100. Warn-only.
            import logging

            logging.getLogger("snesimage").warning(
                "dither_proxy perturbs the descent path in both "
                "directions; experimental only — it is in no tuned "
                "profile"
            )

    @property
    def width_tiles(self) -> int:
        return self.width // 8

    @property
    def height_tiles(self) -> int:
        return self.height // 8

    @property
    def num_tiles(self) -> int:
        return self.width_tiles * self.height_tiles
