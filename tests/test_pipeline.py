"""End-to-end pipeline, scheduler-order, checkpoint, JSON and preview
tests."""

import json

import numpy as np
import jax.numpy as jnp
import pytest

from snesimage.config import QuantConfig
from snesimage.core import pipeline
from snesimage.core.refine import error_of, make_reference_pyramid
from snesimage.core.state import new_state
from snesimage.io.checkpoint import load_checkpoint, save_checkpoint
from snesimage.io.json_out import state_to_json, state_to_json_obj


def _cfg(**kw):
    base = dict(subpalette_count=2, subpalette_size=4, width=64, height=64,
                max_steps=1)
    base.update(kw)
    return QuantConfig(**base)


def test_schedule_matches_reference_order():
    """Scheduler parity with src/lib.rs:888-932: 4 random steps then one
    channel step with 3 channel visits per slot."""
    cfg = _cfg(subpalette_count=2, subpalette_size=2)
    visits = list(pipeline.schedule(cfg, 6))
    per_step = {}
    for v in visits:
        per_step.setdefault(v.step, []).append(v)
    for s in range(5):
        methods = {v.method for v in per_step[s]}
        if s % 5 < 4:
            assert methods == {"random"}
            assert len(per_step[s]) == 4  # C*S slots
        else:
            assert methods == {"channel"}
            assert len(per_step[s]) == 12  # C*S*3 channels
            chans = [v.channel for v in per_step[s][:3]]
            assert chans == [0, 1, 2]
    # slot order: palette-major, then index (src/lib.rs:917-931)
    slots = [(v.palette, v.index) for v in per_step[0]]
    assert slots == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_schedule_nes_mode():
    cfg = _cfg(nes=True)
    visits = list(pipeline.schedule(cfg, 5))
    assert {v.method for v in visits} == {"nes"}


@pytest.mark.slow
def test_channel_schedule_observed_path_matches_fast(small_image):
    """--schedule channel with an on_slot callback must run channel visits
    (regression: _step_visits ignored config.schedule, yielding 'random'
    visits with step_key=None and crashing) and converge equivalently to
    the fast path.

    Not bit-identical: the fast sweep and the per-slot functions are
    separate XLA compilations whose f32 fusion differences can flip
    near-tie candidate selections (see test_refine.py
    test_sweep_matches_per_slot_path); both paths run the same schedule
    and accept only strict improvements, so final errors must agree."""
    cfg = _cfg(schedule="channel", max_steps=1)
    st = new_state(small_image, cfg)
    st = pipeline.initialize(st, cfg)
    st = pipeline.cluster(st, cfg)
    refp = make_reference_pyramid(st)
    start = float(error_of(st, cfg, refp))

    fast_state, fast_errs = pipeline.optimize(st, cfg, refp=refp)
    methods = []
    obs_state, obs_errs = pipeline.optimize(
        st, cfg, refp=refp, on_slot=lambda v, e: methods.append(v.method)
    )
    assert set(methods) == {"channel"}
    e_fast = float(error_of(fast_state, cfg, refp))
    e_obs = float(error_of(obs_state, cfg, refp))
    assert e_fast <= start and e_obs <= start
    # Round-3 strengthening (advisor): near-tie flips move at most a slot
    # or two and ~1e-2 error; schedule bugs move whole error points.
    diff = (
        np.asarray(fast_state.palette) != np.asarray(obs_state.palette)
    ).any(axis=-1).sum()
    assert int(diff) <= 1, int(diff)
    assert abs(e_fast - e_obs) < 0.05, (e_fast, e_obs)
    assert abs(fast_errs[-1] - obs_errs[-1]) < 0.05


@pytest.mark.slow
def test_full_run_improves_error(small_image):
    cfg = _cfg(max_steps=1)
    st = new_state(small_image, cfg)
    st = pipeline.initialize(st, cfg)
    st = pipeline.cluster(st, cfg)
    refp = make_reference_pyramid(st)
    before = float(error_of(st, cfg, refp))
    st2, errors = pipeline.optimize(st, cfg, refp=refp, max_steps=1)
    assert errors[-1] <= before + 1e-4


def test_initialize_assigns_tiles(small_image):
    cfg = _cfg(subpalette_count=3)
    st = new_state(small_image, cfg)
    st = pipeline.initialize(st, cfg)
    tp = np.asarray(st.tile_palettes)
    assert tp.min() >= 0 and tp.max() < 3
    assert len(np.unique(tp)) > 1  # gradient image should use >1 cluster


def test_transparent_tiles_stay_zero(small_image):
    """Fully transparent tiles are excluded from clustering and keep
    subpalette 0 (src/lib.rs:118, SURVEY §2.4)."""
    cfg = _cfg(subpalette_count=3)
    st = new_state(small_image, cfg)
    st = pipeline.initialize(st, cfg)
    tp = np.asarray(st.tile_palettes)
    # tiles (0, 6) and (0, 7) are fully transparent in the fixture
    assert tp[0, 6] == 0 and tp[0, 7] == 0


def test_single_subpalette_skips_tile_clustering(small_image):
    cfg = _cfg(subpalette_count=1)
    st = new_state(small_image, cfg)
    st = pipeline.initialize(st, cfg)
    assert (np.asarray(st.tile_palettes) == 0).all()
    # palette was produced by pixel k-means (non-black)
    assert np.asarray(st.palette).max() > 0


def test_reassign_tile_cycles(small_image):
    cfg = _cfg(subpalette_count=2)
    st = new_state(small_image, cfg)
    st = pipeline.initialize(st, cfg)
    before = int(st.tile_palettes[3, 3])
    st2 = pipeline.reassign_tile(st, cfg, 3, 3, recluster=False)
    assert int(st2.tile_palettes[3, 3]) == (before + 1) % 2


def test_checkpoint_round_trip(small_image, tmp_path):
    cfg = _cfg()
    st = new_state(small_image, cfg)
    st = pipeline.initialize(st, cfg)
    st = pipeline.cluster(st, cfg)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, st, cfg, errors=[1.5, 1.2], step=2)
    st2, cfg2, meta = load_checkpoint(path)
    assert cfg2 == cfg
    assert meta["errors"] == [1.5, 1.2]
    for a, b in zip(st, st2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_json_contract(small_image):
    cfg = _cfg(subpalette_count=2, subpalette_size=4)
    st = new_state(small_image, cfg)
    st = pipeline.initialize(st, cfg)
    st = pipeline.cluster(st, cfg)
    obj = state_to_json_obj(st, cfg)

    # palette: C*16 entries; slot 0 and slots > sub_size are 0
    assert len(obj["palette"]) == 2 * 16
    for pi in range(2):
        block = obj["palette"][pi * 16 : (pi + 1) * 16]
        assert block[0] == 0
        assert all(v == 0 for v in block[5:])
        assert all(0 <= v < 2**15 for v in block)

    # tiles: T x 64, 1-based entries, 0 = transparent
    assert len(obj["tiles"]) == 64
    assert all(len(t) == 64 for t in obj["tiles"])
    flat = [v for t in obj["tiles"] for v in t]
    assert min(flat) >= 0 and max(flat) <= 4
    # transparent tile (tiles index 6 on the first row) is all zero
    assert all(v == 0 for v in obj["tiles"][6])

    assert len(obj["tile_palettes"]) == 64

    # serialization: compact, alphabetical keys like serde_json
    s = state_to_json(st, cfg)
    assert s.startswith('{"palette":[')
    assert '"tile_palettes":' in s and s.index('"tile_palettes"') < s.index('"tiles"')
    assert ": " not in s and ", " not in s
    json.loads(s)  # valid JSON


def test_json_tiles_row_major_within_tile(small_image):
    """Tile pixel order is y-outer, x-inner (src/lib.rs:604-606)."""
    cfg = _cfg()
    st = new_state(small_image, cfg)
    st = pipeline.initialize(st, cfg)
    st = pipeline.cluster(st, cfg)
    obj = state_to_json_obj(st, cfg)
    pm = np.asarray(st.palette_map)
    alpha = np.asarray(st.original[..., 3])
    t = obj["tiles"][9]  # tile (1,1): rows 8..16, cols 8..16
    for y in range(8):
        for x in range(8):
            yy, xx = 8 + y, 8 + x
            want = pm[yy, xx] + 1 if alpha[yy, xx] > 0 else 0
            assert t[y * 8 + x] == want


def test_preview_renders(small_image, tmp_path):
    from snesimage.preview import render_preview, save_preview

    cfg = _cfg()
    st = new_state(small_image, cfg)
    st = pipeline.initialize(st, cfg)
    st = pipeline.cluster(st, cfg)
    img = render_preview(st, cfg)
    assert img.shape == (64, 64 * 2 + 128, 3)
    save_preview(str(tmp_path / "p.png"), st, cfg)
    assert (tmp_path / "p.png").exists()


def test_run_wrapper(small_image):
    cfg = _cfg(max_steps=1)
    st, errors, info = pipeline.run(small_image, cfg)
    assert len(errors) == 1
    assert info["final_error"] == pytest.approx(errors[-1], abs=1e-3)
    assert info["optimize_seconds"] > 0


@pytest.mark.slow
def test_non_square_image(rng):
    """The reference only supports 256x256 (and silently corrupts other
    sizes, src/lib.rs:58,565,838); this build generalizes to any
    multiple-of-8 geometry — including non-square."""
    h, w = 32, 64
    img = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    img[..., 3] = 255
    cfg = QuantConfig(subpalette_count=2, subpalette_size=3, width=w, height=h,
                      max_steps=1)
    st = new_state(img, cfg)
    st = pipeline.initialize(st, cfg)
    st = pipeline.cluster(st, cfg)
    st, errors = pipeline.optimize(st, cfg, max_steps=1)
    assert np.isfinite(errors).all()
    obj = state_to_json_obj(st, cfg)
    assert len(obj["tiles"]) == (h // 8) * (w // 8)
    assert len(obj["tile_palettes"]) == (h // 8) * (w // 8)


def test_non_square_dithered_matches_oracle(rng):
    from snesimage.native import oracle_remap
    from snesimage.ops.dither import remap_dithered

    h, w = 24, 48
    rgba = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    rgba[..., 3] = 255
    tp = rng.integers(0, 2, (h // 8, w // 8)).astype(np.int32)
    pal = rng.integers(0, 32, (2, 4, 3)).astype(np.int32)
    want = oracle_remap(rgba, tp, pal, dither=True, perceptual=False)
    got = np.asarray(
        remap_dithered(
            jnp.asarray(rgba[..., :3]), jnp.asarray(rgba[..., 3]),
            jnp.asarray(tp), jnp.asarray(pal), False,
        )
    )
    assert (got == want).mean() > 0.99


def test_stop_rule_survives_weak_random_steps():
    """Round-3 stop semantics: the convergence test compares exact frame
    errors one full schedule cycle apart, so weak random steps inside a
    reference-schedule cycle cannot fire the stop while the channel step
    still improves. This fixture's first three random steps each improve
    by < tol (a successive-step rule would stop at step 2 at ~164.19);
    the cycle-aware rule reaches the channel step's ~7.7 improvement."""
    h = w = 64
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 4), np.uint8)
    img[..., 0] = (128 + 90 * np.sin(x / 7)).clip(0, 255)
    img[..., 1] = (128 + 80 * np.cos((x + y) / 9)).clip(0, 255)
    img[..., 2] = (128 + 100 * np.sin(y / 5)).clip(0, 255)
    img[..., 3] = 255

    cfg = QuantConfig(
        subpalette_count=2, subpalette_size=4, width=64, height=64,
        max_steps=6, converge_tol=0.3, random_trials=1,
        schedule="reference", seed=0,
    )
    st = new_state(img, cfg)
    st = pipeline.initialize(st, cfg)
    st = pipeline.cluster(st, cfg)
    st, errs = pipeline.optimize(st, cfg)

    # Precondition (guards against fixture drift): an early successive
    # improvement genuinely is below tol while a later step improves by
    # several times tol — the case where the old successive-step rule
    # stops early and the cycle-aware rule must not.
    deltas = [a - b for a, b in zip(errs, errs[1:])]
    assert min(deltas[:3]) < cfg.converge_tol, deltas
    assert max(deltas) > 6 * cfg.converge_tol, deltas
    # The run must have survived past the weak random steps to the
    # channel step (step 4 under the reference schedule) and realized
    # its improvement.
    assert len(errs) >= 5, errs
    assert errs[-1] < errs[0] - 6 * cfg.converge_tol, errs


def test_config_guard_perceptual_prescreen_full():
    """perceptual_palettes with 0 < prescreen_full < 4 is a measured
    quality loss; the config auto-bumps it to 4."""
    cfg = QuantConfig(perceptual_palettes=True, prescreen=8, prescreen_full=2)
    assert cfg.prescreen_full == 4
    cfg = QuantConfig(perceptual_palettes=True, prescreen=8, prescreen_full=5)
    assert cfg.prescreen_full == 5
    cfg = QuantConfig(prescreen=8, prescreen_full=2)  # red-mean: untouched
    assert cfg.prescreen_full == 2
    cfg = QuantConfig(perceptual_palettes=True)  # 0 = disabled: untouched
    assert cfg.prescreen_full == 0


def test_config_guard_gate_margin_deep_runs():
    """gate_margin with channel_explore or a tight converge_tol is a
    measured quality loss (premature plateau); the config
    warns and disables the gate."""
    cfg = QuantConfig(prescreen=8, prescreen_full=2, gate_margin=0.01,
                      channel_explore=16)
    assert cfg.gate_margin == 0.0
    cfg = QuantConfig(prescreen=8, prescreen_full=2, gate_margin=0.01,
                      converge_tol=0.1)
    assert cfg.gate_margin == 0.0
    cfg = QuantConfig(prescreen=8, prescreen_full=2, gate_margin=0.01,
                      converge_tol=0.5)
    assert cfg.gate_margin == 0.01


def test_config_guard_gate_window_stacking():
    """gate_margin stacked with channel_window is a measured wall-clock
    LOSS (11-12 steps vs 7-8 for either alone); the config
    warns and disables the window, keeping the gate."""
    cfg = QuantConfig(prescreen=8, prescreen_full=2, gate_margin=0.01,
                      schedule="channel", channel_window=4)
    assert cfg.channel_window == 0
    assert cfg.gate_margin == 0.01
    # Either alone is untouched.
    cfg = QuantConfig(schedule="channel", channel_window=4)
    assert cfg.channel_window == 4
    cfg = QuantConfig(prescreen=8, prescreen_full=2, gate_margin=0.01)
    assert cfg.gate_margin == 0.01


def test_config_warns_experimental_knobs(caplog):
    """The two measured-loss knobs kept for experimentation (gate_coarse,
    prescreen_pre — both validated as NOT equal-or-better)
    warn when selected so users cannot mistake them for tuned options;
    the values themselves are kept."""
    import logging

    with caplog.at_level(logging.WARNING, logger="snesimage"):
        cfg = QuantConfig(prescreen=8, prescreen_full=2, gate_margin=0.01,
                          gate_coarse=True)
    assert cfg.gate_coarse
    assert any("gate_coarse" in r.message for r in caplog.records)

    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="snesimage"):
        cfg = QuantConfig(prescreen=8, prescreen_full=2, prescreen_pre=16)
    assert cfg.prescreen_pre == 16
    assert any("prescreen_pre" in r.message for r in caplog.records)

    # dither_proxy: perturbed descent in both directions — warns too.
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="snesimage"):
        cfg = QuantConfig(dither=True, dither_proxy=8)
    assert cfg.dither_proxy == 8
    assert any("dither_proxy" in r.message for r in caplog.records)

    # the tuned fast config stays silent
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="snesimage"):
        QuantConfig(prescreen=8, prescreen_full=2, gate_margin=0.01,
                    converge_tol=0.5, schedule="channel")
    assert not caplog.records


@pytest.mark.slow
def test_run_fused_hybrid(small_image):
    """Two-phase hybrid (pipeline.run_fused_hybrid): phase 1 = gated
    fast descent, phase 2 = explore polish continuing from phase 1's
    state and RNG step count. Invariants: per-phase step counts match
    the error list, every phase runs, the final error is phase 2's last
    carried exact error, and phase 2 (strict-less-than acceptance from
    phase 1's state) can never END worse than phase 1's plateau."""
    cfg_f = QuantConfig(
        subpalette_count=2, subpalette_size=4, width=64, height=64,
        schedule="channel", prescreen=8, prescreen_full=2,
        gate_margin=0.01, converge_tol=0.5, max_steps=3,
    )
    cfg_q = QuantConfig(
        subpalette_count=2, subpalette_size=4, width=64, height=64,
        schedule="channel", prescreen=8, prescreen_full=2,
        channel_explore=8, converge_tol=0.1, max_steps=3,
        accept_margin=0.005,
    )
    state, errors, info = pipeline.run_fused_hybrid(small_image, cfg_f, cfg_q)
    k1, k2 = info["phase_steps"]
    assert k1 >= 1 and k2 >= 1
    assert len(errors) == k1 + k2
    assert info["final_error"] == pytest.approx(errors[-1], abs=1e-3)
    # polish never ends above the fast plateau (strict-less-than accepts
    # from that state; f32 tolerance for cross-program noise)
    assert errors[-1] <= errors[k1 - 1] + 1e-3
    # the exact error of the returned state matches the reported final
    refp = make_reference_pyramid(new_state(small_image, cfg_q))
    assert float(error_of(state, cfg_q, refp)) == pytest.approx(
        info["final_error"], abs=1e-2
    )

    # geometry / mode flags must agree between the phases
    cfg_bad = QuantConfig(
        subpalette_count=2, subpalette_size=4, width=64, height=64,
        dither=True,
    )
    with pytest.raises(ValueError):
        pipeline.run_fused_hybrid(small_image, cfg_f, cfg_bad)
