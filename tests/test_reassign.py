"""Tests for the automatic tile-reassignment extension."""

import pytest
import numpy as np
import jax.numpy as jnp

from snesimage.config import QuantConfig
from snesimage.core import pipeline
from snesimage.core.reassign import auto_reassign_tiles
from snesimage.core.refine import error_of, full_remap, make_reference_pyramid
from snesimage.core.state import new_state


def _two_region_image():
    """Left half red-ish gradient, right half blue-ish gradient."""
    h = w = 64
    img = np.zeros((h, w, 4), dtype=np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    img[:, : w // 2, 0] = 150 + (x[:, : w // 2] % 32) * 3
    img[:, : w // 2, 1] = 30
    img[:, w // 2 :, 2] = 150 + (x[:, w // 2 :] % 32) * 3
    img[:, w // 2 :, 1] = 30
    img[..., 3] = 255
    return img


def test_reassign_separates_regions():
    """With palettes hand-set to red vs blue, reassignment must route the
    red half to the red subpalette and the blue half to the blue one."""
    cfg = QuantConfig(subpalette_count=2, subpalette_size=3, width=64, height=64)
    st = new_state(_two_region_image(), cfg)
    palette = np.zeros((2, 3, 3), dtype=np.int32)
    palette[0] = [[18, 4, 0], [22, 4, 0], [26, 4, 0]]  # reds
    palette[1] = [[0, 4, 18], [0, 4, 22], [0, 4, 26]]  # blues
    st = st._replace(palette=jnp.asarray(palette))

    st2 = auto_reassign_tiles(st, cfg)
    tp = np.asarray(st2.tile_palettes)
    assert (tp[:, :4] == 0).all()  # left tiles -> red subpalette
    assert (tp[:, 4:] == 1).all()  # right tiles -> blue subpalette


def test_reassign_never_worsens_much(small_image):
    """Reassigning to the per-tile distance argmin should not noticeably
    worsen the perceptual error on a clustered state."""
    cfg = QuantConfig(subpalette_count=3, subpalette_size=4, width=64, height=64)
    st = new_state(small_image, cfg)
    st = pipeline.initialize(st, cfg)
    st = pipeline.cluster(st, cfg)
    refp = make_reference_pyramid(st)
    before = float(error_of(st, cfg, refp))
    st2 = full_remap(auto_reassign_tiles(st, cfg), cfg)
    after = float(error_of(st2, cfg, refp))
    assert after <= before + 1.0


def test_transparent_tiles_keep_zero(small_image):
    cfg = QuantConfig(subpalette_count=3, subpalette_size=4, width=64, height=64)
    st = new_state(small_image, cfg)
    st = pipeline.initialize(st, cfg)
    st2 = auto_reassign_tiles(st, cfg)
    tp = np.asarray(st2.tile_palettes)
    assert tp[0, 6] == 0 and tp[0, 7] == 0  # fully transparent tiles


def test_parse_reassignments():
    spec = """
    # comment line
    3 5        # cycle once (one GUI click)
    0 0 1      # set directly
    7 2
    """
    assert pipeline.parse_reassignments(spec) == [(3, 5), (0, 0, 1), (7, 2)]
    import pytest

    with pytest.raises(ValueError):
        pipeline.parse_reassignments("1 2 3 4")
    with pytest.raises(ValueError):
        pipeline.parse_reassignments("1 a")


def test_apply_tile_reassignments(small_image):
    """(x, y) cycles like one GUI click (src/lib.rs:1005-1024); (x, y, p)
    sets directly; out-of-range tiles/palettes are rejected."""
    import pytest

    cfg = QuantConfig(subpalette_count=3, subpalette_size=4, width=64, height=64)
    st = new_state(small_image, cfg)
    st = pipeline.initialize(st, cfg)
    st = pipeline.cluster(st, cfg)
    before = np.asarray(st.tile_palettes)

    st2 = pipeline.apply_tile_reassignments(
        st, cfg, [(3, 5), (0, 0, 2)], recluster=False
    )
    tp = np.asarray(st2.tile_palettes)
    assert tp[5, 3] == (before[5, 3] + 1) % cfg.subpalette_count
    assert tp[0, 0] == 2
    # untouched elsewhere
    mask = np.ones_like(before, bool)
    mask[5, 3] = mask[0, 0] = False
    np.testing.assert_array_equal(tp[mask], before[mask])

    # cycling twice == two clicks
    st3 = pipeline.apply_tile_reassignments(
        st, cfg, [(3, 5), (3, 5)], recluster=False
    )
    assert np.asarray(st3.tile_palettes)[5, 3] == (
        before[5, 3] + 2
    ) % cfg.subpalette_count

    # recluster=True re-fits palettes to the new assignment and remaps
    st4 = pipeline.apply_tile_reassignments(st, cfg, [(0, 0, 2)])
    assert np.isfinite(np.asarray(st4.palette)).all()

    with pytest.raises(ValueError):
        pipeline.apply_tile_reassignments(st, cfg, [(99, 0)])
    with pytest.raises(ValueError):
        pipeline.apply_tile_reassignments(st, cfg, [(0, 0, 7)])


@pytest.mark.slow
def test_optimize_with_reassign_every(small_image):
    cfg = QuantConfig(subpalette_count=2, subpalette_size=3, width=64, height=64,
                      max_steps=2)
    st = new_state(small_image, cfg)
    st = pipeline.initialize(st, cfg)
    st = pipeline.cluster(st, cfg)
    st2, errors = pipeline.optimize(st, cfg, reassign_every=1)
    assert len(errors) == 2
    assert np.isfinite(errors).all()


@pytest.mark.slow
def test_optimize_on_step_state_midrun(small_image):
    """on_step_state can inject a tile reassignment AFTER optimization has
    started (the reference GUI's mid-optimization click, src/lib.rs:
    1005-1024) and the loop continues from the replaced state: the edit
    survives to the final state because nothing else mutates
    tile_palettes."""
    cfg = QuantConfig(subpalette_count=2, subpalette_size=3, width=64,
                      height=64, max_steps=3, schedule="channel")
    st = new_state(small_image, cfg)
    st = pipeline.initialize(st, cfg)
    st = pipeline.cluster(st, cfg)
    target = int(1 - np.asarray(st.tile_palettes)[0, 0])  # differs from cur

    applied = []

    def on_step_state(step, state, errs):
        if step != 0:
            return None
        applied.append(step)
        return pipeline.apply_tile_reassignments(
            state, cfg, [(0, 0, target)]
        )

    st2, errors = pipeline.optimize(st, cfg, on_step_state=on_step_state)
    assert applied == [0]
    assert len(errors) == 3 and np.isfinite(errors).all()
    assert int(np.asarray(st2.tile_palettes)[0, 0]) == target


def test_midrun_replacement_resets_plateau_stop(small_image):
    """A mid-run state replacement restarts the converge_tol window
    (round 5 fix: a reassignment that worsens the metric used to trip an
    immediate plateau stop at the very step it was applied, so the edit
    never got re-optimized): with a huge tol the bare run stops after
    cycle+1 = 2 steps, while an on_step_state replacement at step 1
    clears the window and buys one more full cycle — 3 steps total."""
    cfg = QuantConfig(subpalette_count=2, subpalette_size=3, width=64,
                      height=64, max_steps=6, schedule="channel",
                      converge_tol=1e9)
    st = new_state(small_image, cfg)
    st = pipeline.initialize(st, cfg)
    st = pipeline.cluster(st, cfg)

    _, base_errors = pipeline.optimize(st, cfg)
    assert len(base_errors) == 2, base_errors

    def replace_at_1(step, state, errs):
        return state if step == 1 else None  # identity = external edit

    _, errors = pipeline.optimize(st, cfg, on_step_state=replace_at_1)
    assert len(errors) == 3, errors


def test_reassign_tile_bounds_validated(small_image):
    """reassign_tile rejects out-of-range coordinates (JAX would silently
    drop the out-of-bounds scatter, turning a bad click into a no-op)."""
    cfg = QuantConfig(subpalette_count=2, subpalette_size=3, width=64,
                      height=64)
    st = new_state(small_image, cfg)
    with pytest.raises(ValueError, match="out of range"):
        pipeline.reassign_tile(st, cfg, tile_x=cfg.width_tiles, tile_y=0)
    with pytest.raises(ValueError, match="out of range"):
        pipeline.reassign_tile(st, cfg, tile_x=0, tile_y=-1)


def test_optimize_on_step_callback(small_image):
    """on_step fires after every sweep with the step index, the current
    state, and the errors so far (the CLI's --dump-every surface), and
    its trajectory matches the fused path's error history."""
    cfg = QuantConfig(subpalette_count=2, subpalette_size=3, width=64, height=64,
                      max_steps=2, schedule="channel")
    st = new_state(small_image, cfg)
    st = pipeline.initialize(st, cfg)
    st = pipeline.cluster(st, cfg)

    seen = []
    st2, errors = pipeline.optimize(
        st, cfg, on_step=lambda step, state, errs: seen.append(
            (step, len(errs), float(np.asarray(errs)[-1]))
        ),
    )
    assert [s[0] for s in seen] == [0, 1]
    assert [s[1] for s in seen] == [1, 2]
    assert [round(s[2], 4) for s in seen] == [round(e, 4) for e in errors]
