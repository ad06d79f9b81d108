"""The main path on an NVIDIA GPU against the CPU backend and the oracle.

Marked `gpu`: the `gpu` fixture skips them on a machine without a card.
Run on the card with `python -m pytest -m gpu tests/` (chip_smoke.py runs
them too).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from snesimage.config import QuantConfig
from snesimage.core import pipeline, refine
from snesimage.core.state import new_state

pytestmark = pytest.mark.gpu

CFG = QuantConfig(subpalette_count=4, subpalette_size=7, width=64, height=64)


def _init(img, cfg, device):
    with jax.default_device(device):
        st = new_state(img, cfg)
        return jax.device_get(pipeline.cluster(pipeline.initialize(st, cfg), cfg))


def test_init_and_clustering_equal_cpu(gpu, small_image):
    on_gpu = _init(small_image, CFG, gpu)
    on_cpu = _init(small_image, CFG, jax.devices("cpu")[0])
    for a, b in zip(on_gpu, on_cpu):
        np.testing.assert_array_equal(a, b)


def test_remap_equals_oracle(gpu, small_image):
    from snesimage.native import oracle_remap
    from snesimage.ops.remap import remap_undithered

    st = _init(small_image, CFG, gpu)
    with jax.default_device(gpu):
        got = remap_undithered(
            jnp.asarray(small_image[..., :3]), jnp.asarray(small_image[..., 3]),
            jnp.asarray(st.tile_palettes), jnp.asarray(st.palette), False,
        )
    assert got.devices() == {gpu}
    want = oracle_remap(small_image, st.tile_palettes, st.palette, False, False)
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("frames,bound", [("palette", 1e-3), ("noise", 2e-2)])
def test_metric_matches_cpu(gpu, rng, small_image, frames, bound):
    """SSIMULACRA2 of 8 frames on the card against the CPU backend.

    palette: candidate frames as the search scores them (the clustered map
    rendered under palettes moved by +-2), bound 1e-3.
    noise: the image under +-12 noise per channel, bound 2e-2. On such
    frames the score is ill-conditioned in f32: the variances s - mu^2
    cancel, so a 1-ulp change of the blurred moments alone moves the score
    on the CPU by up to ~7e-3, and the card's GEMMs round differently
    (tools/backend_gap.py; PERF.md gives the readings)."""
    from snesimage.ops.remap import render_rgb8
    from snesimage.ops.ssimulacra2 import reference_pyramid, ssimulacra2_from_ref

    if frames == "palette":
        st = _init(small_image, CFG, jax.devices("cpu")[0])
        pals = np.clip(
            st.palette[None] + rng.integers(-2, 3, (8,) + st.palette.shape), 0, 31
        )
        batch = np.stack([
            np.asarray(render_rgb8(st.palette_map, st.original[..., 3],
                                   st.tile_palettes, p))
            for p in pals
        ]).astype(np.uint8)
    else:
        batch = np.clip(
            small_image[None, ..., :3].astype(np.int32)
            + rng.integers(-12, 13, (8, 64, 64, 3)), 0, 255,
        ).astype(np.uint8)

    @jax.jit
    def scores(ref, frs):
        refp = reference_pyramid(ref)
        return jax.vmap(lambda f: ssimulacra2_from_ref(refp, f))(frs)

    def on(dev):
        with jax.default_device(dev):
            return np.asarray(
                scores(jnp.asarray(small_image[..., :3]), jnp.asarray(batch))
            )

    np.testing.assert_allclose(on(gpu), on(jax.devices("cpu")[0]),
                               atol=bound, rtol=0)


def test_fused_run_descends_on_gpu(gpu, small_image):
    cfg = QuantConfig(
        subpalette_count=2, subpalette_size=3, width=64, height=64,
        max_steps=3, schedule="channel", prescreen=8, prescreen_full=2,
    )
    with jax.default_device(gpu):
        state, errors, info = pipeline.run_fused(small_image, cfg)
    assert state.palette_map.devices() == {gpu}
    assert len(errors) == 3 and np.isfinite(errors).all()
    assert all(b <= a + 1e-4 for a, b in zip(errors, errors[1:]))
    with jax.default_device(gpu):
        refp = refine.make_reference_pyramid(state)
        exact = float(refine.error_of(state, cfg, refp))
    assert abs(exact - info["final_error"]) < 1e-3
