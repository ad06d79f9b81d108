"""One numerics policy: every f32 contraction runs at HIGHEST precision.

On GPUs a default-precision f32 matmul may run in TF32 (~1e-3 relative),
which flips exact-score comparisons. The test lowers the main programs to
StableHLO and checks every dot_general's precision config.
"""

import re

import jax
import numpy as np
import pytest

from snesimage.config import QuantConfig
from snesimage.core import pipeline, refine
from snesimage.core.state import new_state

CFG = dict(subpalette_count=2, subpalette_size=3, width=32, height=32)


def _state(cfg):
    img = np.random.default_rng(0).integers(0, 256, (32, 32, 4)).astype(np.uint8)
    img[..., 3] = 255
    st = new_state(img, cfg)
    st = pipeline.cluster(pipeline.initialize(st, cfg), cfg)
    return st, refine.make_reference_pyramid(st)


def _lowered(name, cfg):
    st, refp = _state(cfg)
    if name == "prep_fused":
        return pipeline._prep_fused.lower(new_state(np.asarray(st.original), cfg), cfg)
    if name == "error_of":
        return refine.error_of.lower(st, cfg, refp)
    if name == "slot_channel":
        return refine.refine_slot_channel.lower(st, cfg, refp, 0, 1, 2)
    if name == "slot_random":
        return refine.refine_slot_random.lower(st, cfg, refp, jax.random.key(0), 1, 0)
    if name == "ssimulacra2":
        from snesimage.ops.ssimulacra2 import ssimulacra2

        frame = np.asarray(st.original[..., :3])
        return ssimulacra2.lower(frame, frame[::-1])
    if name == "dither_perceptual":
        from snesimage.ops.dither import remap_dithered

        return remap_dithered.lower(st.original[..., :3], st.original[..., 3],
                                    st.tile_palettes, st.palette, True)
    raise ValueError(name)


@pytest.mark.parametrize(
    "name,opts",
    [
        ("prep_fused", {}),
        ("prep_fused", {"perceptual_palettes": True}),
        ("error_of", {}),
        ("slot_channel", {"prescreen": 8, "prescreen_full": 2}),
        ("slot_random", {"perceptual_palettes": True, "prescreen": 8,
                         "prescreen_full": 4}),
        ("slot_random", {"dither": True}),
        ("ssimulacra2", {}),
        ("dither_perceptual", {}),
    ],
)
def test_every_dot_general_is_highest(name, opts):
    text = _lowered(name, QuantConfig(**CFG, **opts)).as_text()
    dots = re.findall(r"stablehlo\.dot_general[^\n]*", text)
    assert dots, f"{name}: no dot_general lowered"
    bad = [d for d in dots if "precision = [HIGHEST, HIGHEST]" not in d]
    assert not bad, f"{name}: {len(bad)} dot_general(s) without HIGHEST: {bad[:2]}"
