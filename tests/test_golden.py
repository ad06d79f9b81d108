"""Golden regression: the full pipeline's JSON output on a fixed input and
seed must stay byte-stable on the CPU backend.

This pins end-to-end determinism (k-means init order, remap tie-breaks,
candidate selection, RNG stream, JSON serialization). If an intentional
behavior change breaks it, regenerate the hashes with the snippet in the
test body and document the change.
"""

import pytest
import hashlib

import numpy as np

from snesimage.config import QuantConfig
from snesimage.core import pipeline
from snesimage.core.state import new_state
from snesimage.io.json_out import state_to_json

GOLDEN = {
    False: "8fddf7c5a5e35231d504f2a66b97b4cb6df82f68ae9df014a16cee345189cdd3",
    # Dithered hash regenerated 2026-08-17 (round 3): the SSIMULACRA2
    # weight-table audit fix changed candidate selections on this fixture.
    True: "0b4d7567cdbca83c70792a60ca45d21724454adf10a756f5e6f29466418cda86",
}


def _golden_image():
    h = w = 64
    y, x = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 4), dtype=np.uint8)
    img[..., 0] = (x * 4) % 256
    img[..., 1] = (y * 4) % 256
    img[..., 2] = ((x + y) * 2) % 256
    img[..., 3] = 255
    img[0:8, 0:8, 3] = 0
    return img


def _run(dither: bool) -> str:
    cfg = QuantConfig(
        subpalette_count=2, subpalette_size=4, width=64, height=64,
        max_steps=1, seed=7, dither=dither,
    )
    st = new_state(_golden_image(), cfg)
    st = pipeline.initialize(st, cfg)
    st = pipeline.cluster(st, cfg)
    st, _ = pipeline.optimize(st, cfg, max_steps=1)
    return hashlib.sha256(state_to_json(st, cfg).encode()).hexdigest()


@pytest.mark.slow
def test_golden_undithered():
    assert _run(False) == GOLDEN[False]


@pytest.mark.slow
def test_golden_dithered():
    assert _run(True) == GOLDEN[True]
