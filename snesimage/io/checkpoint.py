"""Checkpoint / resume for the full optimizer state.

The reference has no resume path ("being able to resume from a previous
run is desirable", TODO.md:38-39); the JSON written by the blue button is a
partial, load-less snapshot. Here the entire optimizer state pytree plus
config and error history round-trips through one `.npz` file, so any run
can be stopped and resumed exactly.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from snesimage.config import QuantConfig
from snesimage.core.state import QuantState

_FORMAT_VERSION = 1


def save_checkpoint(
    path: str,
    state: QuantState,
    config: QuantConfig,
    *,
    errors: list[float] | None = None,
    step: int = 0,
) -> None:
    """Write the checkpoint ATOMICALLY to EXACTLY `path`.

    Writing through a file object (not a path) stops np.savez from
    silently appending '.npz' — with a bare path, `--checkpoint run.ckpt`
    landed at run.ckpt.npz and the matching `--resume run.ckpt` failed.
    The tmp + os.replace dance means a run killed mid-write (the exact
    interruption checkpoints exist to survive — --dump-every rewrites
    the same file every N steps) can never destroy the previous good
    checkpoint with a truncated zip."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(
            f,
            format_version=_FORMAT_VERSION,
            config=json.dumps(dataclasses.asdict(config)),
            original=np.asarray(state.original),
            tile_palettes=np.asarray(state.tile_palettes),
            palette=np.asarray(state.palette),
            palette_map=np.asarray(state.palette_map),
            errors=np.asarray(
                errors if errors is not None else [], dtype=np.float64
            ),
            step=step,
        )
    os.replace(tmp, path)


def load_checkpoint(path: str) -> tuple[QuantState, QuantConfig, dict]:
    with np.load(path, allow_pickle=False) as z:
        version = int(z["format_version"])
        if version != _FORMAT_VERSION:
            raise ValueError(f"Unsupported checkpoint version {version}")
        config = QuantConfig(**json.loads(str(z["config"])))
        state = QuantState(
            original=z["original"],
            tile_palettes=z["tile_palettes"],
            palette=z["palette"],
            palette_map=z["palette_map"],
        )
        meta = {"errors": z["errors"].tolist(), "step": int(z["step"])}
    return state, config, meta
