"""snesimage: a JAX/XLA SNES image quantization
framework with the capabilities of aexoden/snesimage.

Public API:
    QuantConfig, QuantState, new_state — configuration and state pytree
    pipeline.initialize / cluster / optimize / run — the three stages
    io.json_out.state_to_json — the reference-compatible output contract
"""

from snesimage.config import QuantConfig
from snesimage.core.state import QuantState, new_state

__version__ = "0.1.0"

__all__ = ["QuantConfig", "QuantState", "new_state", "__version__"]
