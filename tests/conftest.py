"""Test configuration: the CPU backend with 8 virtual devices, so the
whole suite (including multi-device sharding tests) runs anywhere — the
JAX analogue of a fake backend (SURVEY.md §4).

Tests marked `gpu` need an NVIDIA GPU: the `gpu` fixture skips them on a
machine without one. Run them on the card with
`python -m pytest -m gpu tests/`; that selection leaves the platform to
JAX instead of pinning the CPU.
"""

import os
import sys

# Hermetic suite: code under test (CLI mains) calls enable_compile_cache,
# which would flip the persistent XLA cache on for the rest of the
# process (see utils/cache.py).
os.environ["SNESIMAGE_NO_CACHE"] = "1"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
from hypothesis import settings as _hyp_settings  # noqa: E402

# No wall-clock deadlines for property tests: single-core containers +
# jit compile/dispatch jitter trip hypothesis's default 200 ms deadline
# on tests that are otherwise instant (observed flaky DeadlineExceeded
# on test_expand_range_and_monotone under background CPU load).
_hyp_settings.register_profile("snesimage", deadline=None)
_hyp_settings.load_profile("snesimage")


def _gpu_selected(config) -> bool:
    expr = config.getoption("markexpr") or ""
    return "gpu" in expr and "not gpu" not in expr


def pytest_configure(config):
    """Pin the CPU backend unless the run selects the `gpu` tests. Runs
    before any test module imports JAX."""
    if not _gpu_selected(config):
        os.environ["JAX_PLATFORMS"] = "cpu"
        if "jax" in sys.modules:
            sys.modules["jax"].config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The first NVIDIA GPU; skips the test on a machine without one."""
    import jax

    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU (python -m pytest -m gpu tests/)")
    return devices[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables at module boundaries. XLA:CPU on this
    host segfaults inside LLVM compilation (backend_compile_and_load)
    once enough live executables accumulate in one process — the full
    suite crashed deterministically at the same mid-suite compile (rc
    139) while every strict subset of the preceding modules passed, and
    no memory/cgroup limit was in play (128 GB free). Dropping the pjit
    caches between modules keeps the live-executable count bounded.
    Cross-module compile reuse is minimal (fixtures differ per module),
    so the overhead is small."""
    yield
    import jax

    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def poster_image():
    """64x64 flat poster-art content: few solid colors, hard edges, thin
    strokes — the content class where windowed/gated shortcuts failed in
    earlier experiments, so trajectory tests must cover it alongside the
    gradient fixture."""
    h = w = 64
    img = np.zeros((h, w, 4), dtype=np.uint8)
    img[..., :3] = (240, 230, 210)
    img[..., 3] = 255
    img[8:32, 8:56, :3] = (200, 30, 40)
    img[36:60, 12:36, :3] = (30, 60, 160)
    img[40:52, 40:60, :3] = (20, 140, 60)
    for x0 in range(12, 52, 8):  # text-like strokes
        img[20:24, x0 : x0 + 3, :3] = (10, 10, 10)
    return img


@pytest.fixture
def small_image(rng):
    """64x64 RGBA test image with smooth gradients, blocks, and a
    transparent region."""
    h = w = 64
    y, x = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 4), dtype=np.uint8)
    img[..., 0] = (x * 4) % 256
    img[..., 1] = (y * 4) % 256
    img[..., 2] = ((x + y) * 2) % 256
    img[..., 3] = 255
    img[8:16, 8:16] = (200, 50, 30, 255)
    img[40:56, 40:56] = (20, 180, 220, 255)
    img[0:8, 48:64, 3] = 0  # fully transparent tiles
    img[0:8, 48:64, :3] = 77  # garbage color under transparency
    return img
