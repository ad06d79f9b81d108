"""Compile-cache directory policy (utils/cache.py)."""

import pathlib

import pytest

from snesimage.utils import cache

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize(
    "environ,backend,want",
    [
        ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, "gpu", None),
        ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, "cpu", None),
        ({"SNESIMAGE_NO_CACHE": "1"}, "gpu", None),
        ({}, "gpu", "default"),
        ({}, "cpu", "default/cpu"),
    ],
)
def test_cache_dir_policy(environ, backend, want):
    got = cache.cache_dir(backend, environ)
    if want is None:
        assert got is None
    elif want == "default":
        assert got == str(cache.DEFAULT_DIR)
    else:
        assert got == str(cache.DEFAULT_DIR / cache._cpu_fingerprint())


def test_default_cache_is_in_the_checkout_and_ignored():
    assert cache.DEFAULT_DIR.parent == REPO
    ignored = (REPO / ".gitignore").read_text().split()
    assert cache.DEFAULT_DIR.name + "/" in ignored
