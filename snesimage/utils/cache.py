"""Persistent XLA compilation cache.

First-time compiles of the sweep programs take many seconds; caching them
on disk lets a later process skip them. Disable with SNESIMAGE_NO_CACHE=1.

Where the cache lives:

- `JAX_COMPILATION_CACHE_DIR`, when set. JAX reads that variable itself,
  so no other directory is set in code.
- Otherwise `.jax_cache/` in the checkout: a fixed path, so a later
  process in the same checkout finds what an earlier one wrote.

On the CPU backend the directory gets a per-host-CPU subdirectory: XLA:CPU
stores AOT-compiled machine code whose cache key does NOT include the
host's CPU feature set, so entries written on one machine can be loaded
on another with different features — observed to SIGSEGV the process
after a VM migrated hosts (the loader only *warns*: "Machine type used
for XLA:CPU compilation doesn't match ... could lead to execution errors
such as SIGILL"). A per-CPU directory turns that load into a clean miss.
GPU entries are keyed by the device and need no such split.
"""

from __future__ import annotations

import hashlib
import os
import pathlib

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def _cpu_fingerprint() -> str:
    """Stable short hash of this host's CPU identity + feature set.

    The flags line alone is NOT enough: two VM hosts were observed with
    identical /proc/cpuinfo flags but different LLVM-detected feature
    sets, so the hash also covers family/model/stepping/microcode/
    model-name, which differ across such hosts."""
    try:
        with open("/proc/cpuinfo") as f:
            ident: list[str] = []
            feats = ""
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in (
                    "cpu family", "model", "model name", "stepping",
                    "microcode",
                ) and len(ident) < 5:
                    ident.append(line.strip())
                elif key in ("flags", "Features") and not feats:
                    feats = " ".join(sorted(line.split(":", 1)[1].split()))
            if feats or ident:
                blob = "|".join(ident) + "||" + feats
                return hashlib.sha256(blob.encode()).hexdigest()[:12]
    except OSError:
        pass
    import platform

    return hashlib.sha256(platform.processor().encode()).hexdigest()[:12]


def cache_dir(backend: str, environ=os.environ) -> str | None:
    """Directory the code should set for `backend`, or None when it must
    set none (caching disabled, or JAX_COMPILATION_CACHE_DIR governs)."""
    if environ.get("SNESIMAGE_NO_CACHE") or environ.get(CACHE_ENV):
        return None
    base = DEFAULT_DIR
    if backend == "cpu":
        base = base / _cpu_fingerprint()
    return str(base)


def enable_compile_cache() -> None:
    if os.environ.get("SNESIMAGE_NO_CACHE"):
        return
    import jax

    path = cache_dir(jax.default_backend())
    if path is not None:
        pathlib.Path(path).mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
