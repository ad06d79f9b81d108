"""Tracing / profiling hooks.

The reference's only observability is throttled error logging
(src/lib.rs:910-915). Equivalent here (SURVEY.md §5): step timers,
objective history, and `jax.profiler` trace capture for Perfetto/XProf.
"""

from __future__ import annotations

import contextlib
import logging
import re
import time
from dataclasses import dataclass, field

import jax

log = logging.getLogger("snesimage")


@dataclass
class StepTimer:
    """Accumulates per-phase wall-clock; report with `summary()`."""

    times: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def time(self, name: str, *, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                jax.block_until_ready(block_on)
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.times.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total:.3f}s total, {n} calls, {total / n * 1e3:.2f}ms/call")
        return "\n".join(lines)

    def log_summary(self) -> None:
        for line in self.summary().splitlines():
            log.info("timing | %s", line)


@contextlib.contextmanager
def trace(trace_dir: str | None):
    """Capture a jax.profiler trace (viewable in XProf/Perfetto) when a
    directory is given; no-op otherwise."""
    if not trace_dir:
        yield
        return
    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        log.info("profiler trace written to %s", trace_dir)


def _union_ns(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


_HLO_OP = re.compile(
    r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*\bmetadata=\{[^}]*?op_name="([^"]*)"'
)
LIBRARY_GEMM = "<library gemm>"


def hlo_kernel_ops(hlo_text: str) -> dict:
    """Kernel name -> JAX op_name path, read from an optimized HLO module
    (`jax.jit(f).lower(...).compile().as_text()`).

    XLA names each fusion's GPU kernel after the instruction, with '.'
    and '-' as '_', and the fusion carries its root op's op_name (which
    holds any `jax.named_scope`). Library GEMM kernels (cuBLAS custom
    calls) are named by the library, not per call: their op_names are
    collected as a tuple under LIBRARY_GEMM."""
    ops, gemms = {}, []
    for line in hlo_text.splitlines():
        m = _HLO_OP.match(line)
        if not m:
            continue
        if "custom_call_target=\"__cublas" in line:
            gemms.append(m.group(2))
        ops[re.sub(r"[.\-]", "_", m.group(1))] = m.group(2)
    ops[LIBRARY_GEMM] = tuple(gemms)
    return ops


def _is_library_gemm(name: str) -> bool:
    return "xmma" in name or "cutlass" in name or "gemm" in name.lower()


def device_summary(profile, scopes=(), top: int = 10, kernel_ops=None) -> dict:
    """Reduce a jax.profiler trace (`jax.profiler.ProfileData`) to device
    metrics over the span from the first device event to the last.

    Device events are the kernels and copies on the "Stream" lines of
    the device planes (`/device:GPU:*`). Returns busy_ns (union of the
    event intervals), span_ns, idle_share (1 - busy/span), top
    [(name, total_ns, count, op path)] by total time, and
    scope_ns {scope: ns of kernel events whose name, string stats or op
    path contains the scope, e.g. a `jax.named_scope`}. `kernel_ops`
    (hlo_kernel_ops of the traced program) gives each kernel its op path;
    a library GEMM counts for a scope only when every GEMM call of the
    program lies in it. unmapped_ns is the kernel time with no op path.
    """
    kernel_ops = kernel_ops or {}
    gemm_ops = kernel_ops.get(LIBRARY_GEMM, ())

    def op_path(ev):
        if ev.name in kernel_ops:
            return kernel_ops[ev.name]
        if gemm_ops and _is_library_gemm(ev.name):
            return gemm_ops
        return None

    kernels = [
        ev
        for plane in profile.planes if plane.name.startswith("/device:GPU")
        for ln in plane.lines if ln.name.startswith("Stream")
        for ev in ln.events
    ]
    if not kernels:
        raise ValueError("trace has no GPU kernel events")
    spans = [(ev.start_ns, ev.start_ns + ev.duration_ns) for ev in kernels]
    busy = _union_ns(spans)
    span = max(e for _, e in spans) - min(s for s, _ in spans)
    totals: dict[str, list] = {}
    for ev in kernels:
        t = totals.setdefault(ev.name, [0.0, 0])
        t[0] += ev.duration_ns
        t[1] += 1
    ranked = sorted(totals.items(), key=lambda kv: -kv[1][0])[:top]
    def in_scope(ev, scope):
        path = op_path(ev)
        if isinstance(path, tuple):
            return all(scope in p for p in path)
        return (
            scope in ev.name
            or (path is not None and scope in path)
            or any(isinstance(v, str) and scope in v for _, v in ev.stats)
        )

    scope_ns = {
        scope: _union_ns(
            (ev.start_ns, ev.start_ns + ev.duration_ns)
            for ev in kernels if in_scope(ev, scope)
        )
        for scope in scopes
    }
    unmapped = sum(ev.duration_ns for ev in kernels if op_path(ev) is None)
    paths = {ev.name: op_path(ev) for ev in kernels}
    return {
        "busy_ns": busy,
        "span_ns": span,
        "idle_share": 1.0 - busy / span if span > 0 else 0.0,
        "top": [(name, ns, n, paths.get(name)) for name, (ns, n) in ranked],
        "scope_ns": scope_ns,
        "unmapped_ns": unmapped if kernel_ops else None,
    }
