"""Smoke run of the quantizer on an NVIDIA GPU through its user entry points.

Every phase runs in this one process, which holds the card (a second JAX
process would find its memory taken). `nvidia-smi` runs in a child that
never imports JAX. Any failing phase ends the run with a non-zero exit
code and no result line.

Phases (one card):
  device    the default JAX device must be a GPU; no CPU fallback.
  parity    at 256x256 with 8x15 palettes: k-means init + clustering on
            the card equal the same jitted functions on the CPU; the
            undithered remaps agree with the C++ oracle
            (native/oracle.cpp) at the test bounds; dithered remaps agree
            with it on random content, and on the bench image reach its
            error within 0.5 where faulty scans do not; the red-mean
            dithered map equals the CPU backend's; SSIMULACRA2 of 64
            candidate frames is within 1e-3 of the CPU backend, of 64
            noisy frames within 2e-2.
  headline  `cli.main` on a generated 256x256 PNG, 8x15, balanced
            profile, cold and warm.
  paths     -d (and the dither scan's time per slot visit),
            --perceptual-palettes, --preset nes-compat, --opt-profile
            robust, and `batch_cli.main` over 16 images (NES 4x3).
  trace     one warm headline sweep under jax.profiler: device idle
            share, top device operations, the metric's share.
  gpu tests the tests marked `gpu`, in this process.

With --devices 4 it runs only the sharded batch path (parallel/batch.py)
over four cards and what it is compared with: the same images on one card.

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Usage:
  python chip_smoke.py               # one card, every phase
  python chip_smoke.py --devices 4   # the four-card sharded batch path
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import pathlib
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
H = W = 256
# A faulty Floyd-Steinberg scan for the dither gate's control.
DITHER_WEIGHTS_REVERSED = np.array([1.0, 5.0, 3.0, 7.0], np.float32) / 16.0


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_info() -> str:
    """`nvidia-smi` name and power limit of every card, from a child
    process that never touches JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return "; ".join(ln.strip() for ln in out.stdout.splitlines() if ln.strip())


def device_phase(jax, want: int) -> dict:
    """The default device must be a GPU, and there must be `want` of them."""
    devs = jax.devices()
    info = {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }
    check(info["platform"] == "gpu",
          f"no GPU: JAX's default device is {info['platform']}")
    check(info["count"] >= want, f"needs {want} GPUs, found {info['count']}")
    return info


def last_line(device: dict) -> str:
    return json.dumps({"ok": True, "device": device})


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records: list[logging.LogRecord] = []

    def emit(self, record):
        self.records.append(record)


def run_main(main, argv) -> tuple[float, list]:
    """Call a CLI main in-process; (seconds, log records) or raise."""
    handler = _Records()
    logger = logging.getLogger("snesimage")
    logger.addHandler(handler)
    try:
        t0 = time.perf_counter()
        rc = main([str(a) for a in argv])
        dt = time.perf_counter() - t0
    finally:
        logger.removeHandler(handler)
    check(rc == 0, f"{main.__module__}.main{argv} exited {rc}")
    return dt, handler.records


def step_errors(records) -> list[float]:
    return [float(r.args[1]) for r in records if r.msg == "step %d error: %f"]


def check_json(path, c: int) -> None:
    doc = json.loads(pathlib.Path(path).read_text())
    check(len(doc["palette"]) == c * 16, f"{path}: palette length")
    check(len(doc["tile_palettes"]) == 1024, f"{path}: tile_palettes length")
    check(
        len(doc["tiles"]) == 1024 and all(len(t) == 64 for t in doc["tiles"]),
        f"{path}: tiles shape",
    )


def check_descent(errs: list[float], what: str) -> None:
    check(len(errs) > 0 and np.isfinite(errs).all(), f"{what}: errors {errs}")
    check(
        all(b <= a + 1e-4 for a, b in zip(errs, errs[1:])),
        f"{what}: step errors increase {errs}",
    )


def parity_phase(jax, card: str) -> None:
    import jax.numpy as jnp

    from bench import _test_image
    from snesimage.config import QuantConfig
    from snesimage.core import pipeline, refine
    from snesimage.core.state import QuantState, new_state
    from snesimage.native import oracle_remap
    from snesimage.ops.dither import remap_dithered
    from snesimage.ops.remap import remap_undithered, render_rgb8
    from snesimage.ops.ssimulacra2 import reference_pyramid, ssimulacra2_from_ref

    cpu = jax.devices("cpu")[0]
    gpu = jax.devices()[0]
    img = _test_image()
    cfg = QuantConfig(subpalette_count=8, subpalette_size=15)

    def init_cluster(device):
        with jax.default_device(device):
            st = new_state(img, cfg)
            st = pipeline.cluster(pipeline.initialize(st, cfg), cfg)
            return jax.device_get(st)

    t0 = time.perf_counter()
    st = init_cluster(gpu)
    t_gpu = time.perf_counter() - t0
    ref = init_cluster(cpu)
    for field in ("tile_palettes", "palette", "palette_map"):
        check(
            np.array_equal(getattr(st, field), getattr(ref, field)),
            f"k-means init + clustering: {field} differs from the CPU run",
        )
    print(f"parity kmeans_init_cluster 256x256 8x15: tile_palettes, palette "
          f"and palette_map equal to the CPU backend; first call "
          f"{t_gpu:.3f} s incl. compile [card: {card}]")

    tp = st.tile_palettes
    pal = np.asarray(st.palette)
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 256, (H, W, 4)).astype(np.uint8)
    noise[..., 3] = 255
    state = QuantState(*(jnp.asarray(a) for a in st))
    refp = refine.make_reference_pyramid(state)

    def error(pm):
        return float(refine.error_of(state._replace(palette_map=jnp.asarray(pm)),
                                     cfg, refp))

    def on(device, fn, *args):
        return np.asarray(fn(*jax.device_put(args, device)))

    def dithered(perceptual):
        return lambda *a: remap_dithered(*a, perceptual)

    def faulty_dithered(perceptual):
        """The dithered remap traced with its diffusion weights reversed."""
        from snesimage.ops import dither

        def run(*a):
            with mock.patch.object(dither, "DITHER_WEIGHTS",
                                   DITHER_WEIGHTS_REVERSED):
                return jax.jit(lambda *x: dither.remap_dithered.__wrapped__(
                    *x, perceptual))(*a)
        return run

    # Undithered maps against the oracle on the bench image (bounds of
    # tests/test_remap.py).
    for name, perceptual, bound in (("red-mean", False, 1.0),
                                    ("perceptual", True, 0.995)):
        got = on(gpu, lambda *a: remap_undithered(*a, perceptual),
                 img[..., :3], img[..., 3], tp, pal)
        want = oracle_remap(img, tp, pal, False, perceptual)
        agree = float((got == want).mean())
        check(agree >= bound,
              f"undithered {name} remap: oracle agreement {agree} < {bound}")
        print(f"parity remap undithered {name} bench image 256x256 8x15 vs "
              f"oracle: agreement {agree:.6f} (bound {bound})")

    # Dithered maps. On random content: oracle agreement at the tests'
    # bounds. On the bench image one f32 near-tie flip cascades through the
    # rest of the scan, so there the gate is the quality of the dither:
    # |error - oracle error| <= 0.5. Faulty controls (no diffusion, the
    # diffusion weights reversed) must read above the limit on every run.
    # The red-mean map must equal the same scan on the CPU backend; the
    # perceptual one is reported (CIEDE2000 near-ties, PERF.md).
    for name, perceptual, bound in (("red-mean", False, 0.99),
                                    ("perceptual", True, 0.97)):
        good, faulty = dithered(perceptual), faulty_dithered(perceptual)
        for content, im in (("random content", noise), ("bench image", img)):
            args = (im[..., :3], im[..., 3], tp, pal)
            got = on(gpu, good, *args)
            want = oracle_remap(im, tp, pal, True, perceptual)
            agree = float((got == want).mean())
            line = (f"parity remap dithered {name} {content} 256x256 8x15: "
                    f"oracle agreement {agree:.6f}")
            if content == "random content":
                check(agree >= bound, f"dithered {name} remap ({content}): "
                      f"oracle agreement {agree} < {bound}")
                print(f"{line} (bound {bound})")
                continue
            ref_err = error(want)
            gap = abs(error(got) - ref_err)
            controls = {
                "undithered": abs(error(on(gpu, lambda *a: remap_undithered(
                    *a, perceptual), *args)) - ref_err),
                "reversed weights": abs(error(on(gpu, faulty, *args)) - ref_err),
            }
            check(gap <= 0.5, f"dithered {name} remap: error gap {gap} to "
                  f"oracle > 0.5")
            check(min(controls.values()) > 0.5,
                  f"dithered {name}: a faulty control passes the 0.5 gate "
                  f"{controls}")
            cpu_map = on(cpu, good, *args)
            same = float((got == cpu_map).mean())
            if not perceptual:
                check(same == 1.0, f"dithered {name} remap: card differs from "
                      f"the CPU backend ({same})")
            print(f"{line} (reported); |error - oracle error| {gap:.4f} "
                  f"(bound 0.5; faulty controls "
                  + ", ".join(f"{k} {v:.4f}" for k, v in controls.items())
                  + f"); agreement with the CPU backend {same:.6f}"
                  + (" (must be 1)" if not perceptual else " (reported)"))

    @jax.jit
    def batch_scores(ref, frs):
        refp = reference_pyramid(ref)
        return jax.vmap(lambda fr: ssimulacra2_from_ref(refp, fr))(frs)

    # 64 candidate frames as the search scores them: the clustered map
    # rendered under palettes moved by +-2, bound 1e-3. And 64 noisy
    # frames (+-12 per channel), bound 2e-2: there the score's variance
    # terms cancel in f32 and a 1-ulp change of a blurred moment moves it
    # by ~1e-3 to 1e-2 (PERF.md).
    pals = np.clip(pal[None] + rng.integers(-2, 3, (64,) + pal.shape), 0, 31)
    frames = {
        "palette +-2": (np.stack([
            np.asarray(render_rgb8(st.palette_map, img[..., 3], tp, p))
            for p in pals
        ]).astype(np.uint8), 1e-3),
        "noise +-12": (np.clip(
            img[None, ..., :3].astype(np.int32)
            + rng.integers(-12, 13, (64, H, W, 3)), 0, 255).astype(np.uint8),
            2e-2),
    }
    for what, (frs, bound) in frames.items():
        s_gpu, s_cpu = (on(d, batch_scores, img[..., :3], frs)
                        for d in (gpu, cpu))
        dmax = float(np.abs(s_gpu - s_cpu).max())
        check(np.isfinite(s_gpu).all() and dmax <= bound,
              f"SSIMULACRA2 of 64 {what} frames: max |dscore| {dmax} > {bound}")
        print(f"parity ssimulacra2 64 {what} frames 256x256 vs CPU backend: "
              f"max |dscore| {dmax:.3g}, mean {np.abs(s_gpu - s_cpu).mean():.3g}"
              f" (bound {bound})")


def headline_phase(tmp: pathlib.Path, card: str) -> dict:
    from bench import REFERENCE_BAND_MAX, _test_image
    from snesimage import cli
    from snesimage.io.image import save_rgba

    src = tmp / "src.png"
    save_rgba(str(src), _test_image())
    out = tmp / "out.json"
    argv = [src, out, "-c", 8, "-s", 15, "--opt-profile", "balanced"]
    cold, recs = run_main(cli.main, argv)
    errs_cold = step_errors(recs)
    warm, recs = run_main(cli.main, argv)
    errs = step_errors(recs)
    check_json(out, 8)
    check_descent(errs_cold, "headline (cold)")
    check_descent(errs, "headline (warm)")
    final = errs[-1]
    print(f"headline cli balanced 8x15 256x256: cold {cold:.3f} s, warm "
          f"{warm:.3f} s, {len(errs)} sweeps, cold and warm step errors "
          f"identical: {errs == errs_cold} [card: {card}]")
    print(f"headline compile_seconds (cold - warm): {cold - warm:.3f} "
          f"[card: {card}]")
    print(f"headline final_error {final:.4f}; in reference band "
          f"(<= {REFERENCE_BAND_MAX}): {final <= REFERENCE_BAND_MAX} "
          f"(information, not a gate); step errors "
          f"{[round(e, 4) for e in errs]}")
    return {"src": src, "cold": cold, "warm": warm, "final_error": final}


def dither_visit_seconds(jax, card: str) -> float:
    """Device time of one dithered slot visit's remap: the wavefront scan
    vmapped over 65 candidates (64 random + the current color) at 256x256
    with 8x15 palettes."""
    import jax.numpy as jnp

    from bench import _test_image
    from snesimage.ops.dither import dither_candidates

    rng = np.random.default_rng(1)
    img = _test_image()
    args = (
        jnp.asarray(img[..., :3]), jnp.asarray(img[..., 3]),
        jnp.asarray(rng.integers(0, 8, (32, 32)), jnp.int32),
        jnp.asarray(rng.integers(0, 32, (8, 15, 3)), jnp.int32),
        3, 7, jnp.asarray(rng.integers(0, 32, (65, 3)), jnp.int32),
    )
    f = jax.jit(dither_candidates, static_argnames=("perceptual",))
    jax.block_until_ready(f(*args, perceptual=False))
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        out = f(*args, perceptual=False)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n
    check(out.shape == (65, H, W), "dither_candidates shape")
    print(f"dither scan per dithered slot visit (65 candidates, 256x256, "
          f"8x15, XLA lax.scan): {dt * 1e3:.3f} ms [card: {card}]")
    return dt


def paths_phase(jax, tmp: pathlib.Path, src, card: str) -> None:
    from bench import _test_image
    from snesimage import batch_cli, cli
    from snesimage.io.image import save_rgba

    runs = (
        ("-d", ["-c", 8, "-s", 15, "-d", "--steps", 1], 8),
        ("--perceptual-palettes",
         ["-c", 8, "-s", 15, "--perceptual-palettes", "--opt-profile",
          "balanced", "--steps", 2], 8),
        ("--preset nes-compat", ["--preset", "nes-compat", "--steps", 2], 4),
    )
    for name, flags, c in runs:
        out = tmp / "path.json"
        dt, recs = run_main(cli.main, [src, out, *flags])
        errs = step_errors(recs)
        check_json(out, c)
        check(len(errs) > 0 and np.isfinite(errs).all(),
              f"{name}: errors {errs}")
        print(f"path cli {name}: {dt:.3f} s incl. compile, {len(errs)} "
              f"sweeps, final_error {errs[-1]:.4f} [card: {card}]")

    out = tmp / "robust.json"
    dt, recs = run_main(
        cli.main,
        [src, out, "-c", 8, "-s", 15, "--opt-profile", "robust", "--steps", 1],
    )
    kept = [r.args[1] for r in recs if str(r.msg).startswith("portfolio:")]
    check_json(out, 8)
    check(len(kept) == 1 and np.isfinite(kept[0]), "robust: no portfolio result")
    print(f"path cli --opt-profile robust (K=2): {dt:.3f} s incl. compile, "
          f"1 sweep, kept final_error {kept[0]:.4f} [card: {card}]")

    indir, outdir = tmp / "batch_in", tmp / "batch_out"
    indir.mkdir()
    for k in range(16):
        save_rgba(str(indir / f"img{k:02d}.png"), _test_image(seed=k + 1))
    dt, recs = run_main(
        batch_cli.main, [indir, outdir, "--preset", "nes-compat", "--steps", 1]
    )
    done = [r.args for r in recs if str(r.msg).startswith("Batch done")]
    check(len(done) == 1, "batch_cli: no batch result")
    mean_errs = done[0][2]
    check(np.isfinite(mean_errs).all(), f"batch_cli: errors {mean_errs}")
    outs = sorted(outdir.glob("*.json"))
    check(len(outs) == 16, f"batch_cli: {len(outs)} outputs")
    for o in outs:
        check_json(o, 4)
    print(f"path batch_cli 16 images NES 4x3 1 device: {dt:.3f} s incl. "
          f"compile, batch {done[0][0]:.3f} s, mean error per step "
          f"{[round(e, 4) for e in mean_errs]} [card: {card}]")
    dither_visit_seconds(jax, card)


def trace_phase(jax, out_dir: pathlib.Path, card: str) -> dict:
    """One warm headline sweep under jax.profiler."""
    from jax.profiler import ProfileData

    from bench import _test_image
    from snesimage.cli import OPT_PROFILES
    from snesimage.config import QuantConfig
    from snesimage.core import pipeline
    from snesimage.core.state import new_state
    from snesimage.utils.profiling import device_summary, hlo_kernel_ops

    cfg = QuantConfig(
        subpalette_count=8, subpalette_size=15, **OPT_PROFILES["balanced"][1]
    )
    visits = cfg.subpalette_count * cfg.subpalette_size * 3
    state, refp = pipeline._prep_fused(new_state(_test_image(), cfg), cfg)

    def sweep():
        _, summary = pipeline._optimize_fused_summary(
            state, cfg, refp, 1, 0, cfg.max_steps
        )
        return np.asarray(summary)

    sweep()
    t0 = time.perf_counter()
    s = sweep()
    untraced = time.perf_counter() - t0
    check(int(s[cfg.max_steps]) == 1, "trace: sweep count")
    trace_dir = out_dir / "trace"
    with jax.profiler.trace(str(trace_dir)):
        sweep()
    path = max(glob.glob(str(trace_dir / "plugins/profile/*/*.xplane.pb")),
               key=os.path.getmtime)
    prof = ProfileData.from_file(path)
    # Kernels run inside CUDA graphs, whose trace events carry no op
    # metadata: map kernel names to op paths through the optimized HLO
    # (a persistent-cache hit when the cache is on).
    hlo = pipeline._optimize_fused_summary.lower(
        state, cfg, refp, 1, 0, cfg.max_steps
    ).compile().as_text()
    summ = device_summary(prof, scopes=("ssimulacra2", "dither_scan"),
                          kernel_ops=hlo_kernel_ops(hlo))
    busy_s = summ["busy_ns"] * 1e-9
    metric_s = summ["scope_ns"]["ssimulacra2"] * 1e-9
    print(f"trace headline sweep (balanced 8x15, {visits} slot visits): "
          f"untraced {untraced:.4f} s = {untraced / visits * 1e3:.4f} ms "
          f"per visit; device busy {busy_s:.4f} s, idle share "
          f"{summ['idle_share']:.4f} of the device span "
          f"{summ['span_ns'] * 1e-9:.4f} s [card: {card}]")
    print(f"trace metric (ssimulacra2 scope) device time {metric_s:.4f} s "
          f"= {metric_s / visits * 1e3:.4f} ms per visit, "
          f"{metric_s / busy_s if busy_s else 0.0:.4f} of device busy time "
          f"[card: {card}]")
    print(f"trace kernel time with no op path: "
          f"{summ['unmapped_ns'] * 1e-9:.4f} s [card: {card}]")
    for name, ns, n, op in summ["top"]:
        where = op if isinstance(op, str) else "library GEMM" if op else "?"
        print(f"trace top op {name} ({str(where)[-60:]}): {ns * 1e-6:.3f} ms "
              f"in {n} events [card: {card}]")
    lines = {}
    for plane in prof.planes:
        if plane.name.startswith("/device:"):
            for ln in plane.lines:
                evs = list(ln.events)
                lines[f"{plane.name} | {ln.name}"] = {
                    "events": len(evs),
                    "sample": [
                        {"name": e.name, "ns": e.duration_ns,
                         "stats": {k: str(v)[:200] for k, v in e.stats}}
                        for e in evs[:3]
                    ],
                }
    (out_dir / "trace_summary.json").write_text(
        json.dumps({"card": card, "summary": summ, "lines": lines}, indent=1)
    )
    return summ


def gpu_tests_phase() -> None:
    import pytest

    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider", str(REPO / "tests")]
    )
    check(rc == 0, f"gpu tests: pytest exited {rc}")
    print("gpu tests: passed")


def sharded_phase(jax, n: int, card: str, n_images: int = 16) -> None:
    """The sharded batch path over `n` devices, against one device."""
    from bench import _test_image
    from snesimage.models.presets import preset_fields
    from snesimage.config import QuantConfig
    from snesimage.parallel import batch as pb

    cfg = QuantConfig(**preset_fields("nes-compat"), max_steps=2)
    imgs = np.stack([_test_image(seed=k + 1) for k in range(n_images)])
    devs = jax.devices()[:n]

    def run(mesh):
        states = pb.make_batched_states(imgs, cfg)
        if mesh is not None:
            states = pb.shard_states(states, mesh)
        states = pb.bcluster(pb.binit(states, cfg), cfg)
        init = jax.device_get(states)
        dts = []
        for _ in range(2):  # first call compiles, second is warm
            t0 = time.perf_counter()
            final, errs = pb.batched_optimize(states, cfg, mesh=mesh)
            jax.block_until_ready(final)
            dts.append(time.perf_counter() - t0)
            if len(dts) == 1:
                first = (jax.device_get(final.palette_map), errs)
        check(np.array_equal(first[0], jax.device_get(final.palette_map))
              and first[1] == errs, "batched_optimize: warm call differs")
        refp = pb.brefp(final, cfg)
        per_image = jax.vmap(
            lambda s, r: pb.refine.error_of(s, cfg, r)
        )(final, refp)
        return init, final, errs, np.asarray(per_image), dts

    mesh = pb.make_mesh(devs)
    placed = pb.shard_states(pb.make_batched_states(imgs, cfg), mesh)
    init_n, final_n, errs_n, per_n, dt_n = run(mesh)
    for what, arr in (("input", placed.palette_map),
                      ("result", final_n.palette_map)):
        shards = arr.addressable_shards
        holders = {sh.device for sh in shards}
        check(
            len(holders) == n
            and all(sh.data.shape[0] == len(imgs) // n for sh in shards),
            f"{what} state: shards {[(sh.device, sh.data.shape) for sh in shards]}"
            f" are not {n} distinct slices",
        )
    with jax.default_device(devs[0]):
        init_1, final_1, errs_1, per_1, dt_1 = run(None)
    for field in ("tile_palettes", "palette", "palette_map"):
        check(np.array_equal(getattr(init_n, field), getattr(init_1, field)),
              f"sharded init: {field} differs from one device")
    check(
        np.array_equal(np.asarray(final_n.palette_map),
                       np.asarray(final_1.palette_map)),
        "sharded result: palette_map differs from one device",
    )
    check(np.allclose(errs_n, errs_1, atol=1e-3) and
          np.allclose(per_n, per_1, atol=1e-3),
          f"sharded errors differ: {errs_n} vs {errs_1}")
    print(f"sharded batch_optimize {n_images} images NES 4x3 over {n} devices: "
          f"shards on {len(holders)} distinct devices; init and palette maps "
          f"equal to one device; errors within 1e-3 [card: {card}]")
    print(f"sharded batch_optimize {n_images} images NES 4x3, "
          f"{cfg.max_steps} sweeps: first call (incl. compile) {dt_n[0]:.3f} s "
          f"on {n} devices vs {dt_1[0]:.3f} s on one; warm {dt_n[1]:.3f} s "
          f"on {n} devices vs {dt_1[1]:.3f} s on one [card: {card}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1)
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "chip_smoke"),
                    help="directory for the trace and its summary")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import jax

    device = device_phase(jax, args.devices)
    card = card_info()
    print(f"card (nvidia-smi name, power.limit): {card}")
    import jaxlib

    print(f"device: {device['kind']} x{device['count']}, jax "
          f"{jax.__version__}, jaxlib {jaxlib.__version__}, XLA_FLAGS="
          f"{os.environ.get('XLA_FLAGS', '')!r}")
    sys.path.insert(0, str(REPO))
    from snesimage.utils.cache import enable_compile_cache

    enable_compile_cache()

    if args.devices > 1:
        sharded_phase(jax, args.devices, card)
    else:
        out_dir = pathlib.Path(args.out)
        out_dir.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory() as tmp:
            tmp = pathlib.Path(tmp)
            parity_phase(jax, card)
            head = headline_phase(tmp, card)
            paths_phase(jax, tmp, head["src"], card)
            trace_phase(jax, out_dir, card)
        gpu_tests_phase()
    print(f"total {time.perf_counter() - t_start:.1f} s [card: {card}]")
    print(last_line(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
