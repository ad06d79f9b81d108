"""Multi-chip batch sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from snesimage.config import QuantConfig
from snesimage.parallel import batch as pb


def _images(rng, b=8, h=64, w=64):
    imgs = rng.integers(0, 256, (b, h, w, 4)).astype(np.uint8)
    imgs[..., 3] = 255
    return imgs


def test_mesh_has_8_devices():
    mesh = pb.make_mesh()
    assert mesh.devices.size == 8


@pytest.mark.slow
def test_batched_run_sharded(rng):
    imgs = _images(rng)
    cfg = QuantConfig(subpalette_count=2, subpalette_size=3, width=64, height=64,
                      max_steps=1)
    mesh = pb.make_mesh()
    states, errors = pb.batched_run(imgs, cfg, mesh=mesh, max_steps=1)
    assert states.palette.shape == (8, 2, 3, 3)
    assert len(errors) == 1
    assert np.isfinite(errors[0])


def test_batched_matches_single(rng):
    """Sharded batched execution must produce the same result as running
    each image through the single-image pipeline."""
    from snesimage.core import pipeline
    from snesimage.core.state import new_state

    imgs = _images(rng, b=2)
    cfg = QuantConfig(subpalette_count=1, subpalette_size=3, width=64, height=64,
                      max_steps=1)

    states = pb.make_batched_states(imgs, cfg)
    states = pb.binit(states, cfg)
    states = pb.bcluster(states, cfg)

    for b in range(2):
        st = new_state(imgs[b], cfg)
        st = pipeline.initialize(st, cfg)
        st = pipeline.cluster(st, cfg)
        np.testing.assert_array_equal(
            np.asarray(states.palette[b]), np.asarray(st.palette)
        )
        np.testing.assert_array_equal(
            np.asarray(states.palette_map[b]), np.asarray(st.palette_map)
        )


def test_sharding_actually_partitions(rng):
    imgs = _images(rng)
    cfg = QuantConfig(subpalette_count=1, subpalette_size=3, width=64, height=64)
    mesh = pb.make_mesh()
    states = pb.make_batched_states(imgs, cfg)
    states = pb.shard_states(states, mesh)
    shards = states.original.addressable_shards
    assert len(shards) == 8
    assert shards[0].data.shape[0] == 1  # 8 images over 8 devices


@pytest.mark.slow
def test_batched_pad_replicas_excluded_from_mean(rng):
    """n_real excludes mesh-padding replicas from the reported per-step
    mean error: a batch of [A, B] with n_real=1 must report A's errors,
    not the A/B mean."""
    imgs = _images(rng, b=2)
    cfg = QuantConfig(subpalette_count=2, subpalette_size=3, width=64,
                      height=64, max_steps=1)
    _, errs_real1 = pb.batched_run(imgs, cfg, max_steps=1, n_real=1)
    _, errs_a_alone = pb.batched_run(imgs[:1], cfg, max_steps=1)
    _, errs_both = pb.batched_run(imgs, cfg, max_steps=1)
    assert abs(errs_real1[0] - errs_a_alone[0]) < 1e-3
    assert abs(errs_both[0] - errs_real1[0]) > 1e-3  # B actually differs


@pytest.mark.slow
def test_batched_converge_tol_stops_early(rng):
    """The batched fused loop's plateau rule: with a huge tol the run
    stops after cycle+1 sweeps instead of burning the full budget."""
    imgs = _images(rng, b=2)
    cfg = QuantConfig(subpalette_count=2, subpalette_size=3, width=64,
                      height=64, max_steps=6, schedule="channel",
                      converge_tol=1e9)
    _, errors = pb.batched_run(imgs, cfg)
    # channel schedule: cycle=1, so the stop can fire at step 2.
    assert len(errors) == 2, errors
    cfg0 = QuantConfig(subpalette_count=2, subpalette_size=3, width=64,
                       height=64, max_steps=6, schedule="channel")
    _, errors0 = pb.batched_run(imgs, cfg0)
    assert len(errors0) == 6


@pytest.mark.slow
def test_batched_channel_explore_draws_keys(rng):
    """channel_explore in the batched loop draws per-image keys: the
    explore run's trajectory must diverge from the deterministic sweep
    while never ending worse (strict-less-than acceptance)."""
    imgs = _images(rng, b=2)
    base = dict(subpalette_count=2, subpalette_size=3, width=64, height=64,
                max_steps=2, schedule="channel")
    _, errs_det = pb.batched_run(imgs, QuantConfig(**base))
    _, errs_exp = pb.batched_run(
        imgs, QuantConfig(**base, channel_explore=8)
    )
    assert errs_exp[-1] <= errs_det[-1] + 1e-3


def test_portfolio_degenerate_detection():
    """portfolio_seeds_degenerate: K seeds only diverge through random
    visits or channel-explore draws; the deterministic schedules (plain
    channel descent, NES sweep) run K identical trajectories, and
    portfolio_run warns rather than silently multiplying cost by K
    (found on chip: an 8-seed channel portfolio returned eight copies of
    the same final error)."""
    base = dict(subpalette_count=2, subpalette_size=3, width=64, height=64)
    assert pb.portfolio_seeds_degenerate(
        QuantConfig(**base, schedule="channel")
    )
    assert pb.portfolio_seeds_degenerate(QuantConfig(**base, nes=True))
    assert not pb.portfolio_seeds_degenerate(
        QuantConfig(**base, schedule="channel", channel_explore=8)
    )
    assert not pb.portfolio_seeds_degenerate(QuantConfig(**base))  # reference


@pytest.mark.slow
def test_portfolio_channel_explore_diverges(rng):
    """The channel-schedule portfolio draws PER-SEED explore keys
    (round-5 fix: sweep_channel's key=None silently disabled explore and
    all K trajectories collapsed into one — observed as identical
    per-seed finals on chip)."""
    imgs = _images(rng, b=1)
    cfg = QuantConfig(
        subpalette_count=2, subpalette_size=3, width=64, height=64,
        max_steps=2, schedule="channel", channel_explore=8,
    )
    _, seed_errs, _ = pb.portfolio_run(imgs[0], cfg, 3)
    assert seed_errs.shape == (3,)
    assert len(set(np.round(seed_errs, 4))) > 1, seed_errs


@pytest.mark.slow
def test_portfolio_keeps_best_seed(rng):
    """portfolio_run optimizes K RNG trajectories of one image and returns
    the one with the minimum final error."""
    from snesimage.core.refine import error_of, make_reference_pyramid

    img = _images(rng, b=1)[0]
    cfg = QuantConfig(
        subpalette_count=2, subpalette_size=3, width=64, height=64,
        max_steps=1, dither=True,
    )
    best, seed_errs, steps = pb.portfolio_run(img, cfg, 3)
    assert seed_errs.shape == (3,)
    # trajectories actually diverged (random steps draw per-seed keys)
    assert len(set(np.round(seed_errs, 4))) > 1
    refp = make_reference_pyramid(best)
    got = float(error_of(best, cfg, refp))
    assert abs(got - float(seed_errs.min())) < 1e-3


def test_portfolio_converge_tol_stops_early(rng):
    """The portfolio loop honors converge_tol on the SEED-MEAN error
    (round 5; previously --portfolio silently ignored --tol): with a
    huge tol the run stops after cycle+1 steps."""
    imgs = _images(rng, b=1)
    cfg = QuantConfig(subpalette_count=2, subpalette_size=3, width=64,
                      height=64, max_steps=6, schedule="channel",
                      channel_explore=4, converge_tol=1e9)
    _, _, steps = pb.portfolio_run(imgs[0], cfg, 2)
    assert len(steps) == 2, steps


@pytest.mark.parametrize("path", ["portfolio", "batch"])
def test_step_budget_is_a_prefix(rng, path):
    """One compiled loop serves any step budget up to the config's: a run
    cut to 1 step reports the first step of the 3-step run, and the loop
    stops where the budget says."""
    imgs = _images(rng, b=2)
    cfg = QuantConfig(subpalette_count=2, subpalette_size=3, width=64,
                      height=64, max_steps=3, schedule="channel",
                      channel_explore=4)

    def steps(n):
        if path == "portfolio":
            return pb.portfolio_run(imgs[0], cfg, 2, max_steps=n)[2]
        states = pb.bcluster(pb.binit(pb.make_batched_states(imgs, cfg), cfg), cfg)
        return pb.batched_optimize(states, cfg, max_steps=n)[1]

    full, cut = steps(3), steps(1)
    assert len(full) == 3 and len(cut) == 1, (full, cut)
    assert cut[0] == full[0]


def test_batched_run_gated_config(rng):
    """The image-batched path must run gated configs (--opt-profile fast
    on benchmarks/batch_cli): sweeps are called with the STATIC
    gate=False, so gate_base_fused is never traced under the image vmap
    and every batched visit scores exactly."""
    imgs = _images(rng, b=2)
    cfg = QuantConfig(subpalette_count=2, subpalette_size=3, width=64,
                      height=64, max_steps=2, schedule="channel",
                      prescreen=8, prescreen_full=2, gate_margin=0.01,
                      converge_tol=0.5)
    assert cfg.gate_margin > 0
    states, errors = pb.batched_run(imgs, cfg)
    assert 1 <= len(errors) <= 2
    assert np.isfinite(errors).all()


def test_batched_run_forwards_mesh(rng, monkeypatch):
    """batched_run forwards its mesh to batched_optimize, which keeps
    the batch on that mesh."""
    captured = {}
    orig = pb.batched_optimize

    def spy(states, config, *, mesh=None, **kw):
        captured["mesh"] = mesh
        return orig(states, config, mesh=mesh, **kw)

    monkeypatch.setattr(pb, "batched_optimize", spy)
    mesh = pb.make_mesh()
    imgs = _images(rng, b=mesh.devices.size)
    cfg = QuantConfig(subpalette_count=2, subpalette_size=3, width=64,
                      height=64, max_steps=1, schedule="channel")
    pb.batched_run(imgs, cfg, mesh=mesh)
    assert captured["mesh"] is mesh


def test_portfolio_gated_config_runs(rng):
    """A gated config (--opt-profile fast: gate_margin + tol >= 0.25,
    explore off on the channel schedule) must run as a portfolio: the
    portfolio sweeps pass the static gate=False like every batched path
    (`--opt-profile fast --portfolio K`), which also keeps the seed-mean
    plateau stop sound (exact sweeps need no confirmation pass)."""
    imgs = _images(rng, b=1)
    cfg = QuantConfig(subpalette_count=2, subpalette_size=3, width=64,
                      height=64, max_steps=2, schedule="channel",
                      prescreen=8, prescreen_full=2, gate_margin=0.01,
                      converge_tol=0.5)
    assert cfg.gate_margin > 0  # the guard must not have disabled it
    _, seed_errs, steps = pb.portfolio_run(imgs[0], cfg, 2)
    assert seed_errs.shape == (2,)
    assert np.isfinite(seed_errs).all()
    assert 1 <= len(steps) <= 2


@pytest.mark.slow
def test_two_process_multihost_batch(tmp_path, rng):
    """Multi-host scale-out, one notch past the unit-tested shard math:
    TWO concurrent batch_cli processes, each acting
    as one host of a --num-hosts 2 run over the same input directory,
    must process disjoint, jointly complete file shards end-to-end
    (docs/adr/0001-multihost.md: per-host file sharding, no cross-host
    communication — so real multi-process execution IS the design)."""
    import json
    import os
    import subprocess
    import sys

    from snesimage.io.image import save_rgba

    indir = tmp_path / "in"
    indir.mkdir()
    for i in range(4):
        img = rng.integers(0, 256, (256, 256, 4)).astype(np.uint8)
        img[..., 3] = 255
        save_rgba(str(indir / f"img{i}.png"), img)

    env = dict(os.environ)
    # Two JAX processes at once: CPU only (two processes on one GPU would
    # each try to reserve most of its memory).
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

    procs = []
    for host_id in range(2):
        outdir = tmp_path / f"out{host_id}"
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, "-m", "snesimage.batch_cli",
                    str(indir), str(outdir), "-c", "1", "-s", "2",
                    "--steps", "1", "--schedule", "channel",
                    "--num-hosts", "2", "--host-id", str(host_id),
                ],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]

    # Disjoint shards, jointly complete (round-robin over sorted names).
    shard_names = [
        sorted(f.name for f in (tmp_path / f"out{h}").glob("*.json"))
        for h in range(2)
    ]
    assert shard_names[0] == ["img0.json", "img2.json"]
    assert shard_names[1] == ["img1.json", "img3.json"]
    for h in range(2):
        for f in (tmp_path / f"out{h}").glob("*.json"):
            doc = json.loads(f.read_text())
            assert len(doc["tiles"]) == 1024
            assert len(doc["tile_palettes"]) == 1024
