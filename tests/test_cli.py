"""CLI surface tests (flag parity with src/config.rs + extensions)."""

import json

import numpy as np
import pytest

from snesimage.cli import build_parser, main


def test_parser_reference_flags():
    p = build_parser()
    a = p.parse_args(
        ["src.png", "out.json", "-c", "8", "-s", "15", "-d",
         "--perceptual-palettes", "--nes"]
    )
    assert a.source_filename == "src.png"
    assert a.target_filename == "out.json"
    assert a.subpalette_count == 8
    assert a.subpalette_size == 15
    assert a.dither and a.perceptual_palettes and a.nes


def test_parser_defaults():
    """Effective defaults match src/config.rs:14-18 (the parser itself uses
    None sentinels so explicit flags can override presets)."""
    from snesimage.cli import merge_geometry
    from snesimage.config import QuantConfig

    a = build_parser().parse_args(["a", "b"])
    cfg = QuantConfig(**merge_geometry(a))
    assert cfg.subpalette_count == 1  # src/config.rs:14
    assert cfg.subpalette_size == 7  # src/config.rs:18
    assert not cfg.dither and not cfg.perceptual_palettes and not cfg.nes


def test_explicit_flag_overrides_preset_even_at_default_value():
    """`--preset snes-mode1-bg12 -c 1` must honor the explicit -c 1 even
    though 1 equals the effective default (regression: default-comparison
    merging silently kept the preset's 8)."""
    from snesimage.cli import merge_geometry

    a = build_parser().parse_args(
        ["a", "b", "--preset", "snes-mode1-bg12", "-c", "1"]
    )
    g = merge_geometry(a)
    assert g["subpalette_count"] == 1
    assert g["subpalette_size"] == 15  # preset field kept


def test_preset_fields_apply_when_flags_absent():
    from snesimage.cli import merge_geometry

    a = build_parser().parse_args(["a", "b", "--preset", "nes-compat"])
    g = merge_geometry(a)
    assert g == {"subpalette_count": 4, "subpalette_size": 3, "nes": True}


@pytest.mark.slow
def test_cli_end_to_end(tmp_path, rng):
    from PIL import Image

    img = rng.integers(0, 256, (256, 256, 4)).astype(np.uint8)
    img[..., 3] = 255
    src = tmp_path / "src.png"
    Image.fromarray(img, "RGBA").save(src)
    out = tmp_path / "out.json"
    ck = tmp_path / "ck.npz"
    pv = tmp_path / "prev.png"

    rc = main(
        [str(src), str(out), "-c", "2", "-s", "3", "--steps", "0",
         "--skip-optimize", "--checkpoint", str(ck), "--preview", str(pv)]
    )
    assert rc == 0
    doc = json.loads(out.read_text())
    assert set(doc) == {"palette", "tiles", "tile_palettes"}
    assert len(doc["tiles"]) == 1024
    assert ck.exists() and pv.exists()


@pytest.mark.slow
def test_resume_stop_flags_override_and_warn(tmp_path, rng, capsys):
    """--resume honors --steps/--tol (RNG-safe stopping criteria) and
    WARNS about any other explicit flag instead of silently discarding
    it (round 5; previously `--resume ck --steps 50` silently ran the
    checkpointed budget): the resumed run performs exactly the asked-for
    extra steps, the checkpointed schedule survives an ignored
    --schedule flag, and the warning names the flag. The final
    checkpoint's step count covers the FULL history (pre-resume +
    resumed), so resuming it again keeps advancing the RNG stream."""
    from PIL import Image

    from snesimage.io.checkpoint import load_checkpoint

    img = rng.integers(0, 256, (256, 256, 4)).astype(np.uint8)
    img[..., 3] = 255
    src = tmp_path / "src.png"
    Image.fromarray(img, "RGBA").save(src)
    out = tmp_path / "out.json"
    c1 = tmp_path / "c1.npz"
    c2 = tmp_path / "c2.npz"

    rc = main([str(src), str(out), "-c", "2", "-s", "3", "--steps", "1",
               "--schedule", "channel", "--checkpoint", str(c1)])
    assert rc == 0
    capsys.readouterr()

    rc = main([str(src), str(out), "--resume", str(c1), "--steps", "2",
               "--schedule", "reference", "--checkpoint", str(c2)])
    assert rc == 0
    logs = capsys.readouterr().out
    assert "--schedule" in logs and "CHECKPOINTED" in logs

    _, cfg, meta = load_checkpoint(str(c2))
    assert meta["step"] == 3  # 1 prior + exactly the 2 asked-for steps
    assert len(meta["errors"]) == 3  # full history, prefix preserved
    assert cfg.schedule == "channel"  # checkpointed config won
    assert cfg.max_steps == 2  # the RNG-safe override was applied


@pytest.mark.slow
def test_midrun_checkpoint_counts_resumed_history(tmp_path, rng):
    """A --dump-every checkpoint written DURING a resumed run embeds the
    FULL error history (pre-resume prefix + the resumed steps so far),
    not just the local list (round 5 fix: the local count reset step to
    len(local errs), so re-resuming replayed already-evaluated RNG
    steps). A watcher thread snapshots the checkpoint as each dump
    lands; every valid snapshot must prefix-match run 1's history."""
    import shutil
    import threading
    import time as _time

    from PIL import Image

    from snesimage.io.checkpoint import load_checkpoint

    img = rng.integers(0, 256, (256, 256, 4)).astype(np.uint8)
    img[..., 3] = 255
    src = tmp_path / "src.png"
    Image.fromarray(img, "RGBA").save(src)
    out = tmp_path / "out.json"
    c1 = tmp_path / "c1.npz"
    c2 = tmp_path / "c2.npz"

    rc = main([str(src), str(out), "-c", "2", "-s", "3", "--steps", "2",
               "--schedule", "channel", "--checkpoint", str(c1)])
    assert rc == 0
    _, _, meta1 = load_checkpoint(str(c1))
    prior = [float(e) for e in meta1["errors"]]
    assert len(prior) == 2

    snapshots = []
    done = threading.Event()

    def watch():
        seen = -1.0
        while not done.is_set():
            try:
                m = c2.stat().st_mtime
            except OSError:
                _time.sleep(0.02)
                continue
            if m != seen:
                seen = m
                dst = tmp_path / f"snap_{len(snapshots)}.npz"
                try:
                    shutil.copyfile(c2, dst)
                    load_checkpoint(str(dst))  # validate (may be partial)
                except Exception:
                    seen = -1.0  # retry this mtime
                    continue
                snapshots.append(dst)
            _time.sleep(0.02)

    t = threading.Thread(target=watch, daemon=True)
    t.start()
    rc = main([str(src), str(out), "--resume", str(c1), "--steps", "3",
               "--dump-every", "1", "--checkpoint", str(c2)])
    done.set()
    t.join(timeout=10)
    assert rc == 0
    assert snapshots, "watcher never captured a checkpoint"
    for snap in snapshots:
        _, _, meta = load_checkpoint(str(snap))
        errs = [float(e) for e in meta["errors"]]
        # global accounting: prefix-preserving, step == total history
        assert int(meta["step"]) == len(errs)
        assert len(errs) > len(prior)
        assert errs[: len(prior)] == pytest.approx(prior)


@pytest.mark.slow
def test_portfolio_warns_ignored_interactive_flags(tmp_path, rng, capsys):
    """--portfolio K>1 runs fused on-device with no per-step host hook;
    interactive flags are warned about instead of silently dropped
    (round 5; especially surprising under --opt-profile robust, which
    sets K=2 implicitly)."""
    from PIL import Image

    img = rng.integers(0, 256, (256, 256, 4)).astype(np.uint8)
    img[..., 3] = 255
    src = tmp_path / "src.png"
    Image.fromarray(img, "RGBA").save(src)
    rc = main([str(src), str(tmp_path / "o.json"), "-c", "2", "-s", "3",
               "--steps", "1", "--schedule", "channel", "--portfolio", "2",
               "--dump-every", "1"])
    assert rc == 0
    logs = capsys.readouterr().out
    assert "--dump-every" in logs and "ignored with --portfolio" in logs


def test_cli_wrong_size_fails(tmp_path, rng):
    from PIL import Image

    img = rng.integers(0, 256, (64, 64, 4)).astype(np.uint8)
    src = tmp_path / "small.png"
    Image.fromarray(img, "RGBA").save(src)
    rc = main([str(src), str(tmp_path / "out.json")])
    assert rc == 1


def test_checkpoint_exact_path_and_atomic(tmp_path, rng):
    """save_checkpoint writes to EXACTLY the requested path (round 5 fix:
    np.savez silently appended '.npz', so `--checkpoint run.ckpt` landed
    at run.ckpt.npz and `--resume run.ckpt` failed) and atomically (no
    .tmp remnant; a kill mid-write can't destroy the previous good
    file)."""
    from snesimage.config import QuantConfig
    from snesimage.core.state import new_state
    from snesimage.io.checkpoint import load_checkpoint, save_checkpoint

    img = rng.integers(0, 256, (64, 64, 4)).astype(np.uint8)
    img[..., 3] = 255
    cfg = QuantConfig(subpalette_count=2, subpalette_size=3, width=64,
                      height=64)
    st = new_state(img, cfg)
    path = tmp_path / "run.ckpt"  # no .npz extension on purpose
    save_checkpoint(str(path), st, cfg, errors=[1.0, 2.0], step=2)
    assert path.exists()
    assert not (tmp_path / "run.ckpt.npz").exists()
    assert not (tmp_path / "run.ckpt.tmp").exists()
    _, cfg2, meta = load_checkpoint(str(path))
    assert meta["step"] == 2 and cfg2 == cfg


def test_batch_cli_input_validation(tmp_path, rng):
    """Batch CLI fail-fast guards (round 5): colliding output stems,
    --host-id without --num-hosts, bad --limit — all exit 1 with a clear
    message; an empty multi-host shard is a clean exit 0, not an error."""
    from PIL import Image

    from snesimage.batch_cli import main as batch_main

    indir = tmp_path / "in"
    outdir = tmp_path / "out"
    indir.mkdir()
    img = rng.integers(0, 256, (256, 256, 4)).astype(np.uint8)
    img[..., 3] = 255
    Image.fromarray(img, "RGBA").save(indir / "a.png")

    # stem collision: a.png + a.jpg would both write a.json
    Image.fromarray(img[..., :3], "RGB").save(indir / "a.jpg")
    rc = batch_main([str(indir), str(outdir), "--steps", "0"])
    assert rc == 1
    (indir / "a.jpg").unlink()

    rc = batch_main([str(indir), str(outdir), "--host-id", "1"])
    assert rc == 1
    rc = batch_main([str(indir), str(outdir), "--limit", "0"])
    assert rc == 1
    rc = batch_main([str(indir), str(outdir), "--limit", "-1"])
    assert rc == 1

    # 1 image over 4 hosts: hosts 1-3 get empty shards — clean no-op
    rc = batch_main([str(indir), str(outdir), "--num-hosts", "4",
                     "--host-id", "3"])
    assert rc == 0
    assert not outdir.exists() or not list(outdir.glob("*.json"))


@pytest.mark.slow
def test_batch_cli_end_to_end(tmp_path, rng):
    from PIL import Image

    from snesimage.batch_cli import main as batch_main

    indir = tmp_path / "in"
    outdir = tmp_path / "out"
    indir.mkdir()
    for i in range(2):
        img = rng.integers(0, 256, (256, 256, 4)).astype(np.uint8)
        img[..., 3] = 255
        Image.fromarray(img, "RGBA").save(indir / f"img{i}.png")

    rc = batch_main([str(indir), str(outdir), "-c", "2", "-s", "3", "--steps", "1"])
    assert rc == 0
    for i in range(2):
        doc = json.loads((outdir / f"img{i}.json").read_text())
        assert len(doc["tiles"]) == 1024
        assert len(doc["palette"]) == 32


def test_batch_cli_empty_dir(tmp_path):
    from snesimage.batch_cli import main as batch_main

    (tmp_path / "empty").mkdir()
    rc = batch_main([str(tmp_path / "empty"), str(tmp_path / "out")])
    assert rc == 1


def test_presets():
    from snesimage.models import PRESETS, get_preset

    cfg = get_preset("snes-mode1-bg12")
    assert (cfg.subpalette_count, cfg.subpalette_size) == (8, 15)
    cfg = get_preset("nes-compat")
    assert cfg.nes and (cfg.subpalette_count, cfg.subpalette_size) == (4, 3)
    cfg = get_preset("nes-compat", subpalette_size=7)
    assert cfg.subpalette_size == 7
    assert len(PRESETS) >= 6
    import pytest as _pytest

    with _pytest.raises(ValueError):
        get_preset("bogus")


def test_parser_preset_flag():
    a = build_parser().parse_args(["a", "b", "--preset", "nes-compat"])
    assert a.preset == "nes-compat"


def test_shard_paths_round_robin():
    """Multi-host file sharding (docs/adr/0001-multihost.md): round-robin,
    disjoint, complete, sizes within one of each other."""
    from snesimage.batch_cli import shard_paths

    paths = [f"img{i:03}.png" for i in range(10)]
    shards = [shard_paths(paths, 3, k) for k in range(3)]
    assert sorted(sum(shards, [])) == paths
    assert {len(s) for s in shards} <= {3, 4}
    assert shards[0] == ["img000.png", "img003.png", "img006.png", "img009.png"]
    with pytest.raises(ValueError):
        shard_paths(paths, 3, 3)
    assert shard_paths(paths, 1, 0) == paths


def test_batch_cli_tuned_knobs_parse():
    """batch_cli accepts the tuned recipe knobs (--tol/--channel-explore/
    --gate-margin/--accept-margin/--opt-profile) with the same None-sentinel
    override layering as the single-image CLI."""
    from snesimage.batch_cli import build_parser as batch_parser

    a = batch_parser().parse_args(
        ["in", "out", "--opt-profile", "quality", "--tol", "0.2",
         "--channel-explore", "8", "--accept-margin", "0.01",
         "--gate-margin", "0.02", "--channel-window", "4"]
    )
    assert a.opt_profile == "quality"
    assert a.tol == 0.2 and a.channel_explore == 8
    assert a.accept_margin == 0.01 and a.gate_margin == 0.02
    assert a.channel_window == 4
    # defaults stay None sentinels so profiles can fill them
    a = batch_parser().parse_args(["in", "out"])
    assert a.steps is None and a.tol is None and a.schedule is None
    assert a.prescreen is None and a.gate_margin is None


def test_cli_reassign_and_dump_flags_parse(tmp_path):
    a = build_parser().parse_args(
        ["a", "b", "--reassign-tiles", "spec.txt", "--dump-every", "2"]
    )
    assert a.reassign_tiles == "spec.txt"
    assert a.dump_every == 2


@pytest.mark.slow
def test_cli_midrun_reassign(tmp_path, rng):
    """A --reassign-tiles file EDITED WHILE THE OPTIMIZER RUNS takes
    effect (the reference GUI accepts tile clicks at any moment of the
    optimization phase, src/lib.rs:1005-1024): with --dump-every 1 the
    CLI re-reads the file each step and applies it when its mtime
    changed. The pre-run spec sets tile (0,0) to subpalette 1; a writer
    thread rewrites the file to (0,0)->0, (1,0)->1 as soon as the first
    mid-run dump lands; the final JSON must show the REWRITTEN
    assignment (nothing else mutates tile_palettes)."""
    import threading
    import time as _time

    from PIL import Image

    img = rng.integers(0, 256, (256, 256, 4)).astype(np.uint8)
    img[..., 3] = 255
    src = tmp_path / "src.png"
    Image.fromarray(img, "RGBA").save(src)
    out = tmp_path / "out.json"
    spec = tmp_path / "spec.txt"
    spec.write_text("0 0 1\n")

    def rewrite_after_first_dump():
        deadline = _time.time() + 300
        while not out.exists() and _time.time() < deadline:
            _time.sleep(0.02)
        spec.write_text("0 0 0\n1 0 1\n")

    t = threading.Thread(target=rewrite_after_first_dump, daemon=True)
    t.start()
    rc = main(
        [str(src), str(out), "-c", "2", "-s", "3", "--steps", "4",
         "--schedule", "channel", "--dump-every", "1",
         "--reassign-tiles", str(spec)]
    )
    t.join(timeout=10)
    assert rc == 0
    doc = json.loads(out.read_text())
    # tile_palettes is the 32x32 grid row-major: index 0 = (0,0), 1 = (1,0)
    assert doc["tile_palettes"][0] == 0
    assert doc["tile_palettes"][1] == 1


def test_opt_profile_resolution():
    """--opt-profile applies the measured recipe; explicit flags override
    individual profile fields; no profile keeps reference defaults."""
    from snesimage.cli import OPT_PROFILES, build_parser
    from snesimage.config import QuantConfig

    def resolve(argv):
        a = build_parser().parse_args(argv)
        opt = dict(OPT_PROFILES[a.opt_profile][1]) if a.opt_profile else {}
        opt.update({
            k: v for k, v in dict(
                max_steps=a.steps, converge_tol=a.tol, schedule=a.schedule,
                channel_explore=a.channel_explore, prescreen=a.prescreen,
                prescreen_full=a.prescreen_full, gate_margin=a.gate_margin,
                accept_margin=a.accept_margin,
            ).items() if v is not None
        })
        return QuantConfig(**opt)

    cfg = resolve(["a", "b"])
    assert cfg.schedule == "reference" and cfg.prescreen == 0
    assert cfg.max_steps == 8 and cfg.converge_tol == 0.0

    cfg = resolve(["a", "b", "--opt-profile", "fast"])
    assert cfg.schedule == "channel" and cfg.prescreen == 8
    assert cfg.prescreen_full == 2 and cfg.gate_margin == 0.01
    assert cfg.converge_tol == 0.5 and cfg.max_steps == 10

    cfg = resolve(["a", "b", "--opt-profile", "quality"])
    assert cfg.channel_explore == 16 and cfg.converge_tol == 0.1
    assert cfg.gate_margin == 0.0  # config guard: no gate on deep runs
    assert cfg.accept_margin == 0.005
    cfg = resolve(["a", "b", "--opt-profile", "quality",
                   "--accept-margin", "0"])
    assert cfg.accept_margin == 0.0  # explicit 0 overrides the profile

    # explicit flag beats the profile field
    cfg = resolve(["a", "b", "--opt-profile", "fast", "--tol", "0.3",
                   "--prescreen", "12"])
    assert cfg.converge_tol == 0.3 and cfg.prescreen == 12
    assert cfg.schedule == "channel"  # untouched profile field survives

    # balanced = the headline recipe: the quality
    # fields on a FIXED 8-step budget (tol 0 = no plateau test).
    cfg = resolve(["a", "b", "--opt-profile", "balanced"])
    assert cfg.channel_explore == 16 and cfg.accept_margin == 0.005
    assert cfg.max_steps == 8 and cfg.converge_tol == 0.0
    assert cfg.prescreen == 8 and cfg.prescreen_full == 2
    cfg = resolve(["a", "b", "--opt-profile", "balanced", "--steps", "10"])
    assert cfg.max_steps == 10  # explicit budget still overrides

    # robust = the balanced recipe dispatched as a K=2 seed portfolio
    # (round 5; the K default is resolved in main(), tested below).
    assert OPT_PROFILES["robust"][1] == OPT_PROFILES["balanced"][1]


def test_robust_profile_portfolio_default(tmp_path):
    """--opt-profile robust defaults --portfolio to 2; an explicit
    --portfolio always wins; other profiles keep the default of 1; the
    batch CLI rejects the profile (portfolio is a single-image shape)."""
    from snesimage import cli

    def resolved_k(argv):
        return cli.resolve_portfolio_k(cli.build_parser().parse_args(argv))

    assert resolved_k(["a", "b"]) == 1
    assert resolved_k(["a", "b", "--opt-profile", "balanced"]) == 1
    assert resolved_k(["a", "b", "--opt-profile", "robust"]) == 2
    assert resolved_k(["a", "b", "--opt-profile", "robust",
                       "--portfolio", "4"]) == 4
    assert resolved_k(["a", "b", "--opt-profile", "robust",
                       "--portfolio", "1"]) == 1

    from snesimage.batch_cli import main as batch_main

    indir = tmp_path / "in"
    indir.mkdir()
    rc = batch_main([str(indir), str(tmp_path / "out"),
                     "--opt-profile", "robust"])
    assert rc == 1


def test_hybrid_profile_cli(tmp_path):
    """--opt-profile hybrid: phase 2 fields come from the profile dict
    (same as 'quality'); --portfolio is rejected (exit-1 contract); the
    batch CLI rejects the profile outright (one fused config per batch)."""
    from snesimage.cli import OPT_PROFILES

    assert OPT_PROFILES["hybrid"][1] == OPT_PROFILES["quality"][1]

    # rejection happens before the source file is read
    rc = main(
        ["/nonexistent.png", str(tmp_path / "o.json"),
         "--opt-profile", "hybrid", "--portfolio", "2"]
    )
    assert rc == 1

    from snesimage.batch_cli import main as batch_main

    indir = tmp_path / "in"
    outdir = tmp_path / "out"
    indir.mkdir()
    rc = batch_main([str(indir), str(outdir), "--opt-profile", "hybrid"])
    assert rc == 1
