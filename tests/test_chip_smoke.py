"""chip_smoke.py's device check and result line (CPU-side contract)."""

import json
from types import SimpleNamespace

import pytest

import chip_smoke


def _jax(platform, kind, count):
    devs = [SimpleNamespace(platform=platform, device_kind=kind)] * count
    return SimpleNamespace(devices=lambda: devs)


@pytest.mark.parametrize(
    "platform,count,want,ok",
    [
        ("gpu", 1, 1, True),
        ("gpu", 4, 4, True),
        ("gpu", 1, 4, False),
        ("cpu", 8, 1, False),
        ("rocm", 1, 1, False),
    ],
)
def test_device_phase(platform, count, want, ok):
    fake = _jax(platform, "NVIDIA H100 80GB HBM3", count)
    if not ok:
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.device_phase(fake, want)
        return
    info = chip_smoke.device_phase(fake, want)
    assert info == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                    "count": count}


@pytest.mark.parametrize("count", [1, 4])
def test_last_line_format(count):
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}
    line = chip_smoke.last_line(dev)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": dev}


def test_main_refuses_without_a_gpu(monkeypatch, capsys):
    """On a machine whose JAX finds no GPU the script fails before any
    phase and prints no result line."""
    with pytest.raises(chip_smoke.SmokeFailure, match="no GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out
