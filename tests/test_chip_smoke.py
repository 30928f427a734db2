"""chip_smoke.py: its refusal without a GPU, and every phase rehearsed on
the CPU at small sizes (plain route, or the kernel in the interpreter)."""
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_without_gpu():
    r = _run(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert '"ok"' not in r.stdout and "phase" not in r.stdout


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "WORKDIR", str(tmp_path))
    return tmp_path


def test_kernel_parity_phase_interpreted():
    configs = (("64_default", 0, 64, {}),
               ("64_batch2", 2, 64, {}),
               ("64_full8", 0, 64, dict(target_size=8, num_transforms=8,
                                        use_classifier=False)),
               ("64_target16", 0, 64, dict(source_size=32, target_size=16)),
               ("64_rms", 0, 64, dict(rms_threshold=20.0)))
    out = chip_smoke.kernel_parity(configs, kernel="pallas_interpret")
    assert set(out) == {c[0] for c in configs}


def test_reference_parity_phase_interpreted():
    out = chip_smoke.reference_parity(backend="pallas_interpret")
    assert out["winners"] == "bitwise" and out["max_pixel_diff"] == 0


@pytest.mark.parametrize("phase,kw", [
    ("cli_gray", dict(size=128)),
    ("cli_color", dict(width=96, height=64)),
    ("cli_quadtree", dict(size=128)),
    ("lib_plane", dict(size=128)),
    ("lib_batch", dict(batch=2, size=128)),
])
def test_main_path_phases_small(workdir, phase, kw):
    out = getattr(chip_smoke, phase)(backend="jnp", **kw)
    assert out["psnr"] > 15.0 and 0.0 < out["bpp"] < 8.0


def test_phase_failure_is_reported_not_swallowed(capsys):
    clock = chip_smoke.CompileClock()

    def boom():
        raise RuntimeError("broken")

    assert chip_smoke.run_phase("x", boom, clock) is False
    assert chip_smoke.run_phase("lib_plane", lambda: dict(psnr=1.0, bpp=1.0),
                                clock) is False
    assert chip_smoke.run_phase("y", lambda: dict(bpp=1.0), clock) is True
    out = capsys.readouterr().out
    assert "phase x: FAILED" in out and "below the floor" in out


def test_four_cards_phase_on_virtual_devices():
    """The --four-cards comparisons on 4 virtual CPU devices."""
    devices = jax.devices()[:4]
    assert len(devices) == 4
    out = chip_smoke.four_cards(devices, batch_size=64, halo_size=128,
                                backend="jnp")
    assert out["spans"] == 4 and out["bitwise_equal_to_one_card"] == 12
