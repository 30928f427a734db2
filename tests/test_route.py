"""The search-route resolver (encode/route.py): one module decides which
search runs, and interpret mode runs only when a caller names it."""
import dataclasses

import jax
import numpy as np
import pytest

from fractencode_tpu import EncoderConfig, encode_plane
from fractencode_tpu.encode import route


def test_auto_is_plain_route_on_cpu():
    assert jax.default_backend() == "cpu"
    assert route.resolve_route(EncoderConfig()) == "jnp"
    assert route.resolve_route(EncoderConfig(num_transforms=3)) == "jnp"


def test_auto_takes_kernel_on_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert route.resolve_route(EncoderConfig()) == "pallas"
    assert route.resolve_route(EncoderConfig(num_transforms=8)) == "pallas"
    # the kernel's frontier needs whole domain groups per column tile
    assert route.resolve_route(EncoderConfig(num_transforms=3)) == "jnp"
    assert route.resolve_route(EncoderConfig(backend="jnp")) == "jnp"


@pytest.mark.parametrize("platform", ["cpu", "METAL"])
def test_pallas_without_compiled_route_raises(monkeypatch, platform):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    with pytest.raises(ValueError, match="no compiled route"):
        route.resolve_route(EncoderConfig(backend="pallas"))


def test_pallas_raises_through_the_entry_points(rng):
    img = rng.integers(0, 256, size=(32, 32), dtype=np.uint8)
    with pytest.raises(ValueError, match="no compiled route"):
        encode_plane(img, EncoderConfig(backend="pallas"))


@pytest.mark.parametrize("platform", ["cpu", "gpu", "METAL"])
@pytest.mark.parametrize("backend", ["auto", "jnp", "pallas"])
def test_no_platform_turns_interpret_on(monkeypatch, platform, backend):
    """'pallas_interpret' comes back only when the config names it."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    try:
        got = route.resolve_route(EncoderConfig(backend=backend))
    except ValueError:
        return  # 'pallas' with no compiled route: refused, not interpreted
    assert got != "pallas_interpret"


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_interpret_by_name(monkeypatch, platform):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert route.resolve_route(
        EncoderConfig(backend="pallas_interpret")) == "pallas_interpret"


def test_kernel_refuses_odd_isometry_counts():
    with pytest.raises(ValueError, match="num_transforms"):
        route.resolve_route(
            EncoderConfig(backend="pallas_interpret", num_transforms=5))


def test_unknown_backend_rejected():
    with pytest.raises(ValueError, match="bad backend"):
        EncoderConfig(backend="mosaic")


def test_run_search_dispatches(monkeypatch, rng):
    """run_search calls the plain search on 'jnp' and the kernel (with
    interpret exactly when named) otherwise."""
    from fractencode_tpu.encode import matcher

    calls = []
    monkeypatch.setattr(matcher, "search",
                        lambda *a, **k: calls.append(("jnp", k)) or "j")
    monkeypatch.setattr(matcher, "search_kernel",
                        lambda *a, **k: calls.append(("kernel", k)) or "k")
    args = (None,) * 6
    assert route.run_search(*args, EncoderConfig(backend="jnp")) == "j"
    assert route.run_search(
        *args, EncoderConfig(backend="pallas_interpret")) == "k"
    assert calls[1][1]["interpret"] is True
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert route.run_search(*args, EncoderConfig()) == "k"
    assert calls[2][1]["interpret"] is False
    cfg = dataclasses.replace(EncoderConfig(), backend="jnp")
    assert route.run_search(*args, cfg, domain_mask="m") == "j"
    assert calls[3][1]["domain_mask"] == "m"


def test_plain_route_imports_no_kernel_code():
    """The plain search and its rank algebra (ops/rank.py) run without the
    kernel module or Pallas ever being imported."""
    import os
    import subprocess
    import sys

    code = ("import sys, numpy as np\n"
            "from fractencode_tpu import EncoderConfig, encode_plane\n"
            "encode_plane(np.zeros((32, 32), np.uint8), EncoderConfig())\n"
            "bad = [m for m in sys.modules if 'pallas' in m or "
            "m.endswith('search_kernel')]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=root)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
