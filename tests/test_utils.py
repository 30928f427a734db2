"""Progress reporting and phase timing."""
import io
import time

from fractencode_tpu.utils import NullReporter, PhaseTimer, StdoutReporter


def test_stdout_reporter_throttles():
    buf = io.StringIO()
    r = StdoutReporter(interval=10.0, stream=buf)
    r.log(1, 100)
    r.log(2, 100)  # throttled away
    r.log(100, 100)  # final always prints
    out = buf.getvalue()
    assert "1%" in out
    assert "2%" not in out
    assert "100%" in out


def test_stdout_reporter_rewinds():
    buf = io.StringIO()
    r = StdoutReporter(interval=0.0, stream=buf)
    r.log(10, 100)
    r.log(20, 100)
    assert "\b" in buf.getvalue()  # in-place rewrite like StdoutReporter2


def test_null_reporter():
    NullReporter().log(5, 10)  # no-op, no error


def test_phase_timer():
    t = PhaseTimer()
    with t.phase("a"):
        time.sleep(0.01)
    with t.phase("b"):
        pass
    assert t.phases["a"] >= 0.01
    assert "a:" in t.report() and "total:" in t.report()


def test_compile_cache_honours_env(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set in code."""
    import jax

    from fractencode_tpu.utils.cache import setup_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert setup_compile_cache() == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_checkout_path(monkeypatch):
    """Without the env var the cache goes to <checkout>/.jax_cache: a fixed
    path (never a tmp name, pid or time), listed in .gitignore."""
    import os

    import jax

    from fractencode_tpu.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert cache.setup_compile_cache() == os.path.join(root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == cache.CACHE_DIR
        assert cache.setup_compile_cache() == cache.CACHE_DIR  # stable
        with open(os.path.join(root, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_tests_run_without_persistent_cache():
    import jax

    assert not jax.config.jax_enable_compilation_cache
