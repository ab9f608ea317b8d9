"""The persistent compile cache location and the native build rule."""

import os
import shutil
import time

import jax
import pytest

from pbdagcon_tpu import config, native

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    """Put the process-wide JAX cache settings back after the test."""
    saved = {
        k: getattr(jax.config, k)
        for k in (
            "jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
        )
    }
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_compile_cache_env_set(monkeypatch, tmp_path, restore_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache
    and enable_compile_cache sets no other path."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.compile_cache_dir() == str(tmp_path)
    before = jax.config.jax_compilation_cache_dir
    config.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_env_unset(monkeypatch, restore_cache_config):
    """Unset, the cache lives in <checkout>/.jax_cache."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = os.path.join(_CHECKOUT, ".jax_cache")
    assert config.compile_cache_dir() == path
    config.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.isdir(path)


def _stub_native(tmp_path, monkeypatch):
    """A native dir with the real Makefile and tiny stand-in sources."""
    d = tmp_path / "native"
    d.mkdir()
    shutil.copy(os.path.join(_CHECKOUT, "native", "Makefile"), d)
    for name in ("dagcon.cpp", "dazzdb.cpp"):
        (d / name).write_text(
            f'extern "C" int stub_{name[:-4]}() {{ return 1; }}\n'
        )
    monkeypatch.setattr(native, "_NATIVE_DIR", str(d))
    monkeypatch.setattr(native, "_LIB_PATH", str(d / "libdagcon.so"))
    return d


def _age(path, seconds):
    t = time.time() - seconds
    os.utime(path, (t, t))


def test_ensure_built_rebuilds_stale_library(tmp_path, monkeypatch):
    d = _stub_native(tmp_path, monkeypatch)
    lib = d / "libdagcon.so"
    for name in ("dagcon.cpp", "dazzdb.cpp"):
        _age(d / name, 300)
    assert native.ensure_built() and lib.exists()
    _age(lib, 100)  # still newer than the sources
    built = lib.stat().st_mtime
    assert native.ensure_built()  # up to date: make is a no-op
    assert lib.stat().st_mtime == built
    (d / "dagcon.cpp").touch()  # an edited source makes the library stale
    assert native.ensure_built()
    assert lib.stat().st_mtime > built


def test_ensure_built_replaces_foreign_library(tmp_path, monkeypatch):
    """A library that did not come from these sources (copied in, older
    than them) is rebuilt, never loaded as is."""
    d = _stub_native(tmp_path, monkeypatch)
    lib = d / "libdagcon.so"
    lib.write_bytes(b"not a shared object")
    _age(lib, 100)
    assert native.ensure_built()
    assert lib.read_bytes()[:4] == b"\x7fELF"


def test_ensure_built_reports_failure(tmp_path, monkeypatch):
    d = _stub_native(tmp_path, monkeypatch)
    (d / "dagcon.cpp").write_text("this is not C++\n")
    assert not native.ensure_built()
