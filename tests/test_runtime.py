"""Runtime plumbing around the device programs: the compile cache, the
matmul precision of the resize, the GPU check of the chip smoke script and
the native libraries' build stamps."""

import ctypes
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

from image_processor_pipeline_tpu.io import native
from image_processor_pipeline_tpu.ops import geometry
from image_processor_pipeline_tpu.utils import profiling

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def cache_config(monkeypatch):
    """An accelerator backend with no cache chosen yet; restores the
    process-wide cache settings a test changes."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


class TestCompilationCache:
    def test_env_dir_is_left_to_jax(self, monkeypatch, tmp_path,
                                    cache_config):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        profiling.configure_compilation_cache()
        assert jax.config.jax_compilation_cache_dir is None

    def test_default_is_one_dir_in_the_checkout(self, cache_config):
        profiling.configure_compilation_cache()
        first = jax.config.jax_compilation_cache_dir
        profiling.configure_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == first
        assert Path(first) == REPO / ".jax_cache"

    def test_a_dir_set_through_jax_config_is_kept(self, tmp_path,
                                                  cache_config):
        jax.config.update("jax_compilation_cache_dir", str(tmp_path))
        profiling.configure_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)

    def test_nothing_is_set_outside_a_checkout(self, monkeypatch, tmp_path,
                                               cache_config):
        monkeypatch.setattr(profiling, "_CHECKOUT", tmp_path)
        profiling.configure_compilation_cache()
        assert jax.config.jax_compilation_cache_dir is None

    def test_nothing_is_set_on_the_cpu(self, monkeypatch, cache_config):
        monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
        profiling.configure_compilation_cache()
        assert jax.config.jax_compilation_cache_dir is None

    def test_the_cli_configures_it_once_before_running(self, monkeypatch,
                                                       tmp_path):
        from image_processor_pipeline_tpu import __main__ as cli

        calls = []
        monkeypatch.setattr(profiling, "configure_compilation_cache",
                            lambda: calls.append(1))
        cfg = tmp_path / "cfg.json"
        (tmp_path / "in").mkdir()
        cfg.write_text('{"root_dir": "%s", "steps": [{"name": "c", '
                       '"transform": "copy_img_with_labels", "input_dirs": '
                       '["in"], "output_dirs": ["o/i", "o/l"]}]}' % tmp_path)
        with pytest.raises(ValueError, match="empty"):
            cli.main(["run", str(cfg), "--no-progress"])
        assert calls == [1]


def test_resize_matmuls_use_highest_precision():
    img = jnp.zeros((16, 16, 3), jnp.uint8)
    jaxpr = jax.make_jaxpr(
        lambda x: geometry.resize(x, 16, 16, 9, 11, "lanczos"))(img)
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert len(dots) == 2
    for e in dots:
        assert e.params["precision"] == (jax.lax.Precision.HIGHEST,
                                         jax.lax.Precision.HIGHEST)


def test_chip_smoke_device_check_raises_on_cpu():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    assert jax.default_backend() == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.check_device()


class TestNativeBuildStamp:
    def _native_dir(self, tmp_path):
        d = tmp_path / "native"
        (d / "build").mkdir(parents=True)
        (d / "ipp_x.cpp").write_text("int x;\n")
        (d / "Makefile").write_text("all:\n")
        return d

    def test_foreign_library_is_rebuilt(self, tmp_path, monkeypatch):
        d = self._native_dir(tmp_path)
        so = d / "build" / "libx.so"
        so.write_bytes(b"built elsewhere")
        (d / "build" / "libx.so.stamp").write_text("another host")
        calls = []

        def fake_make(cmd, cwd, **kw):
            calls.append(cmd)
            so.write_bytes(b"rebuilt")
            return subprocess.CompletedProcess(cmd, 0)

        monkeypatch.setattr(native.subprocess, "run", fake_make)
        monkeypatch.setattr(native.ctypes, "CDLL", lambda p: "lib")
        lib = native.load_native_library("libx.so", "ipp_x.cpp",
                                         lambda lib: None, native_dir=d)
        assert lib == "lib"
        assert calls == [["make", "-s", "-B", "build/libx.so"]]
        assert so.read_bytes() == b"rebuilt"
        stamp = (d / "build" / "libx.so.stamp").read_text()
        assert stamp == native.build_stamp([d / "ipp_x.cpp", d / "Makefile"])

        # a matching stamp loads without building; another host rebuilds
        calls.clear()
        native.load_native_library("libx.so", "ipp_x.cpp",
                                   lambda lib: None, native_dir=d)
        assert calls == []
        monkeypatch.setattr(native, "_host_id", lambda: "other cpu")
        native.load_native_library("libx.so", "ipp_x.cpp",
                                   lambda lib: None, native_dir=d)
        assert len(calls) == 1

    def test_failed_build_never_loads_the_old_library(self, tmp_path,
                                                      monkeypatch):
        d = self._native_dir(tmp_path)
        (d / "build" / "libx.so").write_bytes(b"built elsewhere")

        def failing_make(cmd, cwd, **kw):
            raise subprocess.CalledProcessError(2, cmd)

        def no_load(path):
            raise AssertionError("a stale library was loaded")

        monkeypatch.setattr(native.subprocess, "run", failing_make)
        monkeypatch.setattr(native.ctypes, "CDLL", no_load)
        assert native.load_native_library(
            "libx.so", "ipp_x.cpp", lambda lib: None, native_dir=d) is None


def test_native_libraries_carry_current_stamps():
    """The libraries this process loaded were built from the sources in
    the checkout, on this host."""
    from image_processor_pipeline_tpu.ops import native_cpu

    if not native_cpu.available():
        pytest.skip("no C++ toolchain")
    src = native._NATIVE_DIR
    stamp = (src / "build" / "libipp_cpu.so.stamp").read_text()
    assert stamp == native.build_stamp([src / "ipp_cpu.cpp",
                                        src / "Makefile"])
    assert isinstance(native_cpu._load(), ctypes.CDLL)
