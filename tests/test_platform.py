"""The platform choice, the compile-cache location, and chip_smoke.py's
refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from tinyknn_tpu import FastPQ, IVF
from tinyknn_tpu.models.ivf import _resolve_scan_impl
from tinyknn_tpu.ops import platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((400, 16)).astype(np.float32)
    ivf = IVF("euclidean", 8, FastPQ(2, rotate_dim=None))
    return ivf.fit(X).build(X, n_probes=1)


@pytest.mark.parametrize("name, kernels, interpret",
                         [("gpu", True, False), ("cpu", False, True)])
def test_platform_choice(monkeypatch, name, kernels, interpret):
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    assert platform.platform() == name
    assert platform.use_kernels() is kernels
    assert platform.interpret() is interpret


@pytest.mark.parametrize("name", ["rocm", "metal", "neuron"])
def test_platform_refuses_others(monkeypatch, name):
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    for ask in (platform.platform, platform.use_kernels,
                platform.interpret):
        with pytest.raises(RuntimeError, match=repr(name)):
            ask()


@pytest.mark.parametrize("name, scan_impl, want", [
    ("gpu", "auto", "fused"), ("cpu", "auto", "xla"),
    ("gpu", "exact", "exact"), ("cpu", "exact", "exact_xla"),
    ("gpu", "xla", "xla"), ("cpu", "fused", "fused"),
])
def test_scan_engine_choice(monkeypatch, built, name, scan_impl, want):
    """The default engine is the kernel on the GPU and plain XLA on the
    CPU; an explicit choice is kept."""
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    monkeypatch.setattr(built, "scan_impl", scan_impl)
    assert _resolve_scan_impl(built) == want


def test_auto_falls_back_when_encoding_overflows(monkeypatch, built):
    """Lists too long for the kernel's int32 encoding go to XLA."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(built, "max_tiles", 1 << 14)
    assert _resolve_scan_impl(built) == "xla"


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    old = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in old.items():
        jax.config.update(k, v)


def test_compile_cache_default_path(monkeypatch, tmp_path,
                                    restore_cache_config):
    from tinyknn_tpu.utils import enable_compilation_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    got = enable_compilation_cache()
    assert got == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got


def test_compile_cache_honours_environment(monkeypatch, tmp_path,
                                           restore_cache_config):
    from tinyknn_tpu.utils import enable_compilation_cache
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def _smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_cpu():
    r = _smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_refuses_without_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _smoke(tmp_path, str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
