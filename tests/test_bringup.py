"""Start-up code of the GPU scripts: compile-cache placement, device
checks, the benchmark's peak table, and ``chip_smoke.py`` refusing to
run without a GPU."""

import os
import subprocess
import sys

import jax
import pytest

from densityflows_tpu.utils import runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_defaults_to_checkout(monkeypatch, tmp_path,
                                        restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.enable_compile_cache(str(tmp_path))
    assert path == os.path.join(str(tmp_path), ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_cache_dir_env_wins(monkeypatch, tmp_path, restore_cache_dir):
    env = str(tmp_path / "from_env")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache(str(tmp_path)) == env
    assert jax.config.jax_compilation_cache_dir == before  # set nothing


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        runtime.require_gpu()


@pytest.fixture(scope="module")
def bench():
    sys.path.insert(0, ROOT)
    import bench as mod

    return mod


@pytest.mark.parametrize("kind,bf16,tf32", [
    ("NVIDIA H100 80GB HBM3", 989e12, 495e12),
    ("NVIDIA H100 PCIe", 756e12, 378e12),
    ("NVIDIA H200", 989e12, 495e12),
])
def test_peaks_known_kinds(bench, kind, bf16, tf32):
    peaks = bench.device_peaks(kind)
    assert peaks["bf16_flops"] == bf16 and peaks["tf32_flops"] == tf32


def test_peaks_unknown_kind_raises(bench):
    with pytest.raises(KeyError, match="no published peaks"):
        bench.device_peaks("cpu")


@pytest.mark.parametrize("args", [[], ["--four-cards"]])
def test_chip_smoke_fails_without_gpu(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
