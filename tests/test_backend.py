"""The capability module: kernel choice, peaks table, card report and the
compile-cache directory (CPU)."""
import os
import subprocess
import sys

import pytest

from sloika_tpu import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_auto_is_xla_on_cpu():
    assert backend.platform() == "cpu"
    assert backend.resolve_impl("auto") == "xla"


@pytest.mark.parametrize("impl", ["xla", "interpret"])
def test_explicit_choice_kept(impl):
    assert backend.resolve_impl(impl) == impl


def test_compiled_kernel_refused_off_gpu():
    with pytest.raises(ValueError, match="GPU"):
        backend.resolve_impl("pallas")


def test_unknown_choice_refused():
    with pytest.raises(ValueError, match="unknown"):
        backend.resolve_impl("mosaic")


def test_peaks_known_device():
    p = backend.peaks("NVIDIA H100 80GB HBM3")
    assert p == {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_peaks_unknown_device_is_none(kind):
    assert backend.peaks(kind) is None


def test_remap_band_exact_on_cpu():
    assert backend.remap_band() is None


def test_card_info_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert backend.card_info() is None


def _cache_dir_in_child(env_value):
    """Run init_compile_cache in a fresh interpreter; return (returned
    directory, jax_compilation_cache_dir afterwards)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = ("import jax; from sloika_tpu import backend; "
            "d = backend.init_compile_cache(); "
            "print(d); print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, check=True)
    return out.stdout.splitlines()[-2:]


def test_compile_cache_follows_env(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the code sets no other directory:
    JAX's own reading of the variable stands."""
    d = str(tmp_path / "cache")
    returned, configured = _cache_dir_in_child(d)
    assert returned == d and configured == d


def test_compile_cache_fixed_repo_dir_without_env():
    returned, configured = _cache_dir_in_child(None)
    fixed = os.path.join(REPO, ".jax_cache")
    assert returned == fixed and configured == fixed


def test_compile_cache_dir_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
