"""What runs where: the one module that looks at the device.

* :func:`resolve_impl` turns a kernel choice of ``"auto"`` into a
  compiled Pallas kernel on a GPU and into XLA on the CPU.  It is called
  eagerly, outside any jit.  XLA on the CPU is what the user asked for, not
  a fallback.  The Pallas interpreter is never chosen automatically: it is
  the explicit ``"interpret"`` that tests pass.
* :data:`PEAKS` holds published peak rates keyed by ``device_kind``;
  :func:`peaks` returns None for a device it does not know, so nothing
  divides by an assumed peak.
* :func:`card_info` reports the card's name and power limit.
* :func:`init_compile_cache` places JAX's persistent compilation cache.
"""
import os
import subprocess

import jax

IMPLS = ("auto", "pallas", "xla", "interpret")

#: published dense peaks (NVIDIA H100 SXM data sheet, without sparsity)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops_per_s": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
}

#: ``Remapper(band="auto")`` per platform: sequence positions of the banded
#: remap DP; a platform not listed runs the exact DP.  No platform is listed:
#: on an H100, batch 64 of 50k-110k-sample reads under a random-weight model,
#: band 768 with the anchor-widen retries took about twice as long as the
#: exact DP, because no read's path stayed inside the band
#: (docs/PERF.md).  A band earns an entry here once it wins, retries on, on
#: reads whose true path it covers.
REMAP_BAND = {}

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def platform():
    return jax.default_backend()


def resolve_impl(impl="auto"):
    """Resolve a kernel choice to "pallas", "xla" or "interpret"."""
    if impl not in IMPLS:
        raise ValueError("unknown implementation {!r}; choose from {}".format(
            impl, IMPLS))
    if impl == "auto":
        return "pallas" if platform() == "gpu" else "xla"
    if impl == "pallas" and platform() != "gpu":
        raise ValueError("compiled Pallas kernels need a GPU (default backend "
                         "is {!r}); use 'interpret' or 'xla'".format(platform()))
    return impl


def remap_band():
    """Band width ``Remapper(band="auto")`` resolves to on this platform."""
    return REMAP_BAND.get(platform())


def peaks(device_kind=None):
    """Published peaks of ``device_kind`` (default: the first device), or
    None when the table does not know the device."""
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    return PEAKS.get(device_kind)


def card_info():
    """``name, power.limit`` of the first GPU as nvidia-smi reports it, or
    None where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


def init_compile_cache():
    """Use ``$JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
    itself); otherwise keep the cache at the fixed ``<repo>/.jax_cache``.
    Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
