"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Multi-chip sharding paths are validated on virtual CPU devices
(``--xla_force_host_platform_device_count``); the compiled GPU kernels run
on the card through ``chip_smoke.py``.
"""
import os

# Force CPU even when the environment points JAX at an accelerator: update
# the jax config itself too, before any backend is resolved.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.RandomState(0xDEADBEEF)


REFERENCE_DATA = "/root/reference/data"


@pytest.fixture
def reference_reads():
    import glob
    reads = sorted(glob.glob(os.path.join(REFERENCE_DATA, "reads", "*.fast5")))
    if not reads:
        pytest.skip("reference read data not available")
    return reads


@pytest.fixture(scope="session")
def simulated_reads(tmp_path_factory):
    """Four seeded simulated reads (``sloika_tpu.data.simulate``) in the
    fast5 schema: raw signal, channel scaling, a mapping table, a basecall
    event table and a per-read reference."""
    from sloika_tpu.data import simulate
    outdir = tmp_path_factory.mktemp("simulated_reads")
    _, files = simulate.simulate_read_set(str(outdir), 4, genome_len=20000,
                                          read_len=700)
    return sorted(files)
