"""Device mesh and sharding helpers.

The framework's scale-out model (replacing the reference's process pools,
SURVEY.md §2.4): a 1-D ``('data',)`` mesh for batch-parallel training and
basecalling.  Parameters are replicated; batches are sharded over the batch
axis; XLA's SPMD partitioner inserts the gradient ``psum`` automatically
from the sharding annotations.  A Pallas kernel is opaque to that
partitioner, so programs built for a mesh run under it as the ambient mesh
(:func:`under_mesh`) and the kernels shard themselves over its ``'data'``
axis with ``shard_map`` (:func:`data_mesh`).  Multi-host entry is
``jax.distributed.initialize`` + the same mesh over all processes' devices.
"""
import functools
import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def maybe_init_distributed():
    """Initialise the multi-host JAX runtime when launched under a
    coordinator (no-op single-host)."""
    if "JAX_COORDINATOR_ADDRESS" in os.environ or \
            "COORDINATOR_ADDRESS" in os.environ:
        jax.distributed.initialize()


def make_mesh(n_data=None, devices=None):
    """1-D data-parallel mesh over ``n_data`` devices (default: all)."""
    devices = devices if devices is not None else jax.devices()
    if n_data is not None:
        devices = devices[:n_data]
    return Mesh(np.array(devices), ("data",))


def batch_sharding(mesh, batch_axis=1):
    """Sharding for a time-major array with batch on ``batch_axis``."""
    spec = [None, None, None]
    spec[batch_axis] = "data"
    return NamedSharding(mesh, P(*spec[:3]))


def batch2_sharding(mesh, batch_axis=1):
    """Sharding for a rank-2 (time, batch) array."""
    spec = [None, None]
    spec[batch_axis] = "data"
    return NamedSharding(mesh, P(*spec))


def replicated(mesh):
    return NamedSharding(mesh, P())


def under_mesh(fn, mesh):
    """``fn`` traced and run with ``mesh`` as the ambient mesh
    (``jax.set_mesh``); identity for ``mesh=None``."""
    if mesh is None:
        return fn

    @functools.wraps(fn)
    def call(*args, **kwargs):
        with jax.set_mesh(mesh):
            return fn(*args, **kwargs)
    return call


def data_mesh():
    """The ambient mesh when it has a ``'data'`` axis over more than one
    device, else None: where a kernel must shard itself over the batch."""
    mesh = jax.sharding.get_abstract_mesh()
    if mesh.empty or "data" not in mesh.axis_names \
            or mesh.shape["data"] == 1:
        return None
    return mesh


def round_up(n, k):
    """Round ``n`` up to a multiple of ``k``."""
    return ((n + k - 1) // k) * k


def local_batch_slice(global_batch, batch_axis=1):
    """This process's slice of the batch axis under an even data-parallel
    split (device order in :func:`make_mesh` is process-major, so each
    process's shard is one contiguous block of batch columns)."""
    r, n = jax.process_index(), jax.process_count()
    lo = r * global_batch // n
    hi = (r + 1) * global_batch // n
    return slice(lo, hi)


def put_host_batch(arr, sharding, batch_axis=1):
    """Device-put a *global* batch under ``sharding``, multi-host aware.

    Single-process: plain ``device_put``.  Multi-process: every host passes
    the same global array (hosts sample with a shared seed, or concatenate
    per-host data into the same global order) and this carves out the local
    shard and assembles the distributed array via
    ``jax.make_array_from_process_local_data`` — the per-host sharded input
    path replacing the reference's process pools (SURVEY.md §2.4,
    /root/reference/sloika/iterators.py:293-351).
    """
    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    sl = [slice(None)] * arr.ndim
    sl[batch_axis] = local_batch_slice(arr.shape[batch_axis], batch_axis)
    return jax.make_array_from_process_local_data(sharding, arr[tuple(sl)],
                                                  arr.shape)
