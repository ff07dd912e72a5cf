"""Device-mesh helpers.

The JAX replacement for the reference's dead mpi4py layer
(nsigproclib_no_mpi.py:315-877): a 2-D logical mesh over axes

* ``'t'`` — time blocks (the reference's ``DivideByNP`` snapshot partition,
  nsigproclib:485-504);
* ``'s'`` — inlet-plane z tiles (spatial domain decomposition for the filter
  halo region).

On one host the GPUs are joined all to all, so the mesh shape follows the
algorithm alone; :func:`make_mesh` takes the first ``t*s`` devices in order.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: F401


def make_mesh(shard_time: int = 1, shard_space: int = 1, devices=None) -> Mesh:
    devices = jax.devices() if devices is None else devices
    n = shard_time * shard_space
    if n > len(devices):
        raise ValueError(
            f"mesh {shard_time}x{shard_space} needs {n} devices, "
            f"have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(shard_time, shard_space)
    return Mesh(dev, axis_names=("t", "s"))


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-host initialization (``jax.distributed.initialize``) — the
    rebuild of the reference's ``MPI.Init``-era entry (its mpi4py import is
    disabled, nsigproclib_no_mpi.py:6).  On GPU and CPU hosts pass all
    three arguments: ``coordinator_address`` is ``host:port`` of process
    0.  Safe to call more than once."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    except RuntimeError as e:
        if "already initialized" not in str(e):
            raise


def global_mesh(shard_time: int = 1, shard_space: int = 0) -> Mesh:
    """Mesh over *all* global devices (multi-host): lay the 's' axis within
    hosts and 't' across hosts — plane-tile halo exchanges ride the
    intra-host links, while time blocks need no communication at all
    during generation.  ``shard_space=0`` -> all remaining devices."""
    n = len(jax.devices())
    if shard_space == 0:
        if n % shard_time:
            raise ValueError(f"{n} devices not divisible by shard_time={shard_time}")
        shard_space = n // shard_time
    return make_mesh(shard_time, shard_space)


def hard_sync(x):
    """Wait until every addressable shard of ``x`` is computed — the sync
    point that ends each pipeline stage and bounds dispatch run-ahead in
    the streaming passes.  Shards on other processes' devices (under
    ``jax.distributed``) are waited for by their own process."""
    return jax.block_until_ready(x)


def to_host(x, dtype=np.float64) -> np.ndarray:
    """Fetch a (possibly multi-process) global array to every host.

    Single-process arrays (incl. any fully-addressable sharded array on the
    virtual CPU mesh) transfer directly; under ``jax.distributed`` a sharded
    global array is not fully addressable from one process, so it is
    all-gathered across processes first — the live replacement for the
    reference's ``MPI_local_to_global_*`` Send/Recv assembly
    (nsigproclib_no_mpi.py:364-482)."""
    if isinstance(x, np.ndarray):
        return np.asarray(x, dtype=dtype)
    if jax.process_count() > 1 and not getattr(x, "is_fully_addressable", True):
        from jax.experimental import multihost_utils

        x = multihost_utils.process_allgather(x, tiled=True)
    return np.asarray(x, dtype=dtype)


def put_global(x: np.ndarray, sharding: NamedSharding) -> jax.Array:
    """Place one host array (identical on every process) onto a global
    sharding — works both single-process and under ``jax.distributed``
    (the multi-process ``Bcast`` analog, nsigproclib_no_mpi.py:315-360)."""
    x = np.asarray(x)
    return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])


def snapshot_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding of the packed snapshot matrix A (3*Np, Ns): rows (space)
    over 's', snapshots (time) over 't'."""
    return NamedSharding(mesh, P("s", "t"))


def field_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding of stacked fields (C, Ns, jma, kma): time over 't', the z
    axis over 's'."""
    return NamedSharding(mesh, P(None, "t", None, "s"))
