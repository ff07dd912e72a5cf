"""Distributed snapshot POD over the ('t', 's') mesh.

Works directly on the sharded field-layout tensor ``X (C, Ns, jma, kma)``
(sharded ``P(None, 't', None, 's')``) instead of the packed (3Np, Ns) matrix,
so no cross-device re-layout is needed:

* Gram matrix ``C[t, u] = sum_cjk X[c,t,j,k] X[c,u,j,k] / Ns`` — XLA lowers
  the contraction to per-tile partial Grams + an all-reduce over 's' (the
  ``psum`` of SURVEY.md §5.8) and an all-gather over 't';
* the (Ns, Ns) eigendecomposition and mode bookkeeping are replicated host
  work (tiny);
* spatial modes ``Phi[c,m,j,k] = sum_t X[c,t,j,k] T[t,m] / (Ns lam_m)`` —
  contraction over the time shards (reduce over 't'), output stays sharded
  over 's'.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pods_digital_filter_tpu.ops import pod as pod_ops
from pods_digital_filter_tpu.parallel.mesh import put_global, to_host

HIGHEST = jax.lax.Precision.HIGHEST


@dataclass
class DistributedPODResult:
    energy: np.ndarray             # (Ns,) descending
    temporal_modes: np.ndarray     # (Ns, Ns) host, scaled
    spatial_modes_fields: jax.Array  # (C, m, jma, kma) sharded over 's'
    mean_fields: jax.Array         # (C, jma, kma) sharded over 's'
    num_valid: int
    num_trunc: int

    def spatial_modes_packed(self) -> np.ndarray:
        """Gather to host (all-gathered across processes under
        ``jax.distributed``) and pack to the reference layout (3*Np, m):
        row = c*Np + j*kma + k."""
        phi = to_host(self.spatial_modes_fields)
        c, m, jma, kma = phi.shape
        return phi.transpose(0, 2, 3, 1).reshape(c * jma * kma, m)

    def mean_packed(self) -> np.ndarray:
        return to_host(self.mean_fields).reshape(-1)


def _center_and_gram_impl(X: jax.Array):
    ns = X.shape[1]
    mean = jnp.mean(X, axis=1)
    Xc = X - mean[:, None]
    C = jnp.einsum("ctjk,cujk->tu", Xc, Xc, precision=HIGHEST,
                   preferred_element_type=X.dtype) / ns
    return mean, Xc, C


@functools.lru_cache(maxsize=8)
def _center_and_gram_fn(mesh: Mesh):
    """Per-mesh compiled center+Gram with the Gram pinned replicated, so
    every process can fetch it directly (the tiny (Ns, Ns) eigen half is
    replicated host work)."""
    return jax.jit(
        _center_and_gram_impl,
        out_shardings=(
            NamedSharding(mesh, P(None, None, "s")),      # mean fields
            NamedSharding(mesh, P(None, "t", None, "s")),  # centered X
            NamedSharding(mesh, P(None, None)),            # Gram: replicated
        ),
    )


@jax.jit
def _spatial_modes_fields(Xc: jax.Array, M: jax.Array):
    """Phi = Xc contracted with M (M already includes the 1/(Ns*lam) scaling
    of PODFS.py:1329-1333)."""
    return jnp.einsum("ctjk,tm->cmjk", Xc, M, precision=HIGHEST,
                      preferred_element_type=Xc.dtype)


def distributed_pod(
    X: jax.Array,
    mesh: Mesh,
    num_modes_trunc: int,
    tol_cn: float = 1.0e-15,
) -> DistributedPODResult:
    """POD of the sharded snapshot fields; semantics identical to
    :func:`pods_digital_filter_tpu.ops.pod.snapshot_pod`."""
    ns = X.shape[1]
    mean, Xc, C = _center_and_gram_fn(mesh)(X)

    energy = to_host(C)
    e, v = np.linalg.eigh(energy)
    e, v = e[::-1], v[:, ::-1]
    e, v = pod_ops.sort_eigenvalues_desc(e, v)

    num_valid = pod_ops.count_valid_modes(e, tol_cn)
    if num_modes_trunc < 0 or num_modes_trunc > num_valid:
        num_modes_trunc = num_valid

    temporal = v.copy()
    for j in range(num_valid):
        mag = np.sum(temporal[:, j] ** 2) / ns
        if mag > 0:
            temporal[:, j] = temporal[:, j] * np.sqrt(max(e[j], 0.0) / mag)

    M = temporal[:, :num_modes_trunc] / (ns * e[:num_modes_trunc])[None, :]
    M_dev = put_global(M.astype(X.dtype), NamedSharding(mesh, P(None, None)))
    phi = _spatial_modes_fields(Xc, M_dev)

    return DistributedPODResult(
        energy=e, temporal_modes=temporal,
        spatial_modes_fields=phi, mean_fields=mean,
        num_valid=num_valid, num_trunc=num_modes_trunc,
    )
