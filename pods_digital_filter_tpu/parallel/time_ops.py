"""Time-axis collectives: temporal interpolation + phase averaging.

Collective-based replacement for the reference's dead mpi4py layer
(nsigproclib_no_mpi.py): ``temporal_interpolation(_mult)_MPI`` (691-877)
fetched remote-rank snapshot columns through one-sided RMA windows
(Win.Create/Lock/Get/Unlock, 553-564) and ``phase_average_MPI`` (507-688)
drove them from rank 0 with a sequential while-loop, then Bcast the result.

Here the snapshot matrix is a global jax array (optionally sharded over the
``'t'`` mesh axis, :mod:`pods_digital_filter_tpu.parallel.mesh`); a
cross-shard column fetch is just a gather — XLA inserts the collective — and
the whole phase loop is one vectorized segment-sum.  Everything is jittable
and differentiable.

Deviations (documented):
* the reference subtracts only *half* the interpolated phase average
  (``B[:,i1] -= 0.5*(w1*v_phase[...] + w2*v_phase[...])``,
  nsigproclib_no_mpi.py:656-658) — an apparent bug; we subtract the full
  phase average.
* the reference's index walk (691-877) reconstructs (rank, local index)
  pairs by stepping time in dt increments; we use direct searchsorted
  interpolation, which is equivalent for the uniform time vectors it is
  called with.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


def temporal_interpolate(A: jax.Array, time_vec: jax.Array,
                         t_query: jax.Array) -> jax.Array:
    """Linear interpolation of snapshot columns at query times.

    ``A``: (rows, Ns) snapshot matrix (any sharding on the column axis);
    ``time_vec``: (Ns,) ascending sample times; ``t_query``: scalar or (Q,).
    Returns (rows,) or (rows, Q).  Out-of-range queries clamp to the end
    columns (the reference clamps its index walk the same way,
    nsigproclib_no_mpi.py:713-715).
    """
    t_query = jnp.atleast_1d(jnp.asarray(t_query))
    ns = A.shape[1]
    hi = jnp.clip(jnp.searchsorted(time_vec, t_query, side="right"), 1, ns - 1)
    lo = hi - 1
    t_lo = time_vec[lo]
    t_hi = time_vec[hi]
    w2 = jnp.clip((t_query - t_lo) / jnp.maximum(t_hi - t_lo, 1e-300), 0.0, 1.0)
    cols_lo = jnp.take(A, lo, axis=1)
    cols_hi = jnp.take(A, hi, axis=1)
    out = cols_lo * (1.0 - w2)[None, :] + cols_hi * w2[None, :]
    return out[:, 0] if out.shape[1] == 1 and np.ndim(t_query) == 0 else out


@dataclass
class PhaseAverageResult:
    """Outputs of :func:`phase_average` (mirrors the reference's return
    tuple, nsigproclib_no_mpi.py:688)."""
    phase: np.ndarray          # (num_phase,) phase angle in degrees
    v_phase: jax.Array         # (3*Np, num_phase) phase-averaged velocity
    nrs_phase: jax.Array       # (3*Np, num_phase) phase <u_i u_i>
    crs_phase: jax.Array       # (3*Np, num_phase) phase <u v>, <w v>, <u w>
    phase_counts: jax.Array    # (num_phase,) samples per bin
    B_fluct: jax.Array         # (3*Np, Ns) field minus its phase average
    rms_scalars: jax.Array | None  # (num_scalars, Np) RMS after subtraction
    nrs: jax.Array             # (3*Np,) non-periodic resolved stresses
    crs: jax.Array             # (3*Np,) non-periodic cross stresses


def _cross_products(B: jax.Array, num_points: int) -> jax.Array:
    """The reference's cross-stress component layout
    (nsigproclib_no_mpi.py:589-602, 765-768): rows [u*v; w*v; u*w]."""
    u = B[:num_points]
    v = B[num_points:2 * num_points]
    w = B[2 * num_points:3 * num_points]
    return jnp.concatenate([u * v, w * v, u * w], axis=0)


def num_phase_bins(phase_freq: float, dt: float, num_snapshots: int,
                   stride: int = 1) -> int:
    """Snapshots per forcing period (nsigproclib_no_mpi.py:511-524)."""
    num_phase = int(1.0 / phase_freq / dt / stride)
    if num_phase >= num_snapshots:
        num_phase = num_snapshots - 1
    return num_phase


def phase_average(
    B: jax.Array,
    time_vec: jax.Array,
    phase_freq: float,
    num_points: int,
    num_components: int = 3,
    scalars: jax.Array | None = None,
    num_phase: int | None = None,
) -> PhaseAverageResult:
    """Phase-average a snapshot stream over a forcing period.

    ``B``: (num_points*num_components, Ns) velocity snapshots (columns may be
    sharded over the time mesh axis); ``scalars``: optional
    (num_scalars, num_points, Ns).  Resamples the stream at
    ``dt_phase = 1/(phase_freq*num_phase)`` and accumulates cyclic phase
    bins — the vectorized form of the reference's while-loop
    (nsigproclib_no_mpi.py:568-615).
    """
    ns = B.shape[1]
    dt = float(time_vec[1] - time_vec[0])
    if num_phase is None:
        num_phase = num_phase_bins(phase_freq, dt, ns)
    dt_phase = 1.0 / phase_freq / num_phase

    t_end = float(time_vec[-1])
    num_q = int(np.floor(t_end / dt_phase)) + 1
    t_q = jnp.arange(num_q) * dt_phase
    bins = jnp.arange(num_q) % num_phase

    S = temporal_interpolate(B, time_vec, t_q)          # (3Np, Q)
    counts = jax.ops.segment_sum(jnp.ones(num_q), bins, num_phase)
    denom = jnp.maximum(counts, 1.0)

    def seg_mean(X):
        sums = jax.ops.segment_sum(X.T, bins, num_phase)  # (num_phase, rows)
        return (sums / denom[:, None]).T

    v_phase = seg_mean(S)
    nrs_phase = seg_mean(S * S)
    crs_phase = seg_mean(_cross_products(S, num_points))

    # subtract the phase average at each snapshot time (full subtraction;
    # see module docstring for the reference's 0.5 factor)
    snap_bins = (jnp.round(time_vec / dt_phase).astype(jnp.int32)) % num_phase
    B_fluct = B - jnp.take(v_phase, snap_bins, axis=1)

    nrs = jnp.mean(B_fluct * B_fluct, axis=1)
    crs = jnp.mean(_cross_products(B_fluct, num_points), axis=1)

    rms_scalars = None
    if scalars is not None:
        ns_sc = scalars.shape[0]
        sc2 = scalars.reshape(ns_sc * num_points, ns)
        sc_phase = seg_mean(temporal_interpolate(sc2, time_vec, t_q))
        sc_fluct = sc2 - jnp.take(sc_phase, snap_bins, axis=1)
        rms_scalars = jnp.sqrt(jnp.mean(sc_fluct * sc_fluct, axis=1)).reshape(
            ns_sc, num_points)

    return PhaseAverageResult(
        phase=np.linspace(0.0, 360.0, num_phase),
        v_phase=v_phase, nrs_phase=nrs_phase, crs_phase=crs_phase,
        phase_counts=counts, B_fluct=B_fluct,
        rms_scalars=rms_scalars, nrs=nrs, crs=crs,
    )


def partition_snapshots(num_snapshots: int, num_parts: int) -> list:
    """Contiguous snapshot ranges per worker — the reference's
    ``DivideByNP`` (nsigproclib_no_mpi.py:485-504, remainder to the first
    part).  Used for host-side file-IO sharding; on-device sharding uses the
    mesh instead."""
    base = num_snapshots // num_parts
    rem = num_snapshots - base * num_parts
    out = []
    start = 0
    for i in range(num_parts):
        n = base + (rem if i == 0 else 0)
        out.append((start, start + n))
        start += n
    return out
