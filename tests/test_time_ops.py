"""Phase averaging + temporal interpolation (parallel/time_ops.py vs the
reference's dead MPI layer, nsigproclib_no_mpi.py:485-877)."""

import jax
import jax.numpy as jnp
import numpy as np

from pods_digital_filter_tpu.parallel import time_ops as to
from pods_digital_filter_tpu.parallel.mesh import make_mesh, snapshot_sharding


def test_temporal_interpolate_exact_at_samples():
    time_vec = jnp.arange(5) * 0.5
    A = jnp.asarray(np.random.RandomState(0).randn(7, 5))
    out = to.temporal_interpolate(A, time_vec, time_vec)
    np.testing.assert_allclose(out, A, atol=1e-12)


def test_temporal_interpolate_midpoint_and_clamp():
    time_vec = jnp.asarray([0.0, 1.0, 2.0])
    A = jnp.asarray([[0.0, 2.0, 4.0]])
    out = to.temporal_interpolate(A, time_vec, jnp.asarray([0.5, 1.5, -1.0, 9.0]))
    np.testing.assert_allclose(out[0], [1.0, 3.0, 0.0, 4.0], atol=1e-12)


def _reference_phase_average_numpy(B, time_vec, phase_freq, num_phase):
    """Sequential numpy oracle of the vectorized segment-sum path."""
    dt_phase = 1.0 / phase_freq / num_phase
    sums = np.zeros((B.shape[0], num_phase))
    counts = np.zeros(num_phase)
    t, q = 0.0, 0
    while t <= time_vec[-1] + 1e-12:
        i = min(np.searchsorted(time_vec, t, side="right"), len(time_vec) - 1)
        i = max(i, 1)
        w2 = np.clip((t - time_vec[i - 1]) / (time_vec[i] - time_vec[i - 1]),
                     0.0, 1.0)
        col = (1 - w2) * B[:, i - 1] + w2 * B[:, i]
        b = q % num_phase
        sums[:, b] += col
        counts[b] += 1
        q += 1
        t = q * dt_phase
    return sums / np.maximum(counts, 1.0), counts


def test_phase_average_matches_sequential_oracle():
    rng = np.random.RandomState(1)
    npts, ns = 4, 24
    dt = 0.1
    time_vec = jnp.arange(ns) * dt
    B = jnp.asarray(rng.randn(3 * npts, ns))
    phase_freq = 2.5          # period 0.4 s -> 4 bins at dt=0.1
    res = to.phase_average(B, time_vec, phase_freq, npts)
    assert res.v_phase.shape == (3 * npts, 4)
    v_ref, counts_ref = _reference_phase_average_numpy(
        np.asarray(B), np.asarray(time_vec), phase_freq, 4)
    np.testing.assert_allclose(np.asarray(res.v_phase), v_ref, atol=1e-10)
    np.testing.assert_allclose(np.asarray(res.phase_counts), counts_ref)


def test_phase_average_periodic_signal_recovered():
    """A purely periodic signal phase-averages to itself and leaves ~zero
    fluctuation (the quantity the reference subtracts, 656-658)."""
    npts, nper, cycles = 3, 8, 6
    ns = nper * cycles
    dt = 0.05
    period = nper * dt
    t = np.arange(ns) * dt
    sig = np.sin(2 * np.pi * t / period)
    B = np.outer(np.arange(1, 3 * npts + 1), sig)
    res = to.phase_average(jnp.asarray(B), jnp.asarray(t), 1.0 / period, npts,
                           num_phase=nper)
    np.testing.assert_allclose(np.asarray(res.B_fluct), 0.0, atol=1e-8)
    np.testing.assert_allclose(np.asarray(res.nrs), 0.0, atol=1e-12)


def test_cross_stress_layout():
    """crs rows are [u*v; w*v; u*w] (nsigproclib_no_mpi.py:765-768)."""
    npts, ns = 2, 6
    rng = np.random.RandomState(3)
    B = rng.randn(3 * npts, ns)
    Bj = jnp.asarray(B)
    res = to.phase_average(Bj, jnp.arange(ns) * 0.1, 10.0 / 6.0, npts,
                           num_phase=3)
    Bf = np.asarray(res.B_fluct)
    u, v, w = Bf[:npts], Bf[npts:2 * npts], Bf[2 * npts:]
    np.testing.assert_allclose(np.asarray(res.crs[:npts]),
                               (u * v).mean(axis=1), atol=1e-12)
    np.testing.assert_allclose(np.asarray(res.crs[2 * npts:]),
                               (u * w).mean(axis=1), atol=1e-12)


def test_phase_average_sharded_time_axis():
    """The whole computation jits over a snapshot matrix sharded on the
    't' mesh axis — the collective replacement for the RMA window fetches."""
    mesh = make_mesh(shard_time=4, shard_space=2)
    npts, ns = 4, 32
    dt = 0.1
    rng = np.random.RandomState(4)
    B_host = rng.randn(3 * npts, ns)
    time_vec = jnp.arange(ns) * dt
    B = jax.device_put(jnp.asarray(B_host), snapshot_sharding(mesh))

    res = to.phase_average(B, time_vec, 1.25, npts)
    res_local = to.phase_average(jnp.asarray(B_host), time_vec, 1.25, npts)
    np.testing.assert_allclose(np.asarray(res.v_phase),
                               np.asarray(res_local.v_phase), atol=1e-10)
    np.testing.assert_allclose(np.asarray(res.nrs),
                               np.asarray(res_local.nrs), atol=1e-10)


def test_partition_snapshots():
    # remainder goes to the first part (nsigproclib_no_mpi.py:494-500)
    parts = to.partition_snapshots(10, 3)
    assert parts == [(0, 4), (4, 7), (7, 10)]
    assert to.partition_snapshots(9, 3) == [(0, 3), (3, 6), (6, 9)]
