"""Benchmark: solver-side PODFS replay throughput vs per-step snapshot loading.

The reference's only published performance claim is that a CFD solver using
the PODFS inlet model runs ~2.5x faster than one loading a snapshot file
every timestep (docs/usage/CFDCodeIntegration.rst:5).  This benchmark
measures that trade directly for this framework's replay module:

* replay path: ``replay.Replayer.batch`` — the jitted batched evaluation of
  the PODFS reconstruction equation (CFDCodeIntegration.rst:87-91), i.e.
  per-mode Fourier synthesis + one (Nt, nm) @ (nm, 3*Np) GEMM — measured
  as inlet points x steps per second;
* file path: reading one ``.prf`` snapshot per step, timed for both
  ``np.loadtxt`` (what a Python solver shim would use) and this
  framework's native C parser (``native.parse_tables``, threaded, GIL-free).

Model size mirrors BASELINE.json config 3: 256x128 plane, 50 modes,
21 Fourier coefficients per mode.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}
where vs_baseline is replay throughput over the *fastest* file-loading path
(so the number is conservative).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NPTS = 256 * 128
NM = 50
KMAX = 21
NSTEPS = 512          # replay timesteps per timed batch
NFILES = 8            # snapshot files for the loading baseline


def make_model():
    from pods_digital_filter_tpu.replay import PODFSModel

    rng = np.random.RandomState(3)
    k = np.tile(np.arange(KMAX) - KMAX // 2, (NM, 1)).astype(np.float64)
    return PODFSModel(
        points=rng.standard_normal((NPTS, 3)),
        mean=rng.standard_normal(3 * NPTS),
        modes=rng.standard_normal((NM, 3 * NPTS)),
        period=1.0,
        k=k,
        c_re=rng.standard_normal((NM, KMAX)) / (1.0 + np.abs(k)),
        c_im=rng.standard_normal((NM, KMAX)) / (1.0 + np.abs(k)),
        counts=np.full(NM, KMAX, dtype=np.int64),
    )


def bench_replay(model):
    """Times two consumption modes:

    * device rate — ``Replayer.batch_device`` + block_until_ready: what an
      on-device (JAX-side) solver or chained diagnostic sees;
    * host-delivery rate — ``Replayer.batch``, including the device->host
      copy.
    """
    import jax
    import jax.numpy as jnp

    from pods_digital_filter_tpu.replay import Replayer

    rp = Replayer(model)
    ts = np.linspace(0.0, 0.9, NSTEPS)

    # device rate: REPS batches amortized inside one jit (per-iteration time
    # offsets so nothing is hoisted), synced by fetching one scalar — the
    # same amortization bench.py uses to exclude per-dispatch latency.
    reps = 8
    ts_dev = jnp.asarray(ts, rp._dtype)

    @jax.jit
    def loop(ts0):
        def body(acc, i):
            out = rp._jit(ts0 + 1e-4 * i.astype(rp._dtype), rp._k, rp._c_re,
                          rp._c_im, rp._modes, rp._mean, alpha=1.0)
            return acc + jnp.sum(out), None

        acc, _ = jax.lax.scan(body, jnp.zeros((), rp._dtype),
                              jnp.arange(reps))
        return acc

    float(loop(ts_dev))  # compile + warmup + hard sync
    dev_times, host_times = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        float(loop(ts_dev))
        dev_times.append(time.perf_counter() - t0)
    rp.batch(ts)  # warm the host-copy path
    for _ in range(3):
        t0 = time.perf_counter()
        rp.batch(ts)
        host_times.append(time.perf_counter() - t0)
    dev_dt = sorted(dev_times)[1] / reps
    host_dt = sorted(host_times)[1]
    return NPTS * NSTEPS / dev_dt, NPTS * NSTEPS / host_dt, dev_dt


def bench_file_loading(model, tmpdir):
    """Write NFILES snapshot .prf files, then time loading them back —
    np.loadtxt and the native threaded parser."""
    from pods_digital_filter_tpu import native
    from pods_digital_filter_tpu.config import PlaneConfig
    from pods_digital_filter_tpu.io.plane import make_inflow_plane
    from pods_digital_filter_tpu.io.prf import write_snapshot_prf

    geom = make_inflow_plane(PlaneConfig(jma=256, kma=128, res=0.01))
    rng = np.random.RandomState(5)
    paths = [
        write_snapshot_prf(tmpdir, 1.0e-3 * (i + 1),
                           rng.standard_normal(3 * NPTS), geom,
                           (1.0, 0.0, 0.0), (0.0, 0.0, 0.0))
        for i in range(NFILES)
    ]

    t0 = time.perf_counter()
    for p in paths:
        np.loadtxt(p, skiprows=11, delimiter=",")
    loadtxt_rate = NPTS * NFILES / (time.perf_counter() - t0)

    native_rate = 0.0
    t0 = time.perf_counter()
    tabs = native.parse_tables(paths)
    if tabs is not None and all(t is not None for t in tabs):
        native_rate = NPTS * NFILES / (time.perf_counter() - t0)
    return loadtxt_rate, native_rate


def bench_c_replay(tmpdir):
    """Rate of the linkable C solver library (native/podfs_replay.c) on a
    same-size model — what a non-Python solver gets on its own CPU."""
    from pods_digital_filter_tpu import native

    if not native.podfs_replay_available():
        return 0.0
    # write a synthetic model directory the C loader can read
    import pods_digital_filter_tpu.io.prf as prf
    from pods_digital_filter_tpu.config import PlaneConfig
    from pods_digital_filter_tpu.io.plane import make_inflow_plane
    from pods_digital_filter_tpu.ops.fourier import FourierResult

    rng = np.random.RandomState(7)
    geom = make_inflow_plane(PlaneConfig(jma=256, kma=128, res=0.01))
    normal = (1.0, 0.0, 0.0)
    prf.write_mean_prf(tmpdir, rng.standard_normal(3 * NPTS), geom, normal)
    for i in range(NM):
        prf.write_mode_prf(tmpdir, i + 1, rng.standard_normal(3 * NPTS),
                           geom, normal)
    coeffs = (rng.standard_normal((KMAX, NM))
              + 1j * rng.standard_normal((KMAX, NM)))
    fr = FourierResult(
        period=1.0, coeffs=coeffs,
        counts=np.full(NM, KMAX, dtype=np.int64),
        order=np.tile(np.arange(KMAX), (NM, 1)),
        reconstruction=np.zeros((KMAX, NM)))
    prf.write_podfs_dat(tmpdir, fr)

    nt = 64
    ts = np.linspace(0.0, 0.9, nt)
    with native.NativePODFSReplayer(tmpdir) as rp:
        rp.eval_batch(ts)  # warmup (page in the model)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            rp.eval_batch(ts)
            times.append(time.perf_counter() - t0)
    return NPTS * nt / sorted(times)[1]


def main():
    from pods_digital_filter_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()
    model = make_model()
    dev_rate, host_rate, dev_dt = bench_replay(model)
    with tempfile.TemporaryDirectory() as tmpdir:
        loadtxt_rate, native_rate = bench_file_loading(model, tmpdir)
    with tempfile.TemporaryDirectory() as tmpdir:
        c_rate = bench_c_replay(tmpdir)

    best_file_rate = max(loadtxt_rate, native_rate)
    result = {
        "metric": "PODFS replay throughput (inlet points*steps/s)",
        "value": round(dev_rate, 1),
        "unit": "points*steps/s",
        "vs_baseline": round(dev_rate / best_file_rate, 1),
        "detail": {
            "config": f"{NPTS} points, {NM} modes, {KMAX} FCs/mode, "
                      f"{NSTEPS} steps/batch",
            "batch_wall_s": round(dev_dt, 5),
            "host_delivery_rate": round(host_rate, 1),
            "snapshot_loadtxt_rate": round(loadtxt_rate, 1),
            "snapshot_native_parser_rate": round(native_rate, 1),
            "c_library_rate": round(c_rate, 1),
            "c_library_note": "linkable solver-side C replay "
                              "(native/podfs_replay.c) on this host's CPU",
            "reference_claim": "PODFS inlet ~2.5x faster than per-step "
                               "snapshot loading (CFDCodeIntegration.rst:5)",
        },
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
