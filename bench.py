"""Benchmark: the north-star metric of BASELINE.json —
filtered inlet samples/s/chip (grid-points x steps per second) for the
digital-filter generation hot path (RNG + spatial filter + temporal FIR +
Lund coloring), compared against the reference's sequential scipy
implementation measured on this host's CPU.

Measurement note: the hot path (ops/filters.py) is repeated REPS times
*inside one jitted scan* and synced once, so wall time is device compute,
not dispatch latency.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

JMA = KMA = 512
NSTEPS = 64
NF = 8
LN = 4.0
REPS = 8


def _steady_rate(fn, *args):
    """Median of 3 timed calls (each REPS hot-path iterations), after one
    warmup; returns (samples_per_sec, seconds_per_rep)."""
    out = fn(*args)
    float(out)  # compile + warmup + hard sync (host round-trip)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = fn(*args)
        float(out)
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[1] / REPS
    return (JMA * KMA * NSTEPS) / dt, dt


def bench_device():
    import jax
    import jax.numpy as jnp

    from pods_digital_filter_tpu.models import profiles as prof
    from pods_digital_filter_tpu.ops import filters, lund

    dtype = jnp.float32
    U, uu, vv, ww, uw = prof.build_profile(
        "hyperbolic-tangent", "top-hat", 1.0, 0.05, KMA)
    fields = prof.fields_1d(U, uu, vv, ww, uw)
    stresses = tuple(jnp.asarray(s, dtype=dtype) for s in fields.stresses())
    means = tuple(jnp.asarray(m, dtype=dtype) for m in fields.means())

    @jax.jit
    def xla_loop(key, stresses, means):
        def body(acc, i):
            noise = filters.generate_correlated_noise(
                jax.random.fold_in(key, i), 0, NSTEPS, JMA, KMA,
                NF, NF, NF, LN, LN, LN, num_components=3, dtype=dtype)
            out = lund.apply_lund_stacked(noise, stresses, means)
            return acc + jnp.sum(out), None

        acc, _ = jax.lax.scan(body, jnp.float32(0.0), jnp.arange(REPS))
        return acc

    key = jax.random.key(0)
    return _steady_rate(xla_loop, key, stresses, means)


def bench_cpu_reference(jma=128, kma=128, nsteps=4, nf=NF, ln=LN):
    """Reference-equivalent sequential scipy path (filter3DSciPy1D semantics:
    three 'valid' direct convolutions per component per step,
    digitalfilters.py:100-140 + 1403-1467) measured on this host, as the
    baseline the reference would achieve here."""
    import scipy.signal as sig

    k = np.arange(2 * nf + 1) - nf
    b = np.exp(-np.pi * k.astype(np.float64) ** 2 / (2.0 * ln * ln))
    b /= np.sqrt((b * b).sum())
    bx = b[:, None, None]
    by = b[None, :, None]
    bz = b[None, None, :]

    rng = np.random.RandomState(0)
    pdfr = np.sqrt(3.0)
    shape = (2 * nf + 1, jma + 2 * nf, kma + 2 * nf)
    bufs = [rng.uniform(-pdfr, pdfr, shape) for _ in range(3)]

    t0 = time.perf_counter()
    for _ in range(nsteps):
        for c in range(3):
            t1 = sig.convolve(bufs[c], bx, mode="valid", method="direct")
            t2 = sig.convolve(t1, by, mode="valid", method="direct")
            _ = sig.convolve(t2, bz, mode="valid", method="direct")[0]
            bufs[c] = np.roll(bufs[c], -1, axis=0)
            bufs[c][-1] = rng.uniform(-pdfr, pdfr, shape[1:])
    dt = time.perf_counter() - t0
    samples = jma * kma * nsteps
    return samples / dt, dt


def bench_pod_stage():
    """Second north-star metric (SURVEY.md §6): PODFS compression wall-time
    at the 1000-snapshot config, reusing benchmarks/bench_pod.py internals —
    machine-captured here so every BENCH_rXX.json carries both numbers."""
    import os

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "benchmarks"))
    import bench_pod as bp

    A_host = bp._make_snapshots_host(bp.NCOMP * bp.NPTS, bp.NS)
    dev_s, (res, fc), stages = bp.bench_device(A_host)
    cpu_s, (lam_ref, _, counts_ref) = bp.bench_cpu_reference(A_host)
    spec_err = float(np.max(np.abs(res.energy[:10] - lam_ref[:10])
                            / lam_ref[:10]))
    return {
        "wall_s": round(dev_s, 4),
        "vs_cpu_reference": round(cpu_s / dev_s, 1),
        "cpu_reference_s": round(cpu_s, 2),
        "compute_s": round(stages["compute_s"], 4),
        "compute_wall_s": round(stages["compute_wall_s"], 4),
        "overlapped_copy_s": round(stages["overlapped_copy_s"], 4),
        # null when the pessimistic isolated-copy estimate swallows the
        # whole wall (fully-overlapped copies on a slow link) — the
        # wall-based ratio below is then the meaningful one
        "vs_cpu_compute_only": (round(cpu_s / stages["compute_s"], 1)
                                if stages["compute_s"] > 1e-6 else None),
        "vs_cpu_compute_wall": (round(cpu_s / stages["compute_wall_s"], 1)
                                if stages["compute_wall_s"] > 1e-6 else None),
        "stages_s": {k: round(v, 4) for k, v in stages.items()},
        "config": f"{bp.NCOMP * bp.NPTS} rows x {bp.NS} snaps, "
                  f"{bp.NM} modes, et={bp.ET}",
        "top10_eigenvalue_rel_err": round(spec_err, 6),
    }


def main():
    from pods_digital_filter_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()
    rate, dt = bench_device()
    cpu_rate, cpu_dt = bench_cpu_reference()
    try:
        pod_stage = bench_pod_stage()
    except Exception as e:  # the generation metric must survive regardless
        print(f"# pod stage bench failed: {type(e).__name__}: {e}",
              file=sys.stderr)
        pod_stage = {"error": f"{type(e).__name__}: {e}"}

    result = {
        "metric": "filtered inlet samples/s/chip",
        "value": round(rate, 1),
        "unit": "grid-points*steps/s",
        "vs_baseline": round(rate / cpu_rate, 2),
        "detail": {
            "config": f"{JMA}x{KMA} plane, {NSTEPS} steps, nf={NF}, ln={LN}, "
                      f"f32, RNG+filter+Lund, {REPS} reps in-jit",
            "step_wall_s": round(dt, 5),
            "cpu_reference_rate": round(cpu_rate, 1),
            "cpu_reference_config": "128x128 plane, 4 steps, same filter",
            "pod_stage": pod_stage,
        },
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
