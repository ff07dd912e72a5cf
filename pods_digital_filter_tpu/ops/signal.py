"""Signal-processing numerics library (L3 of the reference layer map).

Reference: ``nsigproclib_no_mpi.py`` — Welch PSD (``fct_welch``, lines 10-68),
cross-spectral density (``fct_iwelch``, 71-132), windowed cross-correlation
(``cross_correlation``, 134-198), transfer function (201-208), coherence
(210-218), azimuthal Fourier series (253-311).

Re-implemented as batched JAX ops: the per-block Python loop becomes a strided
gather + one batched FFT.  Conventions preserved exactly: window selector
``iwindow`` 1=rectangular / 2=Hanning / 3=Blackman, corrective factor
``Cw = N / sum(w^2)``, 50%% overlap with ``M = 1 + floor((size-N)/(N//2))``
blocks, ``fftshift``-ed two-sided spectra, frequency vector
``linspace(-N/2, N/2-1, N)/N*fs`` (and the cross-correlation lag vector's
``/fs``-only scaling quirk, line 178).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _window(N: int, iwindow: int, dtype=jnp.float64):
    n = jnp.arange(N, dtype=dtype)
    if iwindow == 2:
        w = 0.5 - 0.5 * jnp.cos(2.0 * jnp.pi * n / (N - 1))
    elif iwindow == 3:
        w = (0.42 - 0.5 * jnp.cos(2.0 * jnp.pi * n / (N - 1))
             + 0.08 * jnp.cos(4.0 * jnp.pi * n / (N - 1)))
    else:  # 1 or anything else: rectangular
        w = jnp.ones(N, dtype=dtype)
    return w


def _num_blocks(size: int, N: int) -> int:
    noverlap = N // 2
    if size < N:
        raise ValueError("Block size N should not be larger than the signal size.")
    return 1 + (size - N) // noverlap


def _blocks(x: jax.Array, N: int, M: int) -> jax.Array:
    """(M, N) strided view of the 50%-overlapping blocks."""
    noverlap = N // 2
    starts = jnp.arange(M) * noverlap
    idx = starts[:, None] + jnp.arange(N)[None, :]
    return x[idx]


def freq_vector(N: int, fs: float) -> np.ndarray:
    return np.linspace(-N / 2, N / 2 - 1, N) / N * fs


def welch_psd(x, fs: float, N: int, iwindow: int = 1):
    """Two-sided Welch PSD.  Returns ``(f, Sxx, M)`` like the reference."""
    x = jnp.asarray(x)
    M = _num_blocks(x.size, N)
    w = _window(N, iwindow, dtype=x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.float64)
    Cw = N / jnp.sum(w ** 2)
    X = jnp.fft.fftshift(jnp.fft.fft(_blocks(x, N, M) * w[None, :], axis=1), axes=1)
    Sxx = jnp.mean(Cw / N / fs * (X * jnp.conj(X)).real, axis=0)
    return freq_vector(N, fs), Sxx, M


def welch_csd(x, y, fs: float, N: int, iwindow: int = 1):
    """Two-sided cross-spectral density Sxy (reference ``fct_iwelch``)."""
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    M = _num_blocks(x.size, N)
    w = _window(N, iwindow)
    Cw = N / jnp.sum(w ** 2)
    X = jnp.fft.fftshift(jnp.fft.fft(_blocks(x, N, M) * w[None, :], axis=1), axes=1)
    Y = jnp.fft.fftshift(jnp.fft.fft(_blocks(y, N, M) * w[None, :], axis=1), axes=1)
    Sxy = jnp.mean(Cw / N / fs * X * jnp.conj(Y), axis=0)
    return freq_vector(N, fs), Sxy, M


def cross_correlation(x, y, fs: float, N: int, iwindow: int = 1):
    """Windowed cross-correlation via ``ifft(X * conj(Y))``; lag vector keeps
    the reference's ``linspace(-N/2, N/2-1, N)/fs`` scaling (line 178)."""
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    M = _num_blocks(x.size, N)
    w = _window(N, iwindow)
    Cw = N / jnp.sum(w ** 2)
    X = jnp.fft.fft(_blocks(x, N, M) * w[None, :], axis=1)
    Y = jnp.fft.fft(_blocks(y, N, M) * w[None, :], axis=1)
    R = jnp.mean(
        Cw / N / fs * jnp.fft.fftshift(jnp.fft.ifft(X * jnp.conj(Y), axis=1), axes=1),
        axis=0,
    )
    lags = np.linspace(-N / 2, N / 2 - 1, N) / fs
    return lags, R, M


def transfer_function(x, y, fs: float, N: int, iwindow: int = 1):
    f, Sxy, M = welch_csd(x, y, fs, N, iwindow)
    _, Sxx, _ = welch_psd(x, fs, N, iwindow)
    return f, Sxy / Sxx, M


def coherence(x, y, fs: float, N: int, iwindow: int = 1):
    f, Sxy, M = welch_csd(x, y, fs, N, iwindow)
    _, Sxx, _ = welch_psd(x, fs, N, iwindow)
    _, Syy, _ = welch_psd(y, fs, N, iwindow)
    return f, jnp.abs(Sxy) ** 2 / Sxx / Syy, M, Sxy


def mean(mat, dim: int = 0):
    """Reference ``mean`` (nsigproclib:221-250): axis mean with its dim
    convention — for 2-D input, ``dim=1`` averages over columns (axis 1),
    anything else averages over rows (axis 0); 1-D input -> scalar."""
    mat = jnp.asarray(mat)
    if mat.ndim == 2:
        return jnp.mean(mat, axis=1 if dim == 1 else 0)
    return jnp.mean(mat)


def _ring_index(axiseg: int, rseg: int, aziseg: int) -> np.ndarray:
    """Point indices of every (axial, radial) ring in the reference's
    structured polar ordering (nsigproclib:253-311): point 0 of each axial
    block is the axis point, then rseg rings of aziseg consecutive points —
    ``idx[jj, k, m] = 1 + jj*(rseg*aziseg + 1) + k*aziseg + m``."""
    jj = np.arange(axiseg)[:, None, None]
    k = np.arange(rseg)[None, :, None]
    m = np.arange(aziseg)[None, None, :]
    return 1 + jj * (rseg * aziseg + 1) + k * aziseg + m


def _azimuthal_weight_phases(theta: np.ndarray):
    """Trapezoid quadrature weights folded into cos/sin phase tables —
    computed HOST-SIDE in float64: the phase ``n*theta`` grows to
    ``O(aziseg * 2pi)``, so forming it in float32 (the device default when
    x64 is off) costs ~1e-4 rad of phase error at high mode numbers.  Only
    the contraction (which sums aziseg terms — benign in f32) runs on
    device.  Weights: c_0 = (t1-t0)/2, c_last = (t_end - t_{end-1})/2, else
    (t_{m+1} - t_{m-1})/2."""
    theta = np.asarray(theta, dtype=np.float64)
    dt = theta[..., 1:] - theta[..., :-1]
    c = np.concatenate([
        dt[..., :1] * 0.5,
        (theta[..., 2:] - theta[..., :-2]) * 0.5,
        dt[..., -1:] * 0.5,
    ], axis=-1)                                       # (jj, k, m)
    n = np.arange(theta.shape[-1], dtype=np.float64)
    ph = n[:, None] * theta[..., None, :]             # (jj, k, n, m)
    return c[..., None, :] * np.cos(ph), c[..., None, :] * np.sin(ph)


@jax.jit
def _azimuthal_energies(u, cu, su):
    """Batched trapezoid-DFT contraction: ``u (P, jj, k, m)`` ring samples
    against the precomputed weighted cos/sin phases ``cu/su (jj, k, n, m)``
    -> ``|trapz(u * exp(-1j n theta), theta)|^2`` of shape (P, jj, k, n) for
    all n < aziseg.  The per-(n, sample) host loop of the reference becomes
    two real contractions (cos/sin) at full precision, with no complex
    arrays crossing the host boundary."""
    hi = jax.lax.Precision.HIGHEST
    re = jnp.einsum("pjkm,jknm->pjkn", u, cu, precision=hi)
    im = -jnp.einsum("pjkm,jknm->pjkn", u, su, precision=hi)
    return re * re + im * im


def azimuthal_fourier_series(u, r, theta, x, nc: int, axiseg: int, rseg: int, aziseg: int):
    """Azimuthal mode energies on a structured polar mesh
    (reference nsigproclib:253-311, minus the VTK plumbing: fields are passed
    as flat arrays in the reference's point ordering).

    ``u``: (num_points, nc) components (the magnitude column is added here);
    returns ``(m_array, x_array, r_array)`` with
    ``m_array[i, jj, k, n] = |trapz(u_i * exp(-1j*n*theta), theta)|^2``.

    Batched: the reference's four nested host loops (components x axial x
    radial x mode, each calling np.trapz) are one gather + one batched
    einsum contraction (:func:`_azimuthal_energies`); the loop version is
    kept as the parity oracle (:func:`azimuthal_fourier_series_loop`,
    tests/test_signal.py).
    """
    u = np.asarray(u, dtype=np.float64).reshape(-1, nc)
    if nc > 1:
        mag = np.sqrt(np.sum(u ** 2, axis=1, keepdims=True))
        u = np.concatenate([u, mag], axis=1)

    idx = _ring_index(axiseg, rseg, aziseg)
    cu, su = _azimuthal_weight_phases(np.asarray(theta, dtype=np.float64)[idx])
    u_r = jnp.asarray(u.T[:, idx])                    # (ncomp, jj, k, m)
    m_array = np.zeros((nc + 1, axiseg, rseg, aziseg), dtype=np.float64)
    m_array[:u_r.shape[0]] = np.asarray(
        _azimuthal_energies(u_r, jnp.asarray(cu), jnp.asarray(su)))
    x_array = np.asarray(x, dtype=np.float64)[idx[..., -1]]
    r_array = np.asarray(r, dtype=np.float64)[idx[..., -1]]
    return m_array, x_array, r_array


def azimuthal_fourier_series_loop(u, r, theta, x, nc: int, axiseg: int,
                                  rseg: int, aziseg: int):
    """Reference-faithful host-loop implementation (nsigproclib:253-311) —
    the parity oracle for :func:`azimuthal_fourier_series`."""
    u = np.asarray(u, dtype=np.float64).reshape(-1, nc)
    if nc > 1:
        mag = np.sqrt(np.sum(u ** 2, axis=1, keepdims=True))
        u = np.concatenate([u, mag], axis=1)
        ncomp = nc + 1
    else:
        ncomp = nc

    m_array = np.zeros((nc + 1, axiseg, rseg, aziseg), dtype=np.float64)
    x_array = np.zeros((axiseg, rseg), dtype=np.float64)
    r_array = np.zeros((axiseg, rseg), dtype=np.float64)

    for jj in range(axiseg):
        for k in range(rseg):
            base = 1 + jj * (rseg * aziseg + 1) + k * aziseg
            sl = slice(base, base + aziseg)
            tt = np.asarray(theta)[sl]
            x_array[jj, k] = np.asarray(x)[sl][-1]
            r_array[jj, k] = np.asarray(r)[sl][-1]
            for i in range(ncomp):
                uu = u[sl, i]
                for n in range(aziseg):
                    val = np.trapezoid(uu * np.exp(-1j * n * tt), tt)
                    m_array[i, jj, k, n] = (val * np.conj(val)).real
    return m_array, x_array, r_array
