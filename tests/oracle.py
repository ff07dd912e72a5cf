"""Clean-room numpy/scipy oracle of the reference algorithm's semantics.

These functions re-state the *mathematical contract* of the reference
(sequential rolling-buffer digital filter, per-point Lund factor, Gram-matrix
POD, direct shifted DFT) in plain modern numpy, and exist solely so the tests
can A/B the batched device formulation against the original sequential
one on identical inputs.  They are deliberately slow and direct.
"""

from __future__ import annotations

import numpy as np
import scipy.signal as sig


def gaussian_coeffs(n: int, ln: float) -> np.ndarray:
    k = np.arange(2 * n + 1) - n
    a = np.exp(-np.pi * k.astype(np.float64) ** 2 / (2.0 * ln * ln))
    return a / np.sqrt((a * a).sum())


def filter_one_buffer(buf: np.ndarray, bx, by, bz, jma: int, kma: int) -> np.ndarray:
    """Three separable 'valid' scipy convolutions of one (2nfx+1, Jn, Kn)
    noise buffer -> (jma, kma), exactly the reference's production filter."""
    t1 = sig.convolve(buf, bx[:, None, None], mode="valid", method="direct")
    t2 = sig.convolve(t1, by[None, :, None], mode="valid", method="direct")
    t3 = sig.convolve(t2, bz[None, None, :], mode="valid", method="direct")
    return t3[0]


def sequential_filter(noise: np.ndarray, bx, by, bz, jma: int, kma: int) -> np.ndarray:
    """Run the rolling-buffer time loop: ``noise`` is the full pre-drawn slab
    stream (nsteps + 2nfx, Jn, Kn); step i filters the window [i, i+2nfx]."""
    nfx2 = len(bx) - 1
    nsteps = noise.shape[0] - nfx2
    out = np.zeros((nsteps, jma, kma))
    for i in range(nsteps):
        out[i] = filter_one_buffer(noise[i:i + nfx2 + 1], bx, by, bz, jma, kma)
    return out


def lund_point(uu, vv, ww, uv, uw, vw) -> np.ndarray:
    """Scalar 3x3 lower-triangular factor with the reference clamp rules."""
    A = np.zeros((3, 3))
    A[0, 0] = np.sqrt(max(uu, 0.0))
    A[1, 0] = uv / (A[0, 0] + 1e-20) if A[0, 0] > 0.0 else 0.0
    t = vv - A[1, 0] ** 2
    A[1, 1] = np.sqrt(t) if t > 0 else 0.0
    A[2, 0] = uw / (A[0, 0] + 1e-20) if A[0, 0] > 0.0 else 0.0
    A[2, 1] = (vw - A[1, 0] * A[2, 0]) / (A[1, 1] + 1e-20) if A[1, 1] > 0.0 else 0.0
    t = ww - A[2, 0] ** 2 - A[2, 1] ** 2
    A[2, 2] = np.sqrt(t) if t > 0 else 0.0
    return A


def pod_oracle(A: np.ndarray, num_trunc: int, tol_cn: float = 1e-15):
    """Gram-matrix snapshot POD with the reference's scaling conventions,
    using the generic nonsymmetric eig (as the reference does)."""
    ns = A.shape[1]
    C = A.T @ A / ns
    lam, V = np.linalg.eig(C)
    order = np.argsort(-lam.real, kind="stable")
    lam = lam[order].real
    V = V[:, order].real

    tol2 = tol_cn ** 2
    nv = 0
    while nv < ns and lam[nv] > 0 and lam[nv] / lam[0] > tol2:
        nv += 1
    nv = min(nv, ns - 1)
    m = min(num_trunc, nv) if num_trunc >= 0 else nv

    T = V.copy()
    for j in range(nv):
        mag = np.sum(T[:, j] ** 2) / ns
        T[:, j] *= np.sqrt(lam[j] / mag)
    phi = A @ T[:, :m] @ np.diag(1.0 / lam[:m]) / ns
    return lam, T, phi, nv, m


def shifted_dft(y: np.ndarray) -> np.ndarray:
    """Direct O(Ns^2) DFT with k = n - Ns//2 (the reference's loop)."""
    ns = len(y)
    t = np.arange(ns)
    c = np.zeros(ns, dtype=np.complex128)
    for n in range(ns):
        k = n - ns // 2
        c[n] = np.sum(y * np.exp(-1j * 2.0 * np.pi * k * t / ns)) / ns
    return c


def reconstruct_series(c_sel: np.ndarray, k_sel: np.ndarray, ns: int) -> np.ndarray:
    t = np.arange(ns)
    out = np.zeros(ns, dtype=np.complex128)
    for c, k in zip(c_sel, k_sel):
        out += c * np.exp(1j * 2.0 * np.pi * k * t / ns)
    return out.real
