"""Checks that only mean something on an NVIDIA GPU (marker ``gpu``): each
tolerance is one a float32 contraction run in TF32 (~3 decimal digits)
would miss.  They skip on the CPU; on a GPU host run

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pods_digital_filter_tpu.ops import filters, lanczos, pod

pytestmark = pytest.mark.gpu


def test_gram_keeps_float32_precision(gpu):
    rng = np.random.default_rng(0)
    A = rng.standard_normal((65536, 256)).astype(np.float32)
    C = np.asarray(pod.gram_matrix(jax.device_put(A, gpu)))
    A64 = A.astype(np.float64)
    ref = A64.T @ A64 / A.shape[1]
    assert np.max(np.abs(C - ref)) / np.max(np.abs(ref)) < 1e-5


def test_generation_matches_oracle_on_device(gpu):
    import oracle

    key = jax.random.key(3)
    nf, ln, jma, kma, nsteps = 6, 3.0, 48, 40, 24
    with jax.default_device(gpu):
        y = np.asarray(filters.generate_correlated_noise(
            key, 0, nsteps, jma, kma, nf, nf, nf, ln, ln, ln,
            dtype=jnp.float32))
        raw = np.asarray(filters.noise_slabs(
            key, 0, nsteps + 2 * nf, jma + 2 * nf, kma + 2 * nf, 3,
            dtype=jnp.float32), dtype=np.float64)
    b = oracle.gaussian_coeffs(nf, ln)
    ref = np.stack([oracle.sequential_filter(raw[c], b, b, b, jma, kma)
                    for c in range(3)])
    assert np.max(np.abs(y - ref)) < 1e-5


def test_lanczos_topk_float32_on_device(gpu):
    rng = np.random.default_rng(1)
    n, k = 512, 8
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.linspace(1.0, 2.0, n)[::-1] ** 8
    C = (Q * lam) @ Q.T
    e, V = lanczos.topk_or_none(
        jax.device_put(C.astype(np.float32), gpu), k)
    assert e is not None
    np.testing.assert_allclose(e, lam[:k], rtol=1e-5)
