"""Digital-filter core: coefficient properties, parity with the sequential
scipy oracle, statistical properties (variance, two-point correlation)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pods_digital_filter_tpu.ops import filters

from oracle import gaussian_coeffs, sequential_filter


def test_coeff_normalization():
    for n, ln in [(3, 1.5), (6, 3.0), (12, 5.0)]:
        b = np.asarray(filters.gaussian_fir_coeffs(n, ln, jnp.float64))
        assert b.shape == (2 * n + 1,)
        np.testing.assert_allclose(np.sum(b * b), 1.0, rtol=1e-12)
        np.testing.assert_allclose(b, gaussian_coeffs(n, ln), rtol=1e-12)
        # symmetric
        np.testing.assert_allclose(b, b[::-1], rtol=1e-12)


def test_toeplitz_band_matches_convolve_valid(rng):
    x = rng.standard_normal(37)
    c = gaussian_coeffs(4, 2.0)
    B = np.asarray(filters.toeplitz_band(jnp.asarray(c), 37 - 8))
    got = B @ x
    want = np.convolve(x, c, mode="valid")  # symmetric taps: corr == conv
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_generate_matches_sequential_oracle():
    """Batched formulation == reference's sequential rolling-buffer filter
    on identical noise (the reference's own A/B oracle methodology,
    digitalfilters.py:1407-1438)."""
    jma, kma, nsteps = 7, 9, 12
    nf, ln = 4, 2.0
    key = jax.random.key(7)
    y = filters.generate_correlated_noise(
        key, 0, nsteps, jma, kma, nf, nf, nf, ln, ln, ln,
        num_components=3, dtype=jnp.float64)
    # identical noise stream
    raw = np.asarray(filters.noise_slabs(
        key, 0, nsteps + 2 * nf, jma + 2 * nf, kma + 2 * nf, 3, jnp.float64))
    b = gaussian_coeffs(nf, ln)
    for c in range(3):
        want = sequential_filter(raw[c], b, b, b, jma, kma)
        np.testing.assert_allclose(np.asarray(y[c]), want, rtol=1e-9, atol=1e-11)


def test_time_windows_are_consistent():
    """Counter-indexed noise: generating [0, 12) must equal concatenating
    [0, 4) + [4, 12) — the property that makes time-sharding exact."""
    jma, kma = 5, 6
    nf, ln = 3, 1.5
    key = jax.random.key(3)
    args = (jma, kma, nf, nf, nf, ln, ln, ln)
    full = filters.generate_correlated_noise(key, 0, 12, *args, dtype=jnp.float64)
    a = filters.generate_correlated_noise(key, 0, 4, *args, dtype=jnp.float64)
    b = filters.generate_correlated_noise(key, 4, 8, *args, dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(full[:, :4]), np.asarray(a), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(full[:, 4:]), np.asarray(b), rtol=1e-12)


def test_scan_matches_batched():
    jma, kma = 6, 8
    nf, ln = 3, 1.5
    key = jax.random.key(11)
    args = dict(jma=jma, kma=kma, nfx=nf, nfy=nf, nfz=nf,
                lnx=ln, lny=ln, lnz=ln, dtype=jnp.float64)
    full = filters.generate_correlated_noise(key, 0, 12, **args)
    scanned = filters.generate_correlated_noise_scan(key, 12, 4, **args)
    np.testing.assert_allclose(np.asarray(scanned), np.asarray(full),
                               rtol=1e-9, atol=1e-12)


def test_direct_3d_filter_matches_separable():
    nf, ln = 3, 1.5
    jma, kma = 5, 6
    key = jax.random.key(5)
    buf = jax.random.normal(key, (2 * nf + 1, jma + 2 * nf, kma + 2 * nf),
                            dtype=jnp.float64)
    kern = filters.filter_kernel_3d(nf, nf, nf, ln, ln, ln, jnp.float64)
    direct = np.asarray(filters.filter_direct_3d(buf, kern))
    b = filters.gaussian_fir_coeffs(nf, ln, jnp.float64)
    sep = filters.filter_temporal(
        filters.filter_spatial(buf, b, b, jma, kma)[None], b, axis=-3)[0, 0]
    np.testing.assert_allclose(direct, np.asarray(sep), rtol=1e-9, atol=1e-12)


@pytest.mark.slow
def test_output_statistics():
    """Unit variance and Gaussian two-point correlation with the prescribed
    length scale (Klein 2003, eq. 14: R(r) = exp(-pi r^2 / (4 ln^2)))."""
    jma, kma, nsteps = 48, 48, 400
    nf, ln = 8, 4.0
    key = jax.random.key(123)
    y = np.asarray(filters.generate_correlated_noise(
        key, 0, nsteps, jma, kma, nf, nf, nf, ln, ln, ln,
        num_components=1, dtype=jnp.float64))[0]
    var = y.var()
    assert abs(var - 1.0) < 0.1, var

    # two-point correlation along z, averaged over all pairs at separation r
    for r in (2, 4, 6):
        corr = np.mean(y[:, :, r:] * y[:, :, :-r]) / var
        expected = np.exp(-np.pi * r * r / (4.0 * ln * ln))
        assert abs(corr - expected) < 0.08, (r, corr, expected)


# --------------------------------------------------------------------------
# Statistics of the generator at small sizes (fast companions of the slow
# test above; float32, the production dtype)
# --------------------------------------------------------------------------

def _gen(seed=0, t0=0, nsteps=32, jma=24, kma=16, nf=3, ln=1.5):
    return np.asarray(filters.generate_correlated_noise(
        jax.random.key(seed), t0, nsteps, jma, kma, nf, nf, nf, ln, ln, ln,
        num_components=3, dtype=jnp.float32))


def test_unit_variance_and_zero_mean():
    """Normalized taps preserve the unit variance of the +/-sqrt(3) noise
    (digitalfilters.py:73-89 normalization)."""
    y = _gen(nsteps=64, jma=32, kma=32)
    assert abs(y.var() - 1.0) < 0.15, y.var()
    assert abs(y.mean()) < 0.05


def test_spatial_correlation_matches_taps():
    """Adjacent-z correlation equals the tap autocorrelation
    sum(b[i] b[i+1]) — the closed form of a unit-variance white input
    through the normalized filter."""
    nf, ln = 4, 2.0
    y = _gen(nsteps=48, jma=32, kma=48, nf=nf, ln=ln)
    b = np.asarray(filters.gaussian_fir_coeffs(nf, ln, np.float32))
    expected = float((b[:-1] * b[1:]).sum())
    prod = (y[..., :-1] * y[..., 1:]).mean() / y.var()
    assert abs(prod - expected) < 0.1, (prod, expected)


def test_components_decorrelated():
    y = _gen(nsteps=48, jma=32, kma=32)
    c01 = np.corrcoef(y[0].ravel(), y[1].ravel())[0, 1]
    c02 = np.corrcoef(y[0].ravel(), y[2].ravel())[0, 1]
    assert abs(c01) < 0.05 and abs(c02) < 0.05
