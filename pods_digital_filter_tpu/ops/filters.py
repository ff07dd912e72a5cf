"""Klein (2003) digital-filter core, batched-GEMM formulation.

Reference semantics (``/root/reference/digitalfilters.py``):

* ``calccoeff`` (lines 73-89): Gaussian FIR taps
  ``b[i] = exp(-pi*(i-n)^2 / (2*ln^2))`` normalized to unit L2 norm.
* ``filter3DSciPy1D`` (lines 100-140): three separable 'valid' 1-D
  convolutions of a uniform white-noise buffer of shape
  ``(2*nfx+1, 2*nfy+jma, 2*nfz+kma)`` producing one ``(jma, kma)`` slab.
* time recursion (lines 1454-1467): ``np.roll(x,-1,axis=0)`` + refill the last
  slab with fresh noise each step.

Redesign (NOT a port): the rolling-buffer recursion is exactly a causal FIR
over the time axis, so the whole generation factorizes into three
embarrassingly-parallel stages:

1. **noise**: stateless counter-indexed PRNG — slab ``s`` of component ``c``
   is a pure function of ``(base_key, c, s)``, so any time window (and any
   shard of it) can be generated independently and reproducibly;
2. **spatial filter**: the separable valid convolution over (y, z) is applied
   to *all* slabs at once as two banded-Toeplitz matrix multiplications
   (``y = By @ X @ Bz^T`` batched over slabs);
3. **temporal FIR**: a single valid 1-D convolution along the slab axis.

Because the Gaussian taps are symmetric, correlation == convolution, matching
scipy's kernel-flipping ``convolve`` exactly.

An ``lax.scan`` streaming driver processes unbounded time series in blocks
with overlap-save (carrying ``2*nfx`` filtered slabs between blocks), which is
the batched analog of the reference's ring buffer.

Every contraction runs at ``Precision.HIGHEST``: a float32 GEMM on the GPU
otherwise may run in TF32 (~3 decimal digits).  A cheaper precision for the
filter GEMMs on noise is an open optimisation that must be validated
statistically first.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Uniform noise in (-sqrt(3), sqrt(3)) has unit variance
# (digitalfilters.py:1344 "pdfr = np.sqrt(3.0)").
PDFR = float(np.sqrt(3.0))

HIGHEST = jax.lax.Precision.HIGHEST

# Name of the noise stream this generator draws (Threefry, one fold_in per
# time slab).  Part of every checkpoint fingerprint: a store written with
# another stream must not resume as if it held the same noise.
STREAM_TAG = "xla-threefry-v1"


# ---------------------------------------------------------------------------
# Filter coefficients
# ---------------------------------------------------------------------------

def gaussian_fir_coeffs(n: int, ln: float, dtype=jnp.float32) -> jax.Array:
    """Klein filter taps, length ``2n+1`` (reference ``calccoeff``).

    ``b[i] = exp(-pi*(i-n)^2/(2*ln^2))`` normalized so ``sum(b^2) == 1``
    (this makes the filtered output unit-variance for unit-variance input).
    """
    k = np.arange(2 * n + 1, dtype=np.float64) - n
    a = np.exp(-np.pi * k * k / (2.0 * ln * ln))
    b = a / np.sqrt(np.sum(a * a))
    return jnp.asarray(b, dtype=dtype)


def filter_kernel_3d(
    nfx: int, nfy: int, nfz: int, lnx: float, lny: float, lnz: float,
    dtype=jnp.float32,
) -> jax.Array:
    """Tensor-product 3-D kernel ``a[i,j,k] = bx[i]*by[j]*bz[k]``
    (reference ``coeff3D``, digitalfilters.py:46-70).  Only used by the
    direct-filter test oracle; production code uses the separable form."""
    bx = gaussian_fir_coeffs(nfx, lnx, dtype)
    by = gaussian_fir_coeffs(nfy, lny, dtype)
    bz = gaussian_fir_coeffs(nfz, lnz, dtype)
    return jnp.einsum("i,j,k->ijk", bx, by, bz)


# ---------------------------------------------------------------------------
# Stateless counter-indexed noise
# ---------------------------------------------------------------------------

def noise_slabs(
    key: jax.Array,
    t0: int,
    num_slabs: int,
    jn: int,
    kn: int,
    num_components: int = 3,
    dtype=jnp.float32,
) -> jax.Array:
    """Uniform(-sqrt3, sqrt3) noise, shape ``(num_components, num_slabs, jn, kn)``.

    Slab ``s`` (global time-slab index ``t0 + s``) is keyed by
    ``fold_in(key, t0+s)`` so any window of the infinite noise stream is
    reproducible independently of what was generated before — this replaces
    the reference's sequential ``np.random.uniform`` ring-buffer refills
    (digitalfilters.py:1361-1366, 1459-1467) and is what makes time-sharded
    generation communication-free.
    """
    slab_ids = t0 + jnp.arange(num_slabs)

    def one_slab(s):
        k = jax.random.fold_in(key, s)
        return jax.random.uniform(
            k, (num_components, jn, kn), dtype=dtype, minval=-PDFR, maxval=PDFR
        )

    with jax.named_scope("noise_slabs"):
        # (num_slabs, C, jn, kn) -> (C, num_slabs, jn, kn)
        out = jax.vmap(one_slab)(slab_ids)
        return jnp.moveaxis(out, 0, 1)


# ---------------------------------------------------------------------------
# Spatial filtering: separable valid conv as banded-Toeplitz matmuls
# ---------------------------------------------------------------------------

def toeplitz_band(coeffs: np.ndarray | jax.Array, out_len: int) -> jax.Array:
    """Banded matrix ``B`` of shape ``(out_len, out_len + len(coeffs) - 1)``
    with ``B[j, j+d] = coeffs[d]`` — so ``B @ x`` is the 'valid' correlation
    of ``x`` with ``coeffs`` (== convolution for symmetric taps)."""
    c = jnp.asarray(coeffs)
    width = c.shape[0]
    in_len = out_len + width - 1
    j = jnp.arange(out_len)[:, None]
    m = jnp.arange(in_len)[None, :]
    d = m - j
    valid = (d >= 0) & (d < width)
    return jnp.where(valid, c[jnp.clip(d, 0, width - 1)], 0).astype(c.dtype)


def filter_spatial(
    slabs: jax.Array,  # (..., jma + 2*nfy, kma + 2*nfz)
    by: jax.Array,     # (2*nfy + 1,)
    bz: jax.Array,     # (2*nfz + 1,)
    jma: int,
    kma: int,
) -> jax.Array:
    """Separable valid filter over the trailing (y, z) axes for a batch of
    slabs: two dense banded GEMMs, which the BLAS library handles well for
    the filter widths this method uses (nf ~ 6..30)."""
    By = toeplitz_band(by, jma)   # (jma, jma+2nfy)
    Bz = toeplitz_band(bz, kma)   # (kma, kma+2nfz)
    dtype = slabs.dtype
    # Both contractions as trailing-axis matmuls with an explicit swap in
    # between (a "stacked GEMM" with no transposed operand).
    # (..., Jn, Kn) @ (Kn, kma) -> (..., Jn, kma)
    with jax.named_scope("filter_spatial_z"):
        t = jax.lax.dot_general(
            slabs, Bz.T.astype(dtype),
            dimension_numbers=(((slabs.ndim - 1,), (0,)), ((), ())),
            precision=HIGHEST, preferred_element_type=dtype,
        )
        t = jnp.swapaxes(t, -1, -2)   # (..., kma, Jn)
    with jax.named_scope("filter_spatial_y"):
        u = jax.lax.dot_general(
            t, By.T.astype(dtype),
            dimension_numbers=(((t.ndim - 1,), (0,)), ((), ())),
            precision=HIGHEST, preferred_element_type=dtype,
        )                              # (..., kma, jma)
        return jnp.swapaxes(u, -1, -2)


def filter_temporal(
    filtered_slabs: jax.Array,  # (..., nsteps + 2*nfx, jma, kma)
    bx: jax.Array,              # (2*nfx + 1,)
    axis: int = -3,
) -> jax.Array:
    """Causal valid FIR along the time-slab axis: output step ``t`` is
    ``sum_i bx[i] * slab[t + i]`` — exactly the reference's rolling-buffer
    x-convolution (digitalfilters.py:124, 1454-1467) with the recursion
    unrolled into a batched contraction."""
    nfx2 = bx.shape[0] - 1
    with jax.named_scope("filter_temporal"):
        x = jnp.moveaxis(filtered_slabs, axis, -1)  # (..., jma, kma, T+2nfx)
        t_out = x.shape[-1] - nfx2
        Bt = toeplitz_band(bx, t_out)                # (T, T+2nfx)
        y = jax.lax.dot_general(
            x, Bt.T.astype(x.dtype),
            dimension_numbers=(((x.ndim - 1,), (0,)), ((), ())),
            precision=HIGHEST, preferred_element_type=x.dtype,
        )                                            # (..., jma, kma, T)
        return jnp.moveaxis(y, -1, axis)


# ---------------------------------------------------------------------------
# Full generation of unit-variance correlated noise
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit,
    static_argnames=(
        "nsteps", "jma", "kma", "num_components", "dtype",
    ),
)
def _generate_jit(key, bx, by, bz, t0, nsteps, jma, kma,
                  num_components, dtype):
    # t0 is a *dynamic* argument: every block window [t0, t0+nsteps)
    # shares one compiled executable (the streaming POD regenerates
    # O(B^2) blocks — ops/../streaming.py)
    nfy = (by.shape[0] - 1) // 2
    nfz = (bz.shape[0] - 1) // 2
    jn = jma + 2 * nfy
    kn = kma + 2 * nfz
    nfx2 = bx.shape[0] - 1
    raw = noise_slabs(key, t0, nsteps + nfx2, jn, kn, num_components, dtype)
    z = filter_spatial(raw, by, bz, jma, kma)   # (C, T+2nfx, jma, kma)
    y = filter_temporal(z, bx, axis=-3)          # (C, T, jma, kma)
    return y


def generate_correlated_noise(
    key: jax.Array,
    t0: int,
    nsteps: int,
    jma: int,
    kma: int,
    nfx: int,
    nfy: int,
    nfz: int,
    lnx: float,
    lny: float,
    lnz: float,
    num_components: int = 3,
    dtype=jnp.float32,
) -> jax.Array:
    """Correlated, unit-variance noise ``(num_components, nsteps, jma, kma)``
    for the global time window ``[t0, t0 + nsteps)``.

    Equivalent to running the reference's time loop
    (digitalfilters.py:1403-1467) for steps ``t0 .. t0+nsteps-1`` — but with
    no sequential dependency: slab noise is counter-indexed, the spatial
    filter is batched over all slabs, and the time FIR is one contraction.

    The filter taps are built on the host and passed as jit *arguments*
    rather than embedded as constants, so one compiled program serves every
    tap set of the same shape.
    """
    bx = gaussian_fir_coeffs(nfx, lnx, dtype)
    by = gaussian_fir_coeffs(nfy, lny, dtype)
    bz = gaussian_fir_coeffs(nfz, lnz, dtype)
    return _generate_jit(key, bx, by, bz, t0=t0, nsteps=nsteps, jma=jma,
                         kma=kma, num_components=num_components, dtype=dtype)


def generate_correlated_noise_scan(
    key: jax.Array,
    nsteps: int,
    block: int,
    jma: int,
    kma: int,
    nfx: int,
    nfy: int,
    nfz: int,
    lnx: float,
    lny: float,
    lnz: float,
    num_components: int = 3,
    dtype=jnp.float32,
) -> jax.Array:
    """Streaming variant: ``lax.scan`` over time blocks with overlap-save.

    The carry is the trailing ``2*nfx`` *spatially filtered* slabs — the
    analog of the reference ring buffer, but carrying the (jma, kma)-sized
    filtered slabs instead of the (jma+2nfy, kma+2nfz) raw noise, so the
    carried state is smaller and the spatial filter runs once per slab.
    ``nsteps`` must be a multiple of ``block``.
    """
    assert nsteps % block == 0, "nsteps must be a multiple of block"
    bx = gaussian_fir_coeffs(nfx, lnx, dtype)
    by = gaussian_fir_coeffs(nfy, lny, dtype)
    bz = gaussian_fir_coeffs(nfz, lnz, dtype)
    return _generate_scan_jit(key, bx, by, bz, nsteps=nsteps, block=block,
                              jma=jma, kma=kma,
                              num_components=num_components, dtype=dtype)


@functools.partial(
    jax.jit,
    static_argnames=("nsteps", "block", "jma", "kma", "num_components", "dtype"),
)
def _generate_scan_jit(key, bx, by, bz, nsteps, block, jma, kma,
                       num_components, dtype):
    nfx2 = bx.shape[0] - 1
    nfy = (by.shape[0] - 1) // 2
    nfz = (bz.shape[0] - 1) // 2
    jn = jma + 2 * nfy
    kn = kma + 2 * nfz
    nblocks = nsteps // block

    def filt_block(t0, num):
        raw = noise_slabs(key, t0, num, jn, kn, num_components, dtype)
        return filter_spatial(raw, by, bz, jma, kma)

    # Warm-up: the first 2*nfx filtered slabs.
    carry0 = filt_block(0, nfx2)   # (C, 2nfx, jma, kma)

    def step(carry, b):
        t0 = nfx2 + b * block
        new = jax.vmap(
            lambda s: filter_spatial(
                noise_slabs(key, s, 1, jn, kn, num_components, dtype)[:, 0],
                by, bz, jma, kma),
        )(t0 + jnp.arange(block))                       # (block, C, jma, kma)
        new = jnp.moveaxis(new, 0, 1)                    # (C, block, jma, kma)
        window = jnp.concatenate([carry, new], axis=1)   # (C, 2nfx+block, ...)
        y = filter_temporal(window, bx, axis=-3)         # (C, block, jma, kma)
        return window[:, -nfx2:], y

    _, ys = jax.lax.scan(step, carry0, jnp.arange(nblocks))
    # ys: (nblocks, C, block, jma, kma) -> (C, nsteps, jma, kma)
    ys = jnp.moveaxis(ys, 0, 1).reshape(num_components, nsteps, jma, kma)
    return ys


# ---------------------------------------------------------------------------
# Direct (naive) filter — correctness oracle
# ---------------------------------------------------------------------------

def filter_direct_3d(noise: jax.Array, kernel: jax.Array) -> jax.Array:
    """O(N*K^3) direct filter of one noise buffer ``(2nfx+1, jn, kn)`` with the
    full 3-D kernel — mirror of the reference's own A/B oracle ``filter3D``
    (digitalfilters.py:91-98).  Test use only."""
    nfy2 = kernel.shape[1] - 1
    nfz2 = kernel.shape[2] - 1
    jma = noise.shape[1] - nfy2
    kma = noise.shape[2] - nfz2

    def at(j, k):
        win = jax.lax.dynamic_slice(noise, (0, j, k), kernel.shape)
        return jnp.sum(win * kernel)

    jj, kk = jnp.meshgrid(jnp.arange(jma), jnp.arange(kma), indexing="ij")
    return jax.vmap(jax.vmap(at))(jj, kk)
