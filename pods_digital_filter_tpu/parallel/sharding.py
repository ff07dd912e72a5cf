"""Sharded generation of the correlated-noise / velocity snapshot stream.

Two shard_map paths over the ``('t', 's')`` mesh (time blocks x plane
z-tiles):

1. :func:`generate_sharded` — **exact** path.  Each device recomputes the
   full-width noise slab from the globally counter-indexed PRNG and slices its
   z tile + filter halo locally, so the output equals the single-device
   result for any mesh shape (same noise stream; only float contraction-order
   rounding differs), with **zero communication** during generation (noise
   generation is duplicated across the 's' axis; it is a few percent of the
   filter cost at production sizes).

2. :func:`generate_sharded_halo` — **halo-exchange** path for very large
   planes.  Each device draws only its own z chunk of noise (keyed by
   ``(slab, tile)``) and exchanges ``nfz``-wide halos with its mesh neighbors
   via ``lax.ppermute`` over the 's' axis — the collective analog of the
   reference's MPI Send/Recv assembly (nsigproclib_no_mpi.py:364-482).
   Statistically identical to (1) but not bit-identical (different noise
   indexing).

Both paths are exact w.r.t. the time axis: time blocks are independent by
construction (counter-indexed slabs).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from pods_digital_filter_tpu.ops import filters


def _check_divisible(nsteps, kma, mesh: Mesh):
    nt = mesh.shape["t"]
    ns = mesh.shape["s"]
    if nsteps % nt:
        raise ValueError(f"nsteps={nsteps} not divisible by t-axis size {nt}")
    if kma % ns:
        raise ValueError(f"kma={kma} not divisible by s-axis size {ns}")
    return nsteps // nt, kma // ns


def generate_sharded(
    key: jax.Array,
    mesh: Mesh,
    t0: int,
    nsteps: int,
    jma: int,
    kma: int,
    nfx: int, nfy: int, nfz: int,
    lnx: float, lny: float, lnz: float,
    num_components: int = 3,
    dtype=jnp.float32,
) -> jax.Array:
    """Exact sharded generation -> global (C, nsteps, jma, kma) array sharded
    ``P(None, 't', None, 's')``."""
    bt, tk = _check_divisible(nsteps, kma, mesh)
    bx = filters.gaussian_fir_coeffs(nfx, lnx, dtype)
    by = filters.gaussian_fir_coeffs(nfy, lny, dtype)
    bz = filters.gaussian_fir_coeffs(nfz, lnz, dtype)
    jn = jma + 2 * nfy
    kn = kma + 2 * nfz

    def tile_fn(key, bx, by, bz):
        ti = jax.lax.axis_index("t")
        si = jax.lax.axis_index("s")
        tb0 = t0 + ti * bt
        k0 = si * tk
        slab_ids = tb0 + jnp.arange(bt + 2 * nfx)

        def one_slab(s):
            k = jax.random.fold_in(key, s)
            full = jax.random.uniform(
                k, (num_components, jn, kn), dtype=dtype,
                minval=-filters.PDFR, maxval=filters.PDFR)
            return jax.lax.dynamic_slice_in_dim(full, k0, tk + 2 * nfz, axis=2)

        raw = jnp.moveaxis(jax.vmap(one_slab)(slab_ids), 0, 1)
        z = filters.filter_spatial(raw, by, bz, jma, tk)
        y = filters.filter_temporal(z, bx, axis=-3)   # (C, bt, jma, tk)
        return y

    f = jax.shard_map(
        tile_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P()),  # replicated key + filter taps
        out_specs=P(None, "t", None, "s"),
    )
    return f(key, bx, by, bz)


def _ppermute_shift(x, axis_name: str, shift: int, n: int):
    """Send x to the neighbor ``shift`` positions up the axis (non-periodic:
    edge devices receive zeros)."""
    perm = [(i, i + shift) for i in range(n) if 0 <= i + shift < n]
    return jax.lax.ppermute(x, axis_name, perm)


def generate_sharded_halo(
    key: jax.Array,
    mesh: Mesh,
    t0: int,
    nsteps: int,
    jma: int,
    kma: int,
    nfx: int, nfy: int, nfz: int,
    lnx: float, lny: float, lnz: float,
    num_components: int = 3,
    dtype=jnp.float32,
) -> jax.Array:
    """Halo-exchange sharded generation (see module docstring).

    Per z-tile noise ownership: tile ``si`` draws the ``tk`` interior columns
    aligned with its output tile, keyed ``fold_in(fold_in(key, slab), si)``;
    the two outer pads (nfz columns each) are drawn by the edge tiles with
    dedicated sub-keys.  Interior halos move between devices with two
    ppermute shifts.  Requires ``nfz <= tk``.
    """
    bt, tk = _check_divisible(nsteps, kma, mesh)
    if nfz > tk:
        raise ValueError(f"halo path needs nfz({nfz}) <= tile width ({tk})")
    n_s = mesh.shape["s"]
    bx = filters.gaussian_fir_coeffs(nfx, lnx, dtype)
    by = filters.gaussian_fir_coeffs(nfy, lny, dtype)
    bz = filters.gaussian_fir_coeffs(nfz, lnz, dtype)
    jn = jma + 2 * nfy

    def tile_fn(key, bx, by, bz):
        ti = jax.lax.axis_index("t")
        si = jax.lax.axis_index("s")
        tb0 = t0 + ti * bt
        slab_ids = tb0 + jnp.arange(bt + 2 * nfx)

        def one_slab(s):
            ks = jax.random.fold_in(key, s)
            interior = jax.random.uniform(
                jax.random.fold_in(ks, si),
                (num_components, jn, tk), dtype=dtype,
                minval=-filters.PDFR, maxval=filters.PDFR)
            # outer pads: dedicated sub-keys n_s (left) and n_s + 1 (right)
            left_pad = jax.random.uniform(
                jax.random.fold_in(ks, n_s),
                (num_components, jn, nfz), dtype=dtype,
                minval=-filters.PDFR, maxval=filters.PDFR)
            right_pad = jax.random.uniform(
                jax.random.fold_in(ks, n_s + 1),
                (num_components, jn, nfz), dtype=dtype,
                minval=-filters.PDFR, maxval=filters.PDFR)
            return interior, left_pad, right_pad

        interior, left_pad, right_pad = jax.vmap(one_slab)(slab_ids)
        interior = jnp.moveaxis(interior, 0, 1)   # (C, T+2nfx, jn, tk)
        left_pad = jnp.moveaxis(left_pad, 0, 1)
        right_pad = jnp.moveaxis(right_pad, 0, 1)

        # halo exchange: my last nfz cols -> right neighbor's left
        # halo; my first nfz cols -> left neighbor's right halo.
        from_left = _ppermute_shift(interior[..., -nfz:], "s", +1, n_s)
        from_right = _ppermute_shift(interior[..., :nfz], "s", -1, n_s)
        left_halo = jnp.where(si == 0, left_pad, from_left)
        right_halo = jnp.where(si == n_s - 1, right_pad, from_right)
        raw = jnp.concatenate([left_halo, interior, right_halo], axis=-1)

        z = filters.filter_spatial(raw, by, bz, jma, tk)
        y = filters.filter_temporal(z, bx, axis=-3)
        return y

    f = jax.shard_map(
        tile_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=P(None, "t", None, "s"),
    )
    return f(key, bx, by, bz)


def pack_sharded_snapshots(colored: jax.Array, mesh: Mesh) -> jax.Array:
    """(3, Ns, jma, kma) sharded P(None,'t',None,'s') -> packed (3*Np, Ns)
    sharded P('s','t') — note the packed row index is comp*Np + j*kma + k, so
    row-sharding over 's' corresponds to k tiles only after a transpose that
    XLA handles as an all-to-all within each device's data."""
    c, ns, jma, kma = colored.shape
    A = jnp.transpose(colored, (0, 2, 3, 1)).reshape(c * jma * kma, ns)
    return A


@functools.partial(jax.jit, static_argnames=("num_snapshots",))
def distributed_gram(A: jax.Array, num_snapshots: int) -> jax.Array:
    """Gram matrix of a sharded snapshot matrix.  With A sharded P('s','t'),
    XLA lowers this to per-shard partial products + an all-reduce over 's'
    and all-gathers over 't' — the psum design of SURVEY.md §5.8."""
    return jnp.dot(A.T, A, precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=A.dtype) / num_snapshots
