"""Every POD, projection, Lanczos, replay and generation contraction states
``Precision.HIGHEST``: on a GPU a float32 dot without it may run in TF32,
which keeps ~3 decimal digits.  Read from the lowered StableHLO, so the
check runs on the CPU."""

import functools
import re

import jax
import jax.numpy as jnp
import pytest

from pods_digital_filter_tpu import replay, streaming
from pods_digital_filter_tpu.ops import filters, lanczos, pod
from pods_digital_filter_tpu.parallel import pod as dist_pod
from pods_digital_filter_tpu.parallel import sharding
from pods_digital_filter_tpu.parallel import streaming as dist_streaming

f32 = jnp.float32


def _z(*shape):
    return jnp.ones(shape, f32)


def _taps(n=2):
    return filters.gaussian_fir_coeffs(n, 1.0, f32)


SITES = {
    "gram": (pod._gram_jit, lambda: (_z(12, 5),)),
    "gram_weighted": (pod._gram_weighted_jit,
                      lambda: (_z(12, 5), _z(4))),
    "center_and_gram": (pod.center_and_gram, lambda: (_z(12, 5),)),
    "spatial_modes": (pod._spatial_modes,
                      lambda: (_z(12, 5), _z(5, 2), _z(2))),
    "streaming_pair_products": (streaming._pair_products,
                                lambda: (_z(12, 4), _z(12, 4))),
    "streaming_projection": (streaming._project_block_at,
                             lambda: (_z(12, 2), _z(12, 4), _z(8, 2),
                                      jnp.int32(0))),
    "lanczos_scan": (functools.partial(lanczos._lanczos_scan, m=3),
                     lambda: (_z(6, 6),)),
    "ritz_vectors": (lanczos._ritz_vectors, lambda: (_z(3, 6), _z(3, 2))),
    "block_lanczos_scan": (
        functools.partial(lanczos._block_lanczos_scan, b=2, steps=3),
        lambda: (_z(6, 6),)),
    "replay": (functools.partial(replay._eval_kernel, period=1.0, alpha=1.0),
               lambda: (_z(3), _z(2, 4), _z(2, 4), _z(2, 4), _z(2, 12),
                        _z(12))),
    "filter_spatial": (functools.partial(filters.filter_spatial,
                                         jma=4, kma=5),
                       lambda: (_z(3, 8, 9), _taps(), _taps())),
    "filter_temporal": (filters.filter_temporal,
                        lambda: (_z(9, 4, 5), _taps())),
    "generation": (functools.partial(
        filters._generate_jit, t0=0, nsteps=4, jma=4, kma=5,
        num_components=3, dtype=f32),
        lambda: (jax.random.key(0), _taps(), _taps(), _taps())),
    "distributed_center_and_gram": (dist_pod._center_and_gram_impl,
                                    lambda: (_z(3, 4, 2, 3),)),
    "distributed_spatial_modes": (dist_pod._spatial_modes_fields,
                                  lambda: (_z(3, 4, 2, 3), _z(4, 2))),
    "distributed_pair_products": (dist_streaming._pair_products_fields,
                                  lambda: (_z(3, 4, 2, 3), _z(3, 4, 2, 3))),
    "distributed_projection": (dist_streaming._project_block_fields_at,
                               lambda: (_z(3, 2, 2, 3), _z(3, 4, 2, 3),
                                        _z(8, 2), jnp.int32(0))),
    "distributed_gram": (functools.partial(sharding.distributed_gram,
                                           num_snapshots=5),
                         lambda: (_z(12, 5),)),
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_contraction_precision_is_highest(site):
    fn, make_args = SITES[site]
    text = jax.jit(fn).lower(*make_args()).as_text()
    dots = [ln for ln in text.splitlines()
            if re.search(r"stablehlo\.(dot_general|dot) ", ln)]
    assert dots, f"{site}: no contraction lowered"
    for ln in dots:
        assert "precision = [HIGHEST, HIGHEST]" in ln, (site, ln.strip())
