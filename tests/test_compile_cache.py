"""The persistent compilation cache: JAX_COMPILATION_CACHE_DIR when set,
otherwise the fixed ``<checkout>/.jax_cache``."""

import os

import pytest

from pods_digital_filter_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("environ, expected", [
    ({"JAX_COMPILATION_CACHE_DIR": "/somewhere/else"}, None),
    ({}, os.path.join(REPO, ".jax_cache")),
])
def test_cache_dir_to_set(environ, expected):
    assert compile_cache.cache_dir_to_set(environ) == expected


def test_enable_sets_nothing_when_the_variable_is_set(monkeypatch):
    import jax

    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    monkeypatch.setattr(jax.config, "update",
                        lambda *a, **k: calls.append(a))
    compile_cache.enable_compile_cache()
    assert calls == []
