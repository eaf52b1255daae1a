"""The run-time plumbing around the decoder: where JAX's compilation cache
lives, and chip_smoke.py's refusal to run anywhere but a GPU."""

import os

import pytest

from go_mp3_tpu.utils import cache


@pytest.mark.parametrize(
    "environ, want",
    [
        ({}, str(cache.CHECKOUT_CACHE)),
        ({cache.ENV: ""}, str(cache.CHECKOUT_CACHE)),
        ({cache.ENV: "/srv/jax-cache"}, "/srv/jax-cache"),
    ],
    ids=["unset", "empty", "set"],
)
def test_cache_dir(environ, want):
    assert cache.cache_dir(environ) == want


def test_checkout_cache_is_beside_the_package():
    import go_mp3_tpu

    root = os.path.dirname(os.path.dirname(os.path.abspath(go_mp3_tpu.__file__)))
    assert str(cache.CHECKOUT_CACHE) == os.path.join(root, ".jax_cache")


@pytest.mark.parametrize("env_dir", [None, "from-env"])
def test_enable_compilation_cache(monkeypatch, tmp_path, env_dir):
    """Without the variable the checkout's directory is configured; with it,
    the code names no directory of its own (JAX reads the variable)."""
    import jax

    before = jax.config.jax_compilation_cache_dir
    sentinel = str(tmp_path / "untouched")
    jax.config.update("jax_compilation_cache_dir", sentinel)
    try:
        if env_dir is None:
            monkeypatch.delenv(cache.ENV, raising=False)
            assert cache.enable_compilation_cache() == str(cache.CHECKOUT_CACHE)
            assert jax.config.jax_compilation_cache_dir == str(cache.CHECKOUT_CACHE)
        else:
            path = str(tmp_path / env_dir)
            monkeypatch.setenv(cache.ENV, path)
            assert cache.enable_compilation_cache() == path
            assert jax.config.jax_compilation_cache_dir == sentinel
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_device_phase_refuses_cpu():
    import chip_smoke

    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.phase_device(1)


def test_chip_smoke_parity_helpers():
    import numpy as np

    import chip_smoke

    a = np.array([0, 10, -5, 7], "<i2")
    b = np.array([1, 10, -7, 7], "<i2")
    rms, maxdiff = chip_smoke.diff_stats(a.tobytes(), b.tobytes())
    assert maxdiff == 2 and abs(rms - np.sqrt(5 / 4)) < 1e-12
    with pytest.raises(AssertionError, match="length"):
        chip_smoke.diff_stats(a.tobytes(), b[:3].tobytes())

    host = np.arange(2 * 3 * 6 * 2, dtype=np.int16).reshape(2, 3, 6, 2)
    host = np.repeat(host, 96, axis=2)  # [C=2, S=3, 576, 2]
    valids = np.array([[1, 1, 0], [0, 1, 0]])
    assert chip_smoke.lane_pcm(host, valids, 0) == host[0, 0].tobytes()
    assert chip_smoke.lane_pcm(host, valids, 1) == (
        host[0, 1].tobytes() + host[1, 1].tobytes()
    )
    assert chip_smoke.lane_pcm(host, valids, 2) == b""
