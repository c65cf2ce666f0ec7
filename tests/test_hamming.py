"""ORB descriptor Hamming matrix against a numpy bit count."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sqrtlm_slam_tpu.frontend import matching


def _bitcount_reference(q, t):
    x = np.bitwise_xor(q[:, None, :], t[None, :, :])
    bits = np.unpackbits(x.view(np.uint8), axis=-1)
    return bits.sum(axis=-1).astype(np.int32)


def _descriptors(rng, n):
    return rng.randint(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize(
    "shape", [(300, 450), (1, 7), (129, 2)], ids=["random", "single", "ragged"]
)
def test_hamming_matrix_matches_bitcount(shape):
    rng = np.random.RandomState(sum(shape))
    q, t = _descriptors(rng, shape[0]), _descriptors(rng, shape[1])
    got = np.asarray(matching.hamming_matrix(jnp.asarray(q), jnp.asarray(t)))
    assert got.shape == shape and got.dtype == np.int32
    np.testing.assert_array_equal(got, _bitcount_reference(q, t))


def test_hamming_matrix_identical_and_complement():
    rng = np.random.RandomState(1)
    d = _descriptors(rng, 64)
    same = np.asarray(matching.hamming_matrix(jnp.asarray(d), jnp.asarray(d)))
    assert (np.diagonal(same) == 0).all()
    comp = np.asarray(matching.hamming_matrix(jnp.asarray(d), jnp.asarray(~d)))
    assert (np.diagonal(comp) == 256).all()


@pytest.mark.parametrize("query", ["default_backend", "devices"])
def test_hamming_matrix_takes_no_platform_route(query, monkeypatch):
    """Tracing never asks which platform it runs on."""
    rng = np.random.RandomState(2)
    q, t = jnp.asarray(_descriptors(rng, 5)), jnp.asarray(_descriptors(rng, 6))

    def refuse(*_, **__):
        raise AssertionError(f"hamming_matrix called jax.{query}")

    monkeypatch.setattr(jax, query, refuse)
    jax.make_jaxpr(matching.hamming_matrix)(q, t)
