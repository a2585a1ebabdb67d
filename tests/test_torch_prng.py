"""The port's threefry keys and draws against ``jax.random``, bitwise."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

# one intra-op thread: the suite runs several pytest workers at once, and
# PyTorch's default of one thread per core oversubscribes the machine
torch.set_num_threads(1)

from repro_torch.common import prng  # noqa: E402


def _bits(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a.astype(np.int64)


@pytest.mark.parametrize("seed", [0, 7, 1234, 2 ** 31 + 5, 2 ** 32 - 1])
def test_prngkey_fold_in_split(seed):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(_bits(kj), _bits(kt))
    for d in (0, 3, 0x0DEC, 2 ** 31 + 9):          # a fold_in chain
        kj, kt = jax.random.fold_in(kj, d), prng.fold_in(kt, d)
        np.testing.assert_array_equal(_bits(kj), _bits(kt))
    np.testing.assert_array_equal(_bits(jax.random.split(kj, 7)),
                                  _bits(prng.split(kt, 7)))
    ids = np.arange(5, dtype=np.int32)
    np.testing.assert_array_equal(
        _bits(jax.vmap(jax.random.fold_in, in_axes=(None, 0))(kj, ids)),
        _bits(prng.fold_in(kt, torch.from_numpy(ids))))


@pytest.mark.parametrize("shape", [(10, 96, 160), (7,), (3, 5), (1,),
                                   (2, 3, 5), (13, 1, 3)])
def test_normal_uniform_bits_bitwise(shape):
    for seed in (3, 33):
        kj = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
        kt = prng.fold_in(prng.PRNGKey(seed), 5)
        np.testing.assert_array_equal(_bits(jax.random.bits(kj, shape)),
                                      _bits(prng.random_bits(kt, shape)))
        np.testing.assert_array_equal(_bits(jax.random.uniform(kj, shape)),
                                      _bits(prng.uniform(kt, shape)))
        np.testing.assert_array_equal(_bits(jax.random.normal(kj, shape)),
                                      _bits(prng.normal(kt, shape)))


def test_batched_keys_normal_bitwise():
    """(C, 2) keys -> (C, *shape): the per-camera draws of the scene and
    codec noise."""
    kj = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(9), i))(
        jnp.arange(4))
    kt = prng.fold_in(prng.PRNGKey(9), torch.arange(4))
    want = jax.vmap(lambda k: jax.random.normal(k, (3, 8, 16)))(kj)
    np.testing.assert_array_equal(_bits(want), _bits(prng.normal(kt,
                                                                 (3, 8, 16))))


def test_erf_inv_bitwise_1e6():
    """XLA's float32 erf_inv expansion on 1e6 inputs in (-1, 1): random
    floats, the uniform grid ``normal`` draws from, and the edges."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, 600_000).astype(np.float32)
    m = rng.integers(0, 2 ** 23, 400_000).astype(np.uint32)
    grid = ((m | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
            ) * np.float32(2.0) + np.nextafter(np.float32(-1), np.float32(0))
    x = np.concatenate([x, grid.astype(np.float32),
                        np.float32([0.0, -0.0, 1.0, -1.0, 0.9999999,
                                    -0.9999999, 1e-30])])
    want = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(x)))
    got = prng.erf_inv(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))
