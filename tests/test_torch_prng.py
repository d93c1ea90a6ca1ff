"""Port threefry (repro_torch.core.prng) against jax.random, on the CPU.

Keys, split/fold_in, raw bits and uniform draws are bit-exact; normals agree
within ``parity.NORMAL_ATOL`` (torch.erfinv vs XLA's erf_inv).
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.interop import key_from_data
from repro_torch.testing import parity

torch.set_num_threads(1)

SEEDS = [0, 1, 12345, 2**31 - 1]


def _data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def test_jax_runs_partitionable_threefry():
    """The port reproduces the partitionable mode only."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_words(seed):
    np.testing.assert_array_equal(prng.key(seed).numpy(),
                                  _data(jax.random.key(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 5])
def test_split(seed, num):
    ref = _data(jax.random.split(jax.random.key(seed), num))
    np.testing.assert_array_equal(prng.split(prng.key(seed), num).numpy(), ref)


@pytest.mark.parametrize("data", [0, 1, 3, 1000, 2**32 - 1])
def test_fold_in(data):
    ref = _data(jax.random.fold_in(jax.random.key(7), np.uint32(data)))
    np.testing.assert_array_equal(prng.fold_in(prng.key(7), data).numpy(), ref)


def test_chained_derivation_matches():
    """The launcher's fold_in(key(seed), ev) then the graph's split."""
    k = jax.random.split(jax.random.fold_in(jax.random.key(3), 2))[1]
    tk = prng.split(prng.fold_in(prng.key(3), 2))[1]
    np.testing.assert_array_equal(tk.numpy(), _data(k))


@pytest.mark.parametrize("shape", [(1,), (7, 33), (4, 5, 6)])
def test_random_bits(shape):
    ref = np.asarray(jax.random.bits(jax.random.key(11), shape))
    out = prng.random_bits(prng.key(11), shape, "cpu").numpy()
    np.testing.assert_array_equal(out, ref.astype(np.int64))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.0, 2559.0), (-1.2, 1.2),
                                   (-2.0, 2.0)])
def test_uniform_bit_exact(lo, hi):
    ref = np.asarray(jax.random.uniform(jax.random.key(5), (4096,),
                                        minval=lo, maxval=hi))
    out = prng.uniform(prng.key(5), (4096,), lo, hi, "cpu").numpy()
    np.testing.assert_array_equal(out, ref)


def test_normal_close():
    ref = np.asarray(jax.random.normal(jax.random.key(9), (20000,)))
    out = prng.normal(prng.key(9), (20000,), "cpu").numpy()
    np.testing.assert_allclose(out, ref, rtol=parity.RTOL,
                               atol=parity.NORMAL_ATOL)


def test_key_from_reference_data_round_trips():
    k = jax.random.fold_in(jax.random.key(0), 4)
    np.testing.assert_array_equal(
        key_from_data(np.asarray(jax.random.key_data(k))).numpy(), _data(k))
