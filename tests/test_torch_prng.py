"""Port threefry (repro_torch.core.prng) against jax.random, on the CPU.

Keys, split/fold_in, raw bits and uniform draws are bit-exact; float32
normals agree within ``parity.NORMAL_ATOL`` (torch.erfinv vs XLA's
erf_inv); bfloat16 uniforms and normals are bit-exact, both as
``jax.random`` returns them and as a jitted consumer holds the normals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.interop import bf16_bits, key_from_data
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


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [1, 2, 5])
def test_split_words(seed, num):
    """The host-integer split the noise stage's plane keys take: the words
    of ``jax.random.split``'s keys, as ``split`` gives them."""
    ref = _data(jax.random.split(jax.random.key(seed), num))
    k = prng.key(seed)
    assert prng.split_words(k, num) == tuple(map(tuple, ref.tolist()))
    assert prng.split_words(k, num) == tuple(map(tuple, prng.split(
        k, num).tolist()))


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


#: keys of the bfloat16 draws
BF16_SEEDS = [0, 5, 123]


@pytest.mark.parametrize("seed", BF16_SEEDS)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (prng.NORMAL_LO_BF16, 1.0),
                                   (-1.2, 1.7), (0.0, 2559.0)])
def test_uniform_bf16_bit_exact(seed, lo, hi):
    """8 random bits a draw, bfloat16 bounds, each op rounded to bfloat16;
    an odd size."""
    ref = jax.random.uniform(jax.random.key(seed), (4099,), jnp.bfloat16,
                             lo, hi)
    out = prng.uniform(prng.key(seed), (4099,), lo, hi, "cpu", torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf16_bits(out), bf16_bits(ref))


@pytest.mark.parametrize("seed", BF16_SEEDS)
@pytest.mark.parametrize("shape", [(7, 33), (100003,)])
def test_normal_bf16_bit_exact(seed, shape):
    ref = jax.random.normal(jax.random.key(seed), shape, jnp.bfloat16)
    out = prng.normal(prng.key(seed), shape, "cpu", torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf16_bits(out), bf16_bits(ref))


def test_bf16_normal_table_reaches_every_entry():
    """A draw of 100 003 normals takes all 128 values of the table, and each
    equals the reference's normal at every position that takes it."""
    k = prng.key(9)
    index = ((prng.random_bits(k, (100003,), "cpu") & 0xFF) >> 1).numpy()
    assert np.unique(index).size == 128
    ref = bf16_bits(jax.random.normal(jax.random.key(9), (100003,),
                                      jnp.bfloat16))
    table = bf16_bits(prng._bf16_normal_table("cpu").to(torch.bfloat16))
    assert table.shape == (128,)
    np.testing.assert_array_equal(table[index], ref)


@pytest.mark.parametrize("seed", BF16_SEEDS)
def test_bf16_normals_as_a_jitted_consumer_holds_them(seed):
    """Inside a jitted computation XLA keeps ``sqrt(2) * erfinv(u)`` in
    float32 (excess precision): ``normal_bf16_wide`` equals that, bit for
    bit, and differs from the bfloat16-rounded normals."""
    shape = (5, 41, 19)
    ref = np.asarray(jax.jit(lambda k: jax.random.normal(
        k, shape, jnp.bfloat16).astype(jnp.float32))(jax.random.key(seed)))
    out = prng.normal_bf16_wide(prng.key(seed), shape, "cpu")
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    rounded = prng.normal(prng.key(seed), shape, "cpu", torch.bfloat16)
    assert not torch.equal(rounded.to(torch.float32), out)


def test_draws_refuse_other_dtypes():
    with pytest.raises(NotImplementedError, match="float16"):
        prng.uniform(prng.key(0), (4,), 0.0, 1.0, "cpu", torch.float16)
    with pytest.raises(NotImplementedError, match="float16"):
        prng.normal(prng.key(0), (4,), "cpu", torch.float16)
