"""Port fluctuation primitives against repro.core.fluctuate, on the CPU.

The fmix32 hash and uniform_from_bits are exact; the Box-Muller normals and
the binomial approximation agree to the float tolerances of ``parity``. On
bfloat16 patches the port reproduces the jitted reference bit for bit: its
float32 normals and its fused multiply-add.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fluctuate as jfl
from repro_torch.core import fluctuate as tfl
from repro_torch.interop import bf16_from_numpy, key_from_data
from repro_torch.testing import parity

torch.set_num_threads(1)


def _words(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, size=n,
                                                dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1])
def test_hash_u32_exact(seed):
    x = np.concatenate([_words(4096, seed),
                        np.array([0, 1, 2**31, 2**32 - 1], np.uint32)])
    ref = np.asarray(jfl.hash_u32(jnp.asarray(x)))
    out = tfl.hash_u32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(out, ref.astype(np.int64))


def test_mul32_wraps_like_uint32():
    x = _words(4096, 3)
    for c in (tfl.FMIX_C1, tfl.FMIX_C2, 0x9E3779B9, 0x7FEB352D):
        ref = (x.astype(np.uint64) * np.uint64(c)) & np.uint64(0xFFFFFFFF)
        out = tfl.mul32(torch.from_numpy(x.astype(np.int64)), c).numpy()
        np.testing.assert_array_equal(out, ref.astype(np.int64))


def test_uniform_from_bits_exact():
    x = _words(4096, 2)
    ref = np.asarray(jfl.uniform_from_bits(jnp.asarray(x)))
    out = tfl.uniform_from_bits(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(out, ref)


def test_box_muller_close():
    rng = np.random.default_rng(4)
    u1 = rng.random(4096).astype(np.float32)
    u2 = rng.random(4096).astype(np.float32)
    ref = np.asarray(jfl.box_muller(jnp.asarray(u1), jnp.asarray(u2)))
    out = tfl.box_muller(torch.from_numpy(u1), torch.from_numpy(u2)).numpy()
    parity.assert_close(out, ref, what="box_muller")


@pytest.mark.parametrize("stream", [0, 0x9E3779B9, 123456789])
def test_counter_normals_close(stream):
    s0, s1 = 0x12345678, 0x9ABCDEF0
    pix = np.arange(64 * 256, dtype=np.uint32).reshape(64, 256)
    ref = np.asarray(jfl.counter_normals(
        jnp.uint32(s0), jnp.uint32(s1), jnp.uint32(stream), jnp.asarray(pix)))
    out = tfl.counter_normals(s0, s1, torch.tensor(stream, dtype=torch.int64),
                              torch.from_numpy(pix.astype(np.int64))).numpy()
    parity.assert_close(out, ref, what="counter_normals")


def test_binomial_normal_approx_close():
    rng = np.random.default_rng(5)
    patches = (rng.random((16, 20, 20)) * 300).astype(np.float32)
    patches[0, 0, 0] = 0.0
    charge = (rng.random(16) * 6000 + 1).astype(np.float32)
    normals = rng.standard_normal((16, 20, 20)).astype(np.float32)
    ref = np.asarray(jfl.binomial_normal_approx(
        jnp.asarray(patches), jnp.asarray(charge), jnp.asarray(normals)))
    out = tfl.binomial_normal_approx(torch.from_numpy(patches),
                                     torch.from_numpy(charge),
                                     torch.from_numpy(normals)).numpy()
    parity.assert_close(out, ref, what="binomial")


def test_fluctuate_counter_close():
    k = jax.random.key(21)
    rng = np.random.default_rng(6)
    patches = (rng.random((8, 20, 20)) * 300).astype(np.float32)
    charge = (rng.random(8) * 6000 + 1).astype(np.float32)
    ref = np.asarray(jfl.fluctuate_counter(k, jnp.asarray(patches),
                                           jnp.asarray(charge)))
    out = tfl.fluctuate_counter(key_from_data(jax.random.key_data(k)),
                                torch.from_numpy(patches),
                                torch.from_numpy(charge)).numpy()
    parity.assert_close(out, ref, what="fluctuate_counter")


def _bf16_inputs(seed, n=400):
    """bfloat16 patches of up to ~40 electrons a pixel (as a JAX array),
    float32 charges, drawn with numpy."""
    rng = np.random.default_rng(seed)
    patches = (rng.random((n, 20, 20)) * 40 * rng.random((n, 1, 1))).astype(
        np.float32)
    patches[0, 0, 0] = 0.0
    charge = (rng.random(n) * 6000 + 1).astype(np.float32)
    return jnp.asarray(patches).astype(jnp.bfloat16), charge


def test_binomial_bf16_patches_widen_and_fuse_like_jitted_reference():
    """bfloat16 patches and float32 charge give float32, and the last step
    is one fused multiply-add, as under ``jax.jit``."""
    patches, charge = _bf16_inputs(7)
    normals = np.random.default_rng(8).standard_normal(
        patches.shape).astype(np.float32)
    ref = np.asarray(jax.jit(jfl.binomial_normal_approx)(
        patches, jnp.asarray(charge), jnp.asarray(normals)))
    out = tfl.binomial_normal_approx(
        bf16_from_numpy(np.asarray(patches), device="cpu"),
        torch.from_numpy(charge), torch.from_numpy(normals))
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_fluctuate_counter_bf16_matches_jitted_reference(seed):
    """bfloat16 normals held in float32, the correctly rounded root and the
    fused multiply-add: bit for bit the jitted reference. The eager
    reference rounds the normals to bfloat16 and does not fuse; it lies
    farther from the jitted one than ``RTOL`` / ``ATOL_FRAC`` allow, so a
    port of the eager form fails here."""
    k = jax.random.key(seed)
    patches, charge = _bf16_inputs(seed)
    ref = np.asarray(jax.jit(jfl.fluctuate_counter)(k, patches,
                                                    jnp.asarray(charge)))
    out = tfl.fluctuate_counter(key_from_data(jax.random.key_data(k)),
                                bf16_from_numpy(np.asarray(patches),
                                                device="cpu"),
                                torch.from_numpy(charge))
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    eager = np.asarray(jfl.fluctuate_counter(k, patches, jnp.asarray(charge)))
    with pytest.raises(AssertionError):
        parity.assert_close(eager, ref, what="eager vs jitted reference")
