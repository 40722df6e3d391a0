"""Parity of the port's low-precision cell primitives (``core/quantize.py``)
with the JAX reference, to the bit.

The step seed is JAX's threefry, reimplemented in numpy; the per-cell
bits, both stochastic roundings, the block scales and the quantizer are
integer work or single float32 operations, so every value here must
match the reference exactly.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import quantize as jqz
from repro_torch.core import quantize as tqz


def _u32(a):
    """uint32 values held in an int64 tensor -> numpy uint32."""
    return a.numpy().astype(np.uint32)


@pytest.mark.parametrize("seed,step,want", [
    (0, None, 1401327947), (0, 1, 837857529), (12345, 7, 2445744966)])
def test_step_seed_pinned(seed, step, want):
    assert tqz.step_seed(seed, step) == want
    assert int(jqz.step_seed(seed, step)) == want


def test_step_seed_sweep_matches_reference():
    rng = np.random.RandomState(0)
    seeds = list(rng.randint(0, 2 ** 31, 24)) + [0, 2 ** 31 - 1]
    steps = list(rng.randint(0, 2 ** 31, 24)) + [0, 2 ** 31 - 1]
    for seed, step in zip(seeds, steps):
        assert tqz.step_seed(int(seed), int(step)) == \
            int(jqz.step_seed(int(seed), int(step))), (seed, step)
    # the port's step counter is a host int32 tensor
    t = torch.tensor(41, dtype=torch.int32)
    assert tqz.step_seed(5, t) == int(jqz.step_seed(5, 41))


def test_threefry_block_matches_reference():
    """The raw Threefry-2x32 block against ``jax.random``'s own."""
    from jax._src import prng
    rng = np.random.RandomState(1)
    k = rng.randint(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
    x = rng.randint(0, 2 ** 32, 64, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(prng.threefry_2x32(jnp.asarray(k), jnp.asarray(x)))
    hi, lo = tqz.threefry2x32(k[0], k[1], x[:32], x[32:])
    np.testing.assert_array_equal(np.concatenate([hi, lo]), want)


@pytest.mark.parametrize("seed", [0, 7, 0xDEADBEEF, 2 ** 32 - 1])
def test_cell_bits_bit_equal(seed):
    lin = np.arange(0, 5000 * 977, 977, dtype=np.uint32)
    lin[-3:] = (0, 2 ** 32 - 1, 2 ** 31)
    want = np.asarray(jqz.cell_bits(jnp.uint32(seed), jnp.asarray(lin)))
    got = tqz.cell_bits(seed, torch.from_numpy(lin.astype(np.int64)))
    np.testing.assert_array_equal(_u32(got), want)


def test_lin_index_and_uniform_bit_equal():
    want = np.asarray(jqz._lin_index((3, 5, 7), offset=11))
    got = tqz._lin_index((3, 5, 7), offset=11)
    np.testing.assert_array_equal(_u32(got), want)
    bits = np.asarray(jqz.cell_bits(jnp.uint32(3), jnp.arange(4096,
                                                              dtype=jnp.uint32)))
    np.testing.assert_array_equal(
        tqz._uniform(torch.from_numpy(bits.astype(np.int64))).numpy(),
        np.asarray(jqz._uniform(jnp.asarray(bits))))


def _bits(n, seed):
    return np.asarray(jqz.cell_bits(jnp.uint32(seed),
                                    jnp.arange(n, dtype=jnp.uint32)))


def _values(n, seed):
    """f32 values over many magnitudes, with exact bf16 values, zeros,
    -0.0, subnormals and int8 codes among them."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * 10.0 ** rng.randint(-6, 6, n)).astype(np.float32)
    x[:8] = (0.0, -0.0, 1.0, -2.5, 1e-40, -3e-39, 127.0, -127.0)
    x[8:40] = x[8:40].astype(ml_dtypes.bfloat16).astype(np.float32)
    return x


@pytest.mark.parametrize("seed", [1, 2])
def test_sr_bfloat16_bit_equal(seed):
    x, bits = _values(20000, seed), _bits(20000, seed)
    want = np.asarray(jqz.sr_bfloat16(jnp.asarray(x), jnp.asarray(bits)))
    got = tqz.sr_bfloat16(torch.from_numpy(x),
                          torch.from_numpy(bits.astype(np.int64)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


@pytest.mark.parametrize("seed", [3, 4])
def test_sr_int8_bit_equal(seed):
    rng = np.random.RandomState(seed)
    v = (rng.randn(20000) * 60).astype(np.float32)
    v[:6] = (300.0, -300.0, 127.0, -127.0, 0.0, 126.99999)
    bits = _bits(20000, seed)
    want = np.asarray(jqz.sr_int8(jnp.asarray(v), jnp.asarray(bits)))
    got = tqz.sr_int8(torch.from_numpy(v),
                      torch.from_numpy(bits.astype(np.int64)))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def _content(shape, seed, zero_block=True):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * rng.rand(shape[0], 1, 1) * 3).astype(np.float32)
    if zero_block:
        x[:, :16] = 0.0          # a never-written block keeps scale 0
    return x


@pytest.mark.parametrize("shape,block", [((3, 40, 8), 16), ((2, 33, 4), 16),
                                         ((1, 256, 2), 256)])
def test_block_scales_and_expand_bit_equal(shape, block):
    x = _content(shape, 5)
    want = np.asarray(jqz.block_scales(jnp.asarray(x), block))
    got = tqz.block_scales(torch.from_numpy(x), block)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tqz.expand_scales(got, shape[1], block).numpy(),
        np.asarray(jqz.expand_scales(jnp.asarray(want), shape[1], block)))
    b = np.random.RandomState(6).randint(0, shape[1], (shape[0], 50))
    np.testing.assert_array_equal(
        tqz.bucket_scales(got, torch.from_numpy(b), block).numpy(),
        np.asarray(jqz.bucket_scales(jnp.asarray(want), jnp.asarray(b),
                                     block)))


@pytest.mark.parametrize("held", [False, True])
def test_quantize_dequantize_bit_equal(held):
    shape, block = (3, 40, 8), 16
    x = _content(shape, 7)
    scales = None
    if held:   # held scales too small for some content: saturation
        scales = 0.5 * np.array(jqz.block_scales(jnp.asarray(x), block))
    want = jqz.quantize(jnp.asarray(x), jnp.uint32(99), scale_block=block,
                        scales=None if scales is None else jnp.asarray(scales))
    got = tqz.quantize(torch.from_numpy(x), 99, scale_block=block,
                       scales=None if scales is None
                       else torch.from_numpy(scales))
    assert isinstance(got, tqz.QuantState) and got.cells.dtype == torch.int8
    np.testing.assert_array_equal(got.cells.numpy(), np.asarray(want.cells))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    np.testing.assert_array_equal(
        tqz.dequantize(got, block).numpy(),
        np.asarray(jqz.dequantize(want, block)))


def test_grown_scales_bit_equal():
    shape, block = (2, 48, 4), 16
    x = _content(shape, 8)
    held = np.array(jqz.block_scales(jnp.asarray(0.7 * _content(shape, 9)),
                                     block))
    want = np.asarray(jqz.grown_scales(jnp.asarray(held), jnp.asarray(x),
                                       block))
    got = tqz.grown_scales(torch.from_numpy(held), torch.from_numpy(x), block)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() >= held).all()


@pytest.mark.parametrize("dtype,want", [
    ("float32", "float32"), ("bfloat16", "bfloat16"), ("int8", "int8"),
    (torch.bfloat16, "bfloat16"), (np.dtype("int8"), "int8")])
def test_cell_dtype_names(dtype, want):
    assert tqz.cell_dtype_name(dtype) == want
    assert jqz.cell_dtype_name(want) == want


@pytest.mark.parametrize("dtype", ["float16", "float64", "int32"])
def test_unsupported_cell_dtypes_raise_value_error(dtype):
    with pytest.raises(ValueError):
        jqz.cell_dtype_name(dtype)
    with pytest.raises(ValueError, match="unsupported sketch cell dtype"):
        tqz.cell_dtype_name(dtype)


def test_n_blocks_and_constants_match():
    assert (tqz.SCALE_BLOCK, tqz.QMAX, tqz.CELL_DTYPES) == \
        (jqz.SCALE_BLOCK, jqz.QMAX, jqz.CELL_DTYPES)
    for w, blk in ((10240, 256), (1, 256), (257, 256), (40, 16)):
        assert tqz.n_blocks(w, blk) == jqz.n_blocks(w, blk)
