"""B3's column-slice schedule (``csrc/cs_ema_tiled.cu``), on the CPU.

The CUDA kernel runs one ``update_read`` call in slices of C columns,
each finished before the next: for the slice's columns it reads the
estimates and writes ``est`` and ``d`` (into one (k, C) scratch that
every slice reuses, a slice of n columns in its first k * n values),
then scatters the slice's ``d`` into the sketch.  ``_slice_model`` below
plays that schedule out with the plain version's own operations and must
give ``cs_ema_tiled_plain`` on the whole call to the bit, for any C: f32
cells signed and unsigned, the three ``ema_delta`` forms, with and
without a mask, and bf16 cells, whose rounding bits come from each
cell's linear index in the WHOLE sketch.  A model that hashes the
in-slice column instead must not match, so the global-index rule is
tested.  At a small size the model is also held to the JAX package's
``ema_update_read_xla`` at the tolerances of
``tests/test_torch_update_read.py`` (f32) and ``tests/test_torch_lowp.py``
(bf16, bit for bit).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jqz
from repro.core import stores as jstores
from repro.kernels import ops as jops
from repro_torch.core import quantize as qz
from repro_torch.core import stores as tstores
from repro_torch.core.sketch import ema_delta
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref
from repro_torch.kernels.cs_ema_tiled import (SLICE_BYTES,
                                              cs_ema_tiled_plain,
                                              slice_cols)

TOL = dict(rtol=1e-5, atol=1e-6)          # as tests/test_torch_update_read.py
# (beta, scale) of the three ema_delta forms: Adam, Adagrad, momentum
FORMS = {"adam": (0.999, 1.0 - 0.999), "adagrad": (1.0, 1.0),
         "momentum": (0.9, 1.0)}
CELLS = ["f32_signed", "f32_unsigned", "bf16_signed", "bf16_unsigned"]
DIMS = [40, 97]                            # neither a multiple of 32


def _slice_model(S, b, s, x, mask, *, beta, scale, cols, sr_seed=None,
                 in_slice_bits=False):
    """The kernel's schedule in plain PyTorch; updates S in place and
    returns ``(S, est)``.  ``in_slice_bits`` hashes a bf16 cell's
    rounding bits with its column within the slice (wrong)."""
    depth, width, d = S.shape
    k = x.shape[0]
    est = torch.empty((k, d), dtype=torch.float32)
    buf = torch.empty(k * min(cols, d), dtype=torch.float32)
    for c0 in range(0, d, cols):
        n = min(cols, d - c0)
        part = S[:, :, c0:c0 + n]
        est_old = ref.cs_query_ref(part, b, s)
        dv = ema_delta(est_old, x[:, c0:c0 + n], beta, scale)
        if mask is not None:
            dv = dv * mask
        scratch = buf[:k * n].view(k, n)
        scratch.copy_(dv)
        est[:, c0:c0 + n] = est_old + scratch
        if S.dtype != torch.bfloat16:
            S[:, :, c0:c0 + n] = ref.cs_update_ref(part.contiguous(), b, s,
                                                   scratch)
            continue
        inc = ref.cs_update_ref(torch.zeros((depth, width, n)), b, s,
                                scratch)
        row = torch.arange(depth * width, dtype=torch.int64).view(
            depth, width, 1) * d
        col = torch.arange(n, dtype=torch.int64) + (0 if in_slice_bits
                                                    else c0)
        bits = qz.cell_bits(sr_seed, (row + col) & 0xFFFFFFFF)
        S[:, :, c0:c0 + n] = qz.sr_bfloat16(part.to(torch.float32) + inc,
                                            bits)
    return S, est


def _case(cells, d, seed, k=64, width=8, depth=3):
    """Inputs at width 8: about 8 rows a bucket."""
    rng = np.random.RandomState(seed)
    signed = cells.endswith("_signed")
    S = rng.randn(depth, width, d).astype(np.float32)
    S = torch.from_numpy(S if signed else np.abs(S))
    if cells.startswith("bf16"):
        S = S.to(torch.bfloat16)
    b = torch.from_numpy(rng.randint(0, width, (depth, k)).astype(np.int32))
    s = torch.from_numpy((rng.randint(0, 2, (depth, k)) * 2 - 1).astype(
        np.float32)) if signed else None
    x = torch.from_numpy(rng.randn(k, d).astype(np.float32))
    mask = torch.from_numpy((rng.rand(k, 1) > 0.3).astype(np.float32))
    return S, b, s, x, mask


def _equal(want, got) -> bool:
    """Bit-equal sketches (bf16 as bits) and estimates."""
    (wS, west), (gS, gest) = want, got
    if wS.dtype == torch.bfloat16:
        wS, gS = wS.view(torch.int16), gS.view(torch.int16)
    return torch.equal(wS, gS) and torch.equal(west, gest)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One CPU thread: the ops here are tiny, and idle worker threads of
    several test processes only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# slice widths C as functions of d
COLS = {"1": lambda d: 1, "4": lambda d: 4, "32": lambda d: 32,
        "d-1": lambda d: d - 1, "d": lambda d: d, "d+5": lambda d: d + 5}


@pytest.mark.parametrize("cols_of", sorted(COLS))
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("cells", CELLS)
def test_slice_model_is_the_plain_version(cells, d, cols_of):
    """Every form, mask on and off: the slices give the whole call's
    bits, with a ragged last slice wherever C does not divide d."""
    cols = COLS[cols_of](d)
    seed = qz.step_seed(11, 5) if cells.startswith("bf16") else None
    for i, (form, (beta, scale)) in enumerate(sorted(FORMS.items())):
        for masked in (False, True):
            S, b, s, x, mask = _case(cells, d, seed=10 * i + masked)
            m = mask if masked else None
            kw = dict(beta=beta, scale=scale, sr_seed=seed)
            want = cs_ema_tiled_plain(S.clone(), b, s, x, m, **kw)
            got = _slice_model(S.clone(), b, s, x, m, cols=cols, **kw)
            assert _equal(want, got), (form, masked)


@pytest.mark.parametrize("cols", [1, 4, 32, 96])
@pytest.mark.parametrize("signed", [True, False])
def test_in_slice_rounding_bits_are_caught(signed, cols):
    """A bf16 model that hashes the column within its slice matches the
    plain version only when there is one slice."""
    d = 97
    S, b, s, x, mask = _case("bf16_signed" if signed else "bf16_unsigned",
                             d, seed=3)
    kw = dict(beta=0.999, scale=1.0 - 0.999, sr_seed=qz.step_seed(11, 5))
    want = cs_ema_tiled_plain(S.clone(), b, s, x, mask, **kw)
    wrong = _slice_model(S.clone(), b, s, x, mask, cols=cols,
                         in_slice_bits=True, **kw)
    assert torch.equal(want[1], wrong[1])       # est does not round
    assert not _equal(want, wrong)
    one = _slice_model(S.clone(), b, s, x, mask, cols=d, in_slice_bits=True,
                       **kw)
    assert _equal(want, one)


def test_slice_cols_at_the_dense_path_and_small_calls():
    """C = 32 at the dense path's shapes (qwen2-0.5b's table under
    ``SketchHParams()``) in f32 and bf16; one slice when the whole call
    fits; else a multiple of 32 (or of 4) whose scratch and sketch slice
    fit ``SLICE_BYTES``."""
    k, d, depth, width = 151_936, 896, 3, 10_240
    for cell_bytes in (4, 2):
        cols = slice_cols(k, d, depth, width, cell_bytes)
        assert cols == 32
        assert cols * (4 * k + cell_bytes * depth * width) <= SLICE_BYTES
        assert -(-d // cols) == 28
    assert slice_cols(384, 8, 3, 64, 4) == 8
    assert slice_cols(0, 96, 3, 16, 4) == 96
    assert slice_cols(20_000, 900, 3, 512, 4) == 288
    assert slice_cols(100_000, 97, 3, 256, 4) == 32
    assert slice_cols(1_000_000, 64, 3, 1024, 4) == 4
    assert slice_cols(10_000_000, 2, 3, 1024, 2) == 2


@pytest.mark.parametrize("cells", CELLS)
def test_slice_model_at_its_own_width(cells):
    """The model at the width ``slice_cols`` picks for a table of 100,000
    rows x 100 columns: 3 slices of 32 and one of 4."""
    S, b, s, x, mask = _case(cells, 100, seed=7, k=100_000, width=512)
    cols = slice_cols(100_000, 100, 3, 512, S.element_size())
    assert cols == 32
    kw = dict(beta=0.9, scale=1.0 - 0.9,
              sr_seed=qz.step_seed(5, 2) if cells.startswith("bf16") else None)
    want = cs_ema_tiled_plain(S.clone(), b, s, x, mask, **kw)
    got = _slice_model(S.clone(), b, s, x, mask, cols=cols, **kw)
    assert _equal(want, got)


STORES = {"sketch": (jstores.CountSketchStore, tstores.CountSketchStore),
          "countmin": (jstores.CountMinStore, tstores.CountMinStore)}


@pytest.mark.parametrize("cols", [4, 7])
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(STORES))
def test_slice_model_matches_reference_xla(kind, dtype, form, cols):
    """The dense path's ``update_read`` (every row, mask on) at 384 x 24
    through the JAX package's ``ema_update_read_xla`` and through the
    slice model on the port's addressing: f32 within ``TOL``, bf16 cells
    and estimates bit for bit."""
    beta, scale = FORMS[form]
    n, d = 384, 24
    jcls, tcls = STORES[kind]
    kw = dict(compression=8.0, width_multiple=16, seed=len(form),
              dtype=dtype)
    jspec = jcls(**kw).bind("tab", (n, d), jnp.float32).spec
    tspec = tcls(**kw).bind("tab", (n, d)).spec
    rng = np.random.RandomState(len(form) + cols)
    S = rng.randn(*tspec.shape).astype(np.float32)
    if not tspec.signed:
        S = np.abs(S)
    x = rng.randn(n, d).astype(np.float32)
    mask = (rng.rand(n, 1) > 0.3).astype(np.float32)
    jS0 = jnp.asarray(S).astype(jnp.dtype(dtype))
    # its own buffer: _slice_model writes tS0 in place, and jnp.asarray
    # may alias S while XLA still reads it asynchronously
    tS0 = torch.from_numpy(S.copy()).to(getattr(torch, dtype))
    jS, jest = jops.ema_update_read_xla(
        jspec, jS0, jnp.arange(n, dtype=jnp.int32), jnp.asarray(x),
        beta=beta, scale=scale, mask=jnp.asarray(mask),
        sr_seed=jqz.step_seed(jspec.seed, 7) if dtype != "float32" else None)
    b, s = tops._ema_addressing(tspec, None, n, torch.device("cpu"))
    tS, test = _slice_model(
        tS0, b, s, torch.from_numpy(x), torch.from_numpy(mask), beta=beta,
        scale=scale, cols=cols,
        sr_seed=qz.step_seed(tspec.seed, 7) if dtype != "float32" else None)
    if dtype == "float32":
        np.testing.assert_allclose(tS.numpy(), np.asarray(jS), **TOL)
        np.testing.assert_allclose(test.numpy(), np.asarray(jest), **TOL)
    else:
        np.testing.assert_array_equal(
            tS.view(torch.int16).numpy(),
            np.asarray(jS).view(np.uint16).view(np.int16))
        np.testing.assert_array_equal(test.numpy(), np.asarray(jest))
