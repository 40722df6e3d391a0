"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: each test asks the ``cuda_device`` fixture, which skips
where no card is present.  Run on a machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Nothing here imports ``jax``, so the file also runs where only PyTorch is
installed.  Kernels are built with ``--fmad=false``, so on batches where
every sketch cell is written at most once they must match the plain
versions to the bit; B1's atomics reorder colliding adds, held to the
reference's collision envelope atol=2e-5.
"""
import pytest
import torch

from repro_torch.core import sketch as cs
from repro_torch.kernels import ref
from repro_torch.kernels.cs_adam import cs_adam_fused
from repro_torch.kernels.cs_adam_tiled import (cs_adam_tiled,
                                               cs_adam_tiled_plain)
from repro_torch.train.steps import make_sparse_embedding_step

pytestmark = pytest.mark.cuda
KW = dict(lr=1e-2, b2=0.999, eps=1e-8, bc1=0.19, bc2=0.002)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _state(depth, width, d, k, dev, seed, track_m=True):
    gen = torch.Generator(device=dev).manual_seed(seed)
    M = torch.randn((depth, width, d), generator=gen, device=dev) \
        if track_m else None
    V = torch.randn((depth, width, d), generator=gen, device=dev).abs()
    bm = torch.randint(0, width, (depth, k), generator=gen, device=dev,
                       dtype=torch.int32)
    bv = torch.randint(0, width, (depth, k), generator=gen, device=dev,
                       dtype=torch.int32)
    sm = torch.randint(0, 2, (depth, k), generator=gen, device=dev
                       ).float() * 2 - 1
    g = torch.randn((k, d), generator=gen, device=dev)
    return M, V, bm, sm, bv, g


def _clone(xs):
    return [None if x is None else x.clone() for x in xs]


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("track_m", [True, False])
def test_tiled_bit_equal_collision_free(cuda_device, depth, track_m):
    """Identity buckets over unique ids: every cell written once."""
    k, d, width = 512, 896, 1024
    M, V, _, sm, _, g = _state(depth, width, d, k, cuda_device, depth, track_m)
    ids = torch.randperm(width, device=cuda_device)[:k].to(torch.int32)
    b = ids[None].expand(depth, k).contiguous()
    args = (M, V, b if track_m else None, sm if track_m else None, b, g)
    kw = dict(KW, b1=0.9 if track_m else 0.0, n_valid=k - 5)
    want = cs_adam_tiled_plain(*_clone(args), **kw)
    got = cs_adam_tiled(*_clone(args), **kw)
    torch.cuda.synchronize()
    for a, c in zip(want, got):
        assert (a is None) == (c is None)
        if a is not None:
            assert torch.equal(a, c)


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("track_m", [True, False])
def test_tiled_under_heavy_collisions(cuda_device, depth, track_m):
    M, V, bm, sm, bv, g = _state(depth, 16, 128, 32, cuda_device, depth,
                                 track_m)
    args = (M, V, bm if track_m else None, sm if track_m else None, bv, g)
    kw = dict(KW, b1=0.9 if track_m else 0.0, n_valid=29)
    want = cs_adam_tiled_plain(*_clone(args), **kw)
    got = cs_adam_tiled(*_clone(args), **kw)
    for a, c in zip(want, got):
        if a is not None:
            torch.testing.assert_close(c, a, rtol=0, atol=2e-5)


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("track_m", [True, False])
def test_stream_bit_equal_to_per_item_ref(cuda_device, depth, track_m):
    M, V, bm, sm, bv, g = _state(depth, 64, 256, 96, cuda_device, depth + 7,
                                 track_m)
    args = (M, V, bm if track_m else None, sm if track_m else None, bv, g)
    kw = dict(KW, b1=0.9 if track_m else 0.0)
    want = ref.adam_fused_ref(*_clone(args), **kw)
    got = cs_adam_fused(*_clone(args), **kw)
    for a, c in zip(want, got):
        if a is not None:
            assert torch.equal(a, c)


def test_wrappers_reject_bad_inputs(cuda_device):
    M, V, bm, sm, bv, g = _state(3, 16, 32, 8, cuda_device, 0)
    with pytest.raises(ValueError, match="dtype"):
        cs_adam_tiled(M, V, bm.long(), sm, bv, g, b1=0.9, **KW)
    with pytest.raises(ValueError, match="contiguous"):
        cs_adam_fused(M, V, bm, sm, bv, g.t().contiguous().t(), b1=0.9, **KW)
    with pytest.raises(ValueError, match="disagree"):
        cs_adam_tiled(M, V, bm, sm, bv, g[:, :16].contiguous(), b1=0.9, **KW)


def test_main_path_launches_tiled_kernel(cuda_device):
    n, d = 4096, 128
    init_fn, step_fn, opt = make_sparse_embedding_step(n, d, lr=1e-3,
                                                       device=cuda_device)
    table = init_fn(torch.Generator(device=cuda_device).manual_seed(0))
    state = opt.init()
    assert state["v"].shape == cs.for_param((n, d), signed=False).shape
    before = cs_adam_tiled.launches
    ids = torch.randint(0, n, (256,), device=cuda_device, dtype=torch.int32)
    table, state = step_fn(table, state, ids, table[ids.long()] * 0.1)
    torch.cuda.synchronize()
    assert cs_adam_tiled.launches == before + 1
    assert torch.isfinite(table).all()
