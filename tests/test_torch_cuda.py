"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: each test asks the ``cuda_device`` fixture, which skips
where no card is present.  Run on a machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Nothing here imports ``jax``, so the file also runs where only PyTorch is
installed.  Kernels are built with ``--fmad=false``, so on batches where
every sketch cell is written at most once they must match the plain
versions to the bit.  B1's, B3's and B5's scatters add in the order of
the CPU ``index_add_``, so under collisions they are bit-equal to their
plain versions run on a CPU copy, and two runs give the same bits; so
are the colliding sums that go through B5 (the dedup segment sum,
``core.sketch.update`` at every cell dtype, ``DenseStore.accumulate``).
The plain versions on the card sum with ``index_add_``'s atomics and are
held to the reference's collision envelope atol=2e-5.  The bucket CSR
kernel gives the plain form's integers; B2's window rule is held to the
per-item plain version where a bucket recurs at the window's edges.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import sketch as cs
from repro_torch.core.quantize import QuantState
from repro_torch.kernels import ref
from repro_torch.kernels import cs_adam
from repro_torch.kernels.cs_adam import cs_adam_fused
from repro_torch.kernels.cs_adam_tiled import (cs_adam_tiled,
                                               cs_adam_tiled_plain)
from repro_torch.kernels.cs_ema_tiled import cs_ema_tiled, cs_ema_tiled_plain
from repro_torch.kernels.cs_query import cs_query
from repro_torch.kernels.cs_update import (SHARED_BUCKETS, bucket_csr,
                                          bucket_csr_plain, bucket_prev,
                                          cs_update)
from repro_torch.kernels.dedup import dedup_rows
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


def _cpu(xs):
    return [None if x is None else x.cpu() for x in xs]


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
    """Width 16: M and V bit-equal to the plain version on a CPU copy and
    the same bits on a second run; upd bit-equal to the plain version on
    the card (it reads the pre-step sketches) and within one ulp of the
    CPU copy's (torch's CPU f32 sqrt is not always correctly rounded)."""
    M, V, bm, sm, bv, g = _state(depth, 16, 128, 32, cuda_device, depth,
                                 track_m)
    args = (M, V, bm if track_m else None, sm if track_m else None, bv, g)
    kw = dict(KW, b1=0.9 if track_m else 0.0, n_valid=29)
    want = cs_adam_tiled_plain(*_clone(args), **kw)
    got = cs_adam_tiled(*_clone(args), **kw)
    again = cs_adam_tiled(*_clone(args), **kw)
    host = cs_adam_tiled_plain(*_cpu(args), **kw)
    torch.cuda.synchronize()
    for a, c in zip(want, got):
        if a is not None:
            torch.testing.assert_close(c, a, rtol=0, atol=2e-5)
    for h, c, c2 in zip(host[:2], got[:2], again[:2]):
        if h is not None:
            assert torch.equal(h, c.cpu())
            assert torch.equal(c, c2)
    assert torch.equal(want[2], got[2]) and torch.equal(got[2], again[2])
    torch.testing.assert_close(got[2].cpu(), host[2], rtol=1e-6, atol=0)


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


# ------------------------------------------------------------ B3, B4, B5
FORMS = {"adam": (0.999, 1.0 - 0.999), "adagrad": (1.0, 1.0),
         "momentum": (0.9, 1.0)}


def _ema_case(dev, signed, depth, width, k, d, seed, identity=False):
    gen = torch.Generator(device=dev).manual_seed(seed)
    S = torch.randn((depth, width, d), generator=gen, device=dev)
    if identity:
        b = torch.randperm(width, generator=gen, device=dev)[:k].to(
            torch.int32)[None].expand(depth, k).contiguous()
    else:
        b = torch.randint(0, width, (depth, k), generator=gen, device=dev,
                          dtype=torch.int32)
    s = (torch.randint(0, 2, (depth, k), generator=gen, device=dev).float()
         * 2 - 1) if signed else None
    if not signed:
        S = S.abs()
    x = torch.randn((k, d), generator=gen, device=dev)
    mask = (torch.rand((k, 1), generator=gen, device=dev) > 0.3).float()
    return S, b, s, x, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("signed", [True, False])
def test_ema_tiled_against_plain(cuda_device, signed, form, masked):
    """Bit-equal where every cell is written once; under heavy collisions
    within the envelope of the plain version on the card (its
    index_add_ uses atomics) and bit-equal to it on a CPU copy (the
    kernel adds in index_add_'s CPU order)."""
    beta, scale = FORMS[form]
    for identity, width in ((True, 1024), (False, 16)):
        S, b, s, x, mask = _ema_case(cuda_device, signed, 3, width, 512, 96,
                                     len(form), identity)
        m = mask if masked else None
        want = cs_ema_tiled_plain(S.clone(), b, s, x, m, beta=beta,
                                  scale=scale)
        got = cs_ema_tiled(S.clone(), b, s, x, m, beta=beta, scale=scale)
        torch.cuda.synchronize()
        if identity:
            assert all(torch.equal(a, c) for a, c in zip(want, got))
        else:
            for a, c in zip(want, got):
                torch.testing.assert_close(c, a, rtol=0, atol=2e-5)
            host = cs_ema_tiled_plain(*_cpu([S, b, s, x, m]), beta=beta,
                                      scale=scale)
            assert all(torch.equal(a, c.cpu()) for a, c in zip(host, got))


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("signed", [True, False])
def test_query_bit_equal(cuda_device, signed, depth):
    S, b, s, _, _ = _ema_case(cuda_device, signed, depth, 64, 300, 160, depth)
    torch.testing.assert_close(cs_query(S, b, s), ref.cs_query_ref(S, b, s),
                               rtol=0, atol=0)


@pytest.mark.parametrize("signed", [True, False])
def test_update_against_plain(cuda_device, signed):
    for identity, width in ((True, 1024), (False, 16)):
        S, b, s, x, _ = _ema_case(cuda_device, signed, 3, width, 512, 96, 5,
                                  identity)
        want = ref.cs_update_ref(S.clone(), b, s, x)
        got = cs_update(S.clone(), b, s, x)
        torch.cuda.synchronize()
        if identity:
            assert torch.equal(want, got)
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
            host = ref.cs_update_ref(*_cpu([S, b, s, x]))
            assert torch.equal(host, got.cpu())


def test_sketch_wrappers_reject_bad_inputs(cuda_device):
    S, b, s, x, mask = _ema_case(cuda_device, True, 3, 16, 8, 32, 0)
    with pytest.raises(ValueError, match="dtype"):
        cs_query(S, b.long(), s)
    with pytest.raises(ValueError, match="disagree"):
        cs_update(S, b, s, x[:, :16].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        cs_ema_tiled(S, b, s, x.t().contiguous().t(), mask, beta=0.9,
                     scale=0.1)


def test_dense_path_launches_ema_kernel(cuda_device):
    from repro_torch.core.optimizers import SketchHParams, countsketch_adam
    from repro_torch.core.partition import SketchPolicy
    opt = countsketch_adam(1e-3, policy=SketchPolicy(),
                           hparams=SketchHParams(backend="auto"))
    params = {"tok_embed": {"table": torch.randn(4096, 128,
                                                 device=cuda_device)}}
    state = opt.init(params)
    before = cs_ema_tiled.launches
    grads = {"tok_embed": {"table": torch.randn(4096, 128,
                                                device=cuda_device)}}
    updates, state = opt.update(grads, state)
    torch.cuda.synchronize()
    assert cs_ema_tiled.launches == before + 2
    assert torch.isfinite(updates["tok_embed"]["table"]).all()


# ------------------------------------------------------------ B3, bf16 cells
def _bf16_within(got: torch.Tensor, want: torch.Tensor, atol: float) -> bool:
    """Every bf16 cell within one bf16 ulp of ``want`` plus ``atol``."""
    g, w = got.float(), want.float()
    ulp = torch.ldexp(torch.ones_like(w),
                      torch.frexp(torch.maximum(g.abs(), w.abs()))[1] - 8)
    return bool(((g - w).abs() <= ulp + atol).all())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("signed", [True, False])
def test_ema_tiled_bf16_against_plain(cuda_device, signed, form, masked):
    """B3's bf16 branch: bit-equal to its plain version on a CPU copy, in
    the bf16 cells and ``est``, with and without bucket collisions (the
    scatter sums each cell's increments in item order, as the CPU
    index_add_ does).  Against the plain version on the card, whose
    index_add_ sums in atomic order, ``est`` is bit-equal and, under
    collisions, a cell may round apart: its f32 increment is summed in another order, which
    moves it by up to the f32 collision envelope (atol 2e-5, as for f32
    cells), and the rounding of the sum may then go the other way (one
    bf16 ulp).  Measured: 3 ulps at one cell where the increments cancel
    to near the cell's value."""
    from repro_torch.core import quantize as qz
    beta, scale = FORMS[form]
    seed = qz.step_seed(17, 3)
    for identity, width in ((True, 1024), (False, 16)):
        S, b, s, x, mask = _ema_case(cuda_device, signed, 3, width, 512, 96,
                                     len(form), identity)
        S = S.to(torch.bfloat16)
        m = mask if masked else None
        kw = dict(beta=beta, scale=scale, sr_seed=seed)
        got = cs_ema_tiled(S.clone(), b, s, x, m, **kw)
        want = cs_ema_tiled_plain(S.clone(), b, s, x, m, **kw)
        torch.cuda.synchronize()
        host = cs_ema_tiled_plain(*_cpu([S, b, s, x, m]), **kw)
        assert got[0].dtype == torch.bfloat16
        assert torch.equal(host[0].view(torch.int16),
                           got[0].cpu().view(torch.int16))
        assert torch.equal(host[1], got[1].cpu())
        assert torch.equal(want[1], got[1])
        if identity:
            assert torch.equal(want[0].view(torch.int16),
                               got[0].view(torch.int16))
        else:
            assert _bf16_within(got[0], want[0], atol=2e-5)


def test_ema_tiled_bf16_needs_a_seed_and_counts_apart(cuda_device):
    from repro_torch.kernels.cs_ema_tiled import cs_ema_tiled_bf16
    S, b, s, x, mask = _ema_case(cuda_device, True, 3, 16, 8, 32, 0)
    S = S.to(torch.bfloat16)
    with pytest.raises(ValueError, match="sr_seed"):
        cs_ema_tiled(S, b, s, x, mask, beta=0.9, scale=0.1)
    f32, bf16 = cs_ema_tiled.launches, cs_ema_tiled_bf16.launches
    cs_ema_tiled(S, b, s, x, mask, beta=0.9, scale=0.1, sr_seed=1)
    assert (cs_ema_tiled.launches, cs_ema_tiled_bf16.launches) == \
        (f32, bf16 + 1)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_dense_path_low_precision_cells(cuda_device, dtype):
    """bf16 sketches run B3's bf16 kernel twice a step; int8 sketches run
    the plain xla form and launch no B3."""
    from repro_torch.core.optimizers import SketchHParams, countsketch_adam
    from repro_torch.core.partition import SketchPolicy
    from repro_torch.kernels.cs_ema_tiled import cs_ema_tiled_bf16
    opt = countsketch_adam(1e-3, policy=SketchPolicy(),
                           hparams=SketchHParams(backend="auto", dtype=dtype))
    params = {"tok_embed": {"table": torch.randn(4096, 128,
                                                 device=cuda_device)}}
    state = opt.init(params)
    before = (cs_ema_tiled.launches, cs_ema_tiled_bf16.launches)
    for _ in range(2):
        grads = {"tok_embed": {"table": torch.randn(4096, 128,
                                                    device=cuda_device)}}
        updates, state = opt.update(grads, state)
    torch.cuda.synchronize()
    after = (cs_ema_tiled.launches, cs_ema_tiled_bf16.launches)
    want = (0, 4) if dtype == "bfloat16" else (0, 0)
    assert (after[0] - before[0], after[1] - before[1]) == want
    assert torch.isfinite(updates["tok_embed"]["table"]).all()


def test_async_cleaner_equals_sync_on_the_card(cuda_device):
    """The decay on a side stream, waited on by the main stream, gives the
    sync schedule's sketches to the bit."""
    from repro_torch.core.cleaning import AsyncCleaner, CleaningSchedule
    from repro_torch.core.optimizers import adam_from_stores, apply_updates
    from repro_torch.core.stores import (CountMinStore, CountSketchStore,
                                         StoreTree)

    def run(mode):
        sched = CleaningSchedule(alpha=0.5, every=3, mode=mode)
        tree = StoreTree(rules=(("w", CountSketchStore(backend="auto"),
                                 CountMinStore(backend="auto",
                                               cleaning=sched)),))
        opt = adam_from_stores(1e-2, tree)
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        p = {"w": torch.randn((4096, 64), generator=gen, device=cuda_device)}
        st = opt.init(p)
        cleaner = AsyncCleaner(sched) if mode == "async" else None
        for step in range(1, 8):
            if cleaner is not None:
                st, _ = cleaner.maybe_dispatch(st, step)
            g = torch.randn((4096, 64), generator=gen, device=cuda_device)
            u, st = opt.update({"w": g}, st)
            apply_updates(p, u)
        torch.cuda.synchronize()
        if cleaner is not None:
            assert cleaner.dispatched == 2 and not cleaner.in_flight()
        return p["w"], st["v"]["w"]

    (pw, pv), (qw, qv) = run("sync"), run("async")
    assert torch.equal(pw, qw) and torch.equal(pv, qv)


# ------------------------------------------------- B3 in column slices
# name: (k, d, width); the slices are cs_ema_tiled.slice_cols wide
SLICE_CASES = {
    "d900_slices": (20_000, 900, 512),   # 3 slices of 288, one of 36
    "d97_slices": (100_000, 97, 256),    # 4-byte path: 3 of 32, one of 1
    "d64_one_slice": (2_048, 64, 256),   # d below one slice
    "k1": (1, 96, 16),
    "k0": (0, 96, 16),
}


def _ema_slices_check(S, b, s, x, mask, kw, offset=0):
    """One call on a copy of S that lies ``offset`` cells into its
    buffer: counted once, bit-equal to the plain version on a CPU copy,
    and against it on the card within the collision envelope (f32) or
    est bit-equal and cells within one ulp + 2e-5 (bf16)."""
    from repro_torch.kernels.cs_ema_tiled import cs_ema_tiled_bf16
    bf16 = S.dtype == torch.bfloat16
    counter = cs_ema_tiled_bf16 if bf16 else cs_ema_tiled
    work = torch.empty(S.numel() + offset, dtype=S.dtype,
                       device=S.device)[offset:].view(S.shape)
    work.copy_(S)
    before = counter.launches
    got = cs_ema_tiled(work, b, s, x, mask, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = cs_ema_tiled_plain(S.clone(), b, s, x, mask, **kw)
    host = cs_ema_tiled_plain(*_cpu([S, b, s, x, mask]), **kw)
    if bf16:
        assert torch.equal(host[0].view(torch.int16),
                           got[0].cpu().view(torch.int16))
        assert torch.equal(want[1], got[1])
        assert _bf16_within(got[0], want[0], atol=2e-5)
    else:
        for a, c in zip(want, got):
            torch.testing.assert_close(c, a, rtol=0, atol=2e-5)
        assert torch.equal(host[0], got[0].cpu())
    assert torch.equal(host[1], got[1].cpu())


@pytest.mark.parametrize("cells", ["f32_signed", "f32_unsigned", "bf16"])
@pytest.mark.parametrize("case", sorted(SLICE_CASES))
def test_ema_tiled_slices(cuda_device, case, cells):
    """B3 f32 and bf16 where d is not a multiple of the slice width, below
    one slice, at k = 1 and k = 0, and over several slices."""
    from repro_torch.core import quantize as qz
    from repro_torch.kernels.cs_ema_tiled import slice_cols
    k, d, width = SLICE_CASES[case]
    S, b, s, x, mask = _ema_case(cuda_device, cells != "f32_unsigned", 3,
                                 width, k, d, len(case))
    if cells == "bf16":
        S = S.to(torch.bfloat16)
    cols = slice_cols(k, d, 3, width, S.element_size())
    assert (cols < d) == case.endswith("_slices")
    kw = dict(beta=0.999, scale=1.0 - 0.999,
              sr_seed=qz.step_seed(3, 9) if cells == "bf16" else None)
    _ema_slices_check(S, b, s, x, mask, kw)


@pytest.mark.parametrize("cells", ["f32", "bf16"])
def test_ema_tiled_misaligned_sketch_takes_4_byte_path(cuda_device, cells):
    """A sketch that starts two cells into its buffer, off the 16-byte
    (f32) or 8-byte (bf16) alignment of the wide accesses: the 4-byte
    path, the same bits."""
    from repro_torch.core import quantize as qz
    S, b, s, x, mask = _ema_case(cuda_device, True, 3, 64, 700, 96, 2)
    if cells == "bf16":
        S = S.to(torch.bfloat16)
    kw = dict(beta=0.9, scale=1.0,
              sr_seed=qz.step_seed(3, 9) if cells == "bf16" else None)
    _ema_slices_check(S, b, s, x, mask, kw, offset=2)


# ------------------------------------------ bucket CSR, B5 and B2 hazards
def _csr_case(name, dev):
    gen = torch.Generator(device=dev).manual_seed(11)
    if name == "zipf":
        width, k = 10_240, 16_384
        ids = torch.empty(k, device=dev).exponential_(generator=gen)
        b = (ids * 900).long() % width
        b = torch.stack([b, (b * 7 + 3) % width, (b * 13 + 5) % width])
    elif name == "width1":
        width, k = 1, 3_000
        b = torch.zeros((3, k), dtype=torch.long, device=dev)
    elif name == "one_bucket":
        width, k = 512, 5_000
        b = torch.full((2, k), 77, dtype=torch.long, device=dev)
    elif name == "last_bucket":
        width, k = 300, 2_000
        b = torch.randint(width - 3, width, (3, k), generator=gen,
                          device=dev)
    elif name == "empty":
        width, k = 64, 0
        b = torch.zeros((3, 0), dtype=torch.long, device=dev)
    elif name == "wide":
        width, k = SHARED_BUCKETS + 1_000, 7_000
        b = torch.randint(0, width, (3, k), generator=gen, device=dev)
    else:
        width, k = 10_240, 151_936
        b = (torch.arange(k, device=dev)[None] * torch.tensor(
            [[2_654_435_761], [40_503], [97]], device=dev)) % width
    return b.to(torch.int32).contiguous(), width


@pytest.mark.parametrize("name", ["zipf", "width1", "one_bucket",
                                  "last_bucket", "empty", "wide", "dense"])
def test_bucket_csr_kernel_equals_plain(cuda_device, name):
    b, width = _csr_case(name, cuda_device)
    before = bucket_csr.launches
    order, starts = bucket_csr(b, width)
    prev = bucket_prev(b, width)
    torch.cuda.synchronize()
    assert bucket_csr.launches == before + 2
    want = bucket_csr_plain(b, width)
    for got, exp in zip((order, starts, prev), want):
        assert got.dtype == torch.int32
        assert torch.equal(got, exp)


def test_update_width_one_and_odd_d(cuda_device):
    """One run of all k items (width 1), d not a multiple of 4 (the scalar
    path), runs long enough for the long-run blocks (64 items or more) in
    both paths and over several column slices, and rows wider than a
    block: bit-equal to the plain version on a CPU copy."""
    for width, d in ((1, 96), (16, 93), (1_024, 5), (4, 93), (2, 260),
                     (64, 4_096), (3, 4_100)):
        S, b, s, x, _ = _ema_case(cuda_device, True, 3, width, 700, d, 9)
        got = cs_update(S.clone(), b, s, x)
        torch.cuda.synchronize()
        assert torch.equal(ref.cs_update_ref(*_cpu([S, b, s, x])), got.cpu())


def _hazard_buckets(k, dists, dev):
    """Row r puts item i in bucket i % dists[r]: each item's last earlier
    item in its bucket is exactly dists[r] places back."""
    i = torch.arange(k, device=dev)
    return torch.stack([i % dd for dd in dists]).to(torch.int32).contiguous()


@pytest.mark.parametrize("k", [5, 100])
def test_stream_window_hazards(cuda_device, k):
    """The same bucket recurring 1, L-1, L and L+1 items back (L the
    kernel's window), with k below one tile and past a few: bit-equal to
    the per-item plain version."""
    L = cs_adam.WINDOW
    dists = [1, L - 1, L, L + 1]
    d = 40
    for track_m in (True, False):
        M, V, _, _, _, g = _state(len(dists), 64, d, k, cuda_device, k,
                                  track_m)
        bm = _hazard_buckets(k, dists, cuda_device)
        bv = _hazard_buckets(k, dists[::-1], cuda_device)
        sm = (torch.arange(len(dists) * k, device=cuda_device) % 3 == 0
              ).float().reshape(len(dists), k) * 2 - 1
        args = (M, V, bm if track_m else None, sm if track_m else None, bv,
                g)
        kw = dict(KW, b1=0.9 if track_m else 0.0)
        want = ref.adam_fused_ref(*_clone(args), **kw)
        got = cs_adam_fused(*_clone(args), **kw)
        torch.cuda.synchronize()
        for a, c in zip(want, got):
            if a is not None:
                assert torch.equal(a, c)


# ------------------------------------ C1: colliding sums in the CPU's order
def _zipf_ids(n, k, dev, seed):
    """Duplicate-heavy zipf ids: the head repeats hundreds of times."""
    rng = np.random.RandomState(seed)
    ids = ((rng.zipf(1.1, k) - 1) % n).astype(np.int32)
    return torch.from_numpy(ids).to(dev)


def _to(state, dev):
    if isinstance(state, QuantState):
        return QuantState(state.cells.to(dev), state.scales.to(dev))
    return state.to(dev)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_dedup_rows_sums_in_cpu_order(cuda_device):
    ids = _zipf_ids(5_000, 6_000, cuda_device, 1)
    rows = torch.randn((6_000, 96), device=cuda_device)
    before = cs_update.launches
    got = dedup_rows(ids, rows)
    again = dedup_rows(ids, rows)
    host = dedup_rows(*_cpu([ids, rows]))
    torch.cuda.synchronize()
    assert cs_update.launches == before + 2
    for a, b, h in zip(got, again, host):
        assert torch.equal(a, b) and torch.equal(a.cpu(), h)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("signed", [True, False])
def test_sketch_update_in_cpu_order(cuda_device, dtype, signed):
    """``core.sketch.update`` on duplicate-heavy ids: two runs on the card
    and a CPU copy give the same cells (and int8 scales) to the bit."""
    spec = cs.SketchSpec(depth=3, width=64, dim=96, signed=signed, seed=3,
                         dtype=dtype)
    ids = _zipf_ids(5_000, 4_000, cuda_device, 2)
    delta = torch.randn((4_000, 96), device=cuda_device)
    S = cs.update(spec, cs.init(spec, cuda_device), ids,
                  torch.randn_like(delta), sr_seed=5)
    before = cs_update.launches
    outs = [_to(cs.update(spec, _to(cs.clone(S), dev), ids.to(dev),
                          delta.to(dev), sr_seed=7), "cpu")
            for dev in (cuda_device, cuda_device, torch.device("cpu"))]
    torch.cuda.synchronize()
    assert cs_update.launches == before + 2
    leaves = [list(o) if isinstance(o, QuantState) else [o] for o in outs]
    for got in leaves[:2]:
        for a, h in zip(got, leaves[2]):
            assert torch.equal(_bits(a), _bits(h))


def test_dense_store_accumulate_in_cpu_order(cuda_device):
    from repro_torch.core.stores import DenseStore
    store = DenseStore().bind("t", (5_000, 96), torch.float32)
    ids = _zipf_ids(5_000, 6_000, cuda_device, 3)
    delta = torch.randn((6_000, 96), device=cuda_device)
    before = cs_update.launches
    got = [store.accumulate(store.init(cuda_device) + 1.0, delta, ids,
                            scale=0.1) for _ in range(2)]
    host = store.accumulate(store.init("cpu") + 1.0, delta.cpu(), ids.cpu(),
                            scale=0.1)
    torch.cuda.synchronize()
    assert cs_update.launches == before + 2
    assert torch.equal(got[0], got[1]) and torch.equal(got[0].cpu(), host)


@pytest.mark.parametrize("track_m", [True, False])
def test_tiled_path_in_cpu_order(cuda_device, track_m):
    """``ops.adam_rows_tiled`` as the step calls it (dedup, B1 with the
    per-position output) on zipf ids whose head repeats hundreds of times,
    at a narrow width: M and V bit-equal to a CPU copy and the same bits
    on a second run, the update equal on both runs, within one ulp of the
    CPU copy's (torch's CPU sqrt), and zero at every later duplicate."""
    from repro_torch.kernels import ops
    spec_m = cs.SketchSpec(depth=3, width=256, dim=96, signed=True, seed=1)
    spec_v = cs.SketchSpec(depth=3, width=256, dim=96, signed=False, seed=2)
    ids = _zipf_ids(5_000, 3_000, cuda_device, 4)
    g = torch.randn((3_000, 96), device=cuda_device)
    M = torch.randn(spec_m.shape, device=cuda_device) if track_m else None
    V = torch.rand(spec_v.shape, device=cuda_device)
    sm = spec_m if track_m else None
    kw = dict(lr=1e-2, b1=0.9 if track_m else 0.0, b2=0.999, eps=1e-8)
    before = cs_adam_tiled.launches
    runs = [ops.adam_rows_tiled(sm, spec_v, *_clone([M, V]), ids, g, 3,
                                **kw) for _ in range(2)]
    host = ops.adam_rows_tiled(sm, spec_v, *_cpu([M, V, ids, g]), 3, **kw)
    torch.cuda.synchronize()
    assert cs_adam_tiled.launches == before + 2
    for a, b, h in zip(runs[0], runs[1], host):
        if h is not None:
            assert torch.equal(a, b)
    for a, h in zip(runs[0][:2], host[:2]):
        if h is not None:
            assert torch.equal(a.cpu(), h)
    torch.testing.assert_close(runs[0][2].cpu(), host[2], rtol=1e-6, atol=0)
    first = torch.zeros(3_000, dtype=torch.bool)
    first[np.unique(ids.cpu().numpy(), return_index=True)[1]] = True
    assert not runs[0][2].cpu()[~first].any()


def test_tiled_full_width_in_cpu_order(cuda_device):
    """The main path's shapes: a 16,384-id zipf batch into SketchHParams()
    sketches of a 151,936 x 896 table: M and V bit-equal to a CPU copy."""
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.kernels import ops
    hp = SketchHParams()
    spec_m = hp.spec("t", (151_936, 896), signed=True)
    spec_v = hp.spec("t", (151_936, 896), signed=False)
    ids = _zipf_ids(151_936, 16_384, cuda_device, 5)
    g = torch.randn((16_384, 896), device=cuda_device)
    M = torch.randn(spec_m.shape, device=cuda_device) * 1e-3
    V = torch.rand(spec_v.shape, device=cuda_device) * 1e-3
    got = ops.adam_rows_tiled(spec_m, spec_v, M.clone(), V.clone(), ids, g,
                              9, lr=1e-3)
    host = ops.adam_rows_tiled(spec_m, spec_v, *_cpu([M, V, ids, g]), 9,
                               lr=1e-3)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), host[0])
    assert torch.equal(got[1].cpu(), host[1])
    torch.testing.assert_close(got[2].cpu(), host[2], rtol=1e-6, atol=0)


# ------------------------------ the extreme step's shapes and C1's last sites
EXTREME_TABLES = {256: (65_536, 16_384), 7_168: (2_097_152, 2_048)}


@pytest.mark.parametrize("width", sorted(EXTREME_TABLES))
@pytest.mark.parametrize("track_m", [True, False])
def test_b1_at_extreme_shapes(cuda_device, width, track_m):
    """B1 at d=64 as the extreme step calls it: the feature table's
    (3, 256, 64) sketches under 16,384 zipf(1.05) ids, the class head's
    (3, 7,168, 64) under 2,048.  Against the plain version on the card (M
    and V within atol 2e-5, upd bit-equal at each first position), a CPU
    copy (M and V bit-equal, upd within rtol 1e-6) and a second run (the
    same bits)."""
    from repro_torch.kernels import dedup as dd, ops
    from repro_torch.kernels.cs_adam_tiled import at_positions
    n, k = EXTREME_TABLES[width]
    rng = np.random.RandomState(width)
    ids = torch.from_numpy(((rng.zipf(1.05, k) - 1) % n).astype(np.int32)
                           ).to(cuda_device)
    spec_m = cs.SketchSpec(depth=3, width=width, dim=64, signed=True, seed=1)
    spec_v = cs.SketchSpec(depth=3, width=width, dim=64, signed=False,
                           seed=2)
    g = torch.randn((k, 64), device=cuda_device) * 1e-2
    M = torch.randn(spec_m.shape, device=cuda_device) * 1e-3 \
        if track_m else None
    V = torch.rand(spec_v.shape, device=cuda_device) * 1e-4
    batch = dd.dedup_rows(ids, g)
    bm, sm, bv = ops._adam_addressing(spec_m if track_m else None, spec_v,
                                      batch.unique_ids)
    kw = dict(KW, b1=0.9 if track_m else 0.0)
    args = (M, V, bm, sm, bv, batch.rows)
    want = cs_adam_tiled_plain(*_clone(args), n_valid=batch.n_unique, **kw)
    runs = [cs_adam_tiled(*_clone(args), n_valid=batch.n_unique,
                          positions=(batch.inv, batch.first_pos), **kw)
            for _ in range(2)]
    host = cs_adam_tiled(*_cpu(args), n_valid=batch.n_unique.cpu(),
                         positions=(batch.inv.cpu(), batch.first_pos.cpu()),
                         **kw)
    torch.cuda.synchronize()
    assert torch.equal(at_positions(want[2], batch.first_pos), runs[0][2])
    for a, c in zip(want[:2], runs[0][:2]):
        if a is not None:
            torch.testing.assert_close(c, a, rtol=0, atol=2e-5)
    for a, b, h in zip(runs[0], runs[1], host):
        if h is not None:
            assert torch.equal(a, b)
    for a, h in zip(runs[0][:2], host[:2]):
        if h is not None:
            assert torch.equal(a.cpu(), h)
    torch.testing.assert_close(runs[0][2].cpu(), host[2], rtol=1e-6, atol=0)


def _part1_site(name, dev):
    """One repaired C1 site on ``dev``: a function of nothing that returns
    its outputs, on inputs made from one seed (duplicate-heavy ids)."""
    from repro_torch.core import optimizers as opt_lib
    from repro_torch.core.stores import DenseStore
    from repro_torch.kernels import ops
    rng = np.random.RandomState(len(name))
    n, k, d = 3_000, 4_000, 40
    ids = torch.from_numpy(((rng.zipf(1.1, k) - 1) % n).astype(np.int32)
                           ).to(dev)
    rows = torch.from_numpy((rng.randn(k, d) * 10.0 ** rng.randint(
        -3, 3, (k, 1))).astype(np.float32)).to(dev)
    table = torch.from_numpy(rng.randn(n, d).astype(np.float32)).to(dev)
    if name == "apply_sparse_updates":
        return lambda: [opt_lib.apply_sparse_updates(
            table.clone(), {"ids": ids, "rows": rows})]
    if name == "dense_store_1d":
        store = DenseStore().bind("s", (n,), torch.float32)
        return lambda: [store.accumulate(table[:, 0].clone(), rows[:, 0],
                                         ids, scale=0.5)]
    dtype, fn = {"ema_xla_f32": ("float32", ops.ema_update_read_xla),
                 "ema_xla_bf16": ("bfloat16", ops.ema_update_read_xla),
                 "ema_ref_bf16": ("bfloat16", ops.ema_update_read_ref),
                 "ema_int8": ("int8", ops.ema_update_read_xla)}[name]
    spec = cs.SketchSpec(depth=3, width=64, dim=d, signed=True, seed=4,
                         dtype=dtype)
    S0 = cs.update(spec, cs.init(spec, dev), ids, rows, sr_seed=3)

    def run():
        S, est = fn(spec, cs.clone(S0), ids, rows, beta=0.9, scale=0.1,
                    sr_seed=11)
        leaves = list(S) if isinstance(S, QuantState) else [S]
        return [_bits(x) for x in leaves] + [est]
    return run


PART1_SITES = ["apply_sparse_updates", "dense_store_1d", "ema_xla_f32",
               "ema_xla_bf16", "ema_ref_bf16", "ema_int8"]


@pytest.mark.parametrize("name", PART1_SITES)
def test_part1_sites_in_cpu_order(cuda_device, name):
    """Each colliding sum repaired for the extreme slice adds in the CPU
    ``index_add_``'s order through B5: two runs on the card and a CPU copy
    give the same bits."""
    before = cs_update.launches
    runs = [_part1_site(name, cuda_device)() for _ in range(2)]
    host = _part1_site(name, torch.device("cpu"))()
    torch.cuda.synchronize()
    assert cs_update.launches > before
    for a, b, h in zip(runs[0], runs[1], host):
        assert torch.equal(a, b) and torch.equal(a.cpu(), h)
