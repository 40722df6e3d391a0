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
per-item plain version where a bucket recurs at the window's edges.  A
planned extreme step (``plan_extreme``) on ``tiled`` equals ``xla`` to
the bit, and an async checkpoint of CUDA tensors restores the pre-write
values to the bit.  Serving: a coalesced batch on ``tiled`` equals its
raw concatenation to the bit, the double buffer publishes behind its
event with held generations unchanged, and ``TableMonitor.collect``
dispatches under sync-debug mode "error".  The LM stack at qwen2-0.5b's
``reduced()`` shapes: the embedding gather's backward gives the same
bits twice on zipf-repeated tokens, the train step on ``auto`` (B3)
equals ``xla`` and itself to the bit (also whisper-medium's and
internvl2-2b's, with their stub frames and patches) and follows a CPU copy (losses
rtol 1e-4, state rtol 1e-4/atol 1e-5), flash attention matches the
CPU's within the reference's envelopes (atol 1e-4 forward, 1e-3
gradients), and decode matches the prefill of its prefix.
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


@pytest.mark.parametrize("optimizer", ["cs_rmsprop", "cs_adam"])
def test_planned_extreme_step_tiled_equals_xla(cuda_device, optimizer):
    """A planned extreme step (``plan_extreme``) on ``tiled`` (B1) and on
    plain ``xla``: tables, states and losses equal to the bit."""
    from repro_torch.data import ExtremeStream
    from repro_torch.train import extreme as tx
    cfg = tx.MachConfig(n_classes=50_000, n_meta=4096, n_features=2048,
                        dim=16, nnz=8, n_negatives=64)
    plan = tx.plan_extreme(cfg, "0.5x", optimizer=optimizer)
    stream = tx.MetaStream(ExtremeStream(cfg.data_config(32)),
                           cfg.class_maps()[0], cuda_device)
    batches = [stream.batch(i) for i in range(6)]
    runs = []
    for backend in ("tiled", "xla"):
        before = cs_adam_tiled.launches
        init_fn, step_fn, opts = tx.make_extreme_step(
            cfg, optimizer=optimizer, lr=1e-2, device=cuda_device,
            plan=plan.with_backend(backend))
        params = init_fn(torch.Generator(device=cuda_device).manual_seed(0))
        state = {p: o.init() for p, o in opts.items()}
        losses = []
        for b in batches:
            params, state, m = step_fn(params, state, b)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        assert (cs_adam_tiled.launches - before > 0) == (backend == "tiled")
        runs.append((params, state, torch.stack(losses)))
    (pa, sa, la), (pb, sb, lb) = runs
    assert torch.equal(la, lb)
    for top in pa:
        assert torch.equal(pa[top]["table"], pb[top]["table"])
    for path in sa:
        for k in ("m", "v"):
            assert (sa[path][k] is None) == (sb[path][k] is None)
            if sa[path][k] is not None:
                assert torch.equal(sa[path][k], sb[path][k])


def test_async_save_and_restore_on_the_card(cuda_device, tmp_path):
    """An async save of CUDA tensors (f32, bf16, int8 sketch, rank-1
    factors, the host step), then an in-place write: the restored tensors
    are the pre-write ones to the bit, on the card."""
    from repro_torch.checkpoint import store
    from repro_torch.core.stores import Rank1Moment
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    tree = {"t": torch.randn((4096, 64), generator=gen, device=cuda_device),
            "h": torch.randn((3, 512, 8), generator=gen, device=cuda_device
                             ).to(torch.bfloat16),
            "q": QuantState(torch.randint(-127, 128, (3, 256, 8),
                                          generator=gen, device=cuda_device,
                                          dtype=torch.int8),
                            torch.rand((3, 1), generator=gen,
                                       device=cuda_device)),
            "r": Rank1Moment(torch.rand(4096, generator=gen,
                                        device=cuda_device),
                             torch.rand(64, generator=gen,
                                        device=cuda_device)),
            "step": torch.tensor(11, dtype=torch.int32), "none": None}
    want = {k: (v if v is None or k == "step" else
                type(v)(*(x.clone() for x in v)) if isinstance(v, tuple)
                else v.clone()) for k, v in tree.items()}
    writer = store.save(tmp_path, 11, tree, async_=True)
    tree["t"].add_(1.0)
    tree["h"].mul_(2.0)
    tree["q"].cells.zero_()
    tree["r"].r.add_(1.0)
    writer.join(60)
    assert not writer.is_alive()
    _, back = store.restore(tmp_path, tree, device=cuda_device)
    assert back["t"].device.type == "cuda" and back["none"] is None
    assert back["step"].device.type == "cpu" and int(back["step"]) == 11
    for k in ("t", "h", "q", "r"):
        got = back[k] if isinstance(back[k], tuple) else (back[k],)
        exp = want[k] if isinstance(want[k], tuple) else (want[k],)
        for a, b in zip(got, exp):
            assert a.dtype == b.dtype and torch.equal(a, b), k


# ------------------------------------------------------------- serving
def _serve_requests(n, k, n_rows, d, seed):
    from repro_torch.serve import AdaptRequest
    rng = np.random.RandomState(seed)
    return [AdaptRequest(user=i, ids=rng.randint(0, n_rows, k).astype(
                np.int32),
                grad_rows=(rng.randn(k, d) * 0.1).astype(np.float32),
                t_arrival=i * 1e-4) for i in range(n)]


def test_coalesced_batch_on_tiled_equals_raw_concat(cuda_device):
    """One coalesced batch (padding: the first id, zero rows) through the
    ``tiled`` adapt step (B1) equals the raw concatenation to the bit;
    and both are held to plain versions: the ``xla`` step on the card
    (atol 2e-5) and the ``tiled`` step on a CPU copy (V to the bit, the
    table within atol 2e-5: torch's CPU sqrt)."""
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.serve import coalesce, make_online_adapt_step
    n_rows, d = 4096, 64

    def step(backend, device):
        return make_online_adapt_step(
            n_rows, d, lr=1e-2, b2=0.9, store_backend=backend,
            hparams=SketchHParams(backend="tiled"), device=device)

    init_fn, adapt_fn = step(None, cuda_device)
    table = torch.randn((n_rows, d), generator=torch.Generator(
        device=cuda_device).manual_seed(0), device=cuda_device)
    reqs = _serve_requests(20, 8, 64, d, seed=1)     # heavy duplicates
    raw_ids = torch.from_numpy(np.concatenate([r.ids for r in reqs])).to(
        cuda_device)
    raw_rows = torch.from_numpy(np.concatenate([r.grad_rows for r in reqs]
                                               )).to(cuda_device)
    before = cs_adam_tiled.launches
    t_ref, s_ref = adapt_fn(table.clone(), init_fn(), raw_ids, raw_rows)
    ids, rows = coalesce(reqs, 256, cuda_device)     # 160 live, 96 padding
    t_b, s_b = adapt_fn(table.clone(), init_fn(), ids, rows)
    assert cs_adam_tiled.launches == before + 2
    assert torch.equal(t_ref, t_b) and torch.equal(s_ref["v"], s_b["v"])
    x_init, x_adapt = step("xla", cuda_device)
    t_x, s_x = x_adapt(table.clone(), x_init(), ids, rows)
    assert cs_adam_tiled.launches == before + 2
    torch.testing.assert_close(t_b, t_x, rtol=0, atol=2e-5)
    torch.testing.assert_close(s_b["v"], s_x["v"], rtol=0, atol=2e-5)
    c_init, c_adapt = step(None, "cpu")
    t_c, s_c = c_adapt(table.cpu(), c_init(), ids.cpu(), rows.cpu())
    assert torch.equal(s_b["v"].cpu(), s_c["v"])
    torch.testing.assert_close(t_b.cpu(), t_c, rtol=0, atol=2e-5)


def test_double_buffer_publishes_behind_its_event(cuda_device):
    """The writer adapts a copy (copy-on-write): a held generation keeps
    its bits, and ``publish`` returns only once the staged writes are
    done (its event has completed)."""
    from repro_torch.serve import (DoubleBufferedStore, coalesce,
                                   make_online_adapt_step)
    n_rows, d = 4096, 64
    init_fn, adapt_fn = make_online_adapt_step(n_rows, d, lr=1e-2,
                                               device=cuda_device)
    table0 = torch.randn((n_rows, d), device=cuda_device)
    store = DoubleBufferedStore(table0.clone(), init_fn())
    held = store.read()
    frozen = (held.table.clone(), held.opt_state["v"].clone())
    for seed in range(3):
        ids, rows = coalesce(_serve_requests(8, 8, n_rows, d, seed), 64,
                             cuda_device)
        t, s = store.begin_adapt()
        store.stage(*adapt_fn(t, s, ids, rows))
        snap = store.publish()
        # nothing was queued after the staged writes: once publish has
        # waited on its event, the stream is idle
        assert torch.cuda.current_stream().query()
        assert snap.version == seed + 1
    assert torch.equal(held.table, frozen[0])
    assert torch.equal(held.opt_state["v"], frozen[1])
    assert not torch.equal(store.read().table, table0)


def test_table_monitor_collect_dispatches_without_sync(cuda_device):
    """After one warm boundary (hash parameters and the probe ids copied
    to the card, the pinned buffer made), a boundary's collect and the
    steps between boundaries run under sync-debug mode "error"."""
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.obs import (TableMonitor, TableProbe,
                                 predicted_table_errors)
    from repro_torch.train.steps import sparse_embedding_stores
    n_rows, d = 8192, 64
    init_fn, step_fn, opt = make_sparse_embedding_step(
        n_rows, d, lr=1e-3, hparams=SketchHParams(), device=cuda_device)
    table = init_fn(torch.Generator(device=cuda_device).manual_seed(0))
    state = opt.init()
    m_store, v_store = sparse_embedding_stores(n_rows, d,
                                               hparams=SketchHParams())
    probe = TableProbe.for_table("emb", n_rows, k=16)
    mon = TableMonitor("emb", m_store=m_store, v_store=v_store, probe=probe,
                       predicted=predicted_table_errors(m_store, v_store,
                                                        n_rows))
    pstate = probe.init(d, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)

    def step():
        nonlocal table, state
        ids = torch.randint(0, n_rows, (512,), generator=gen,
                            device=cuda_device, dtype=torch.int32)
        rows = torch.randn((512, d), generator=gen, device=cuda_device)
        table, state = step_fn(table, state, ids, rows)
        probe.update(pstate, ids, rows)
        return {"m": state["m"], "v": state["v"], "probe": pstate}

    assert mon.collect(step(), 1) is None          # warm boundary
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(2, 5):
            st = step()
        rec = mon.collect(st, 4)                    # flushes boundary 1
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert rec["step"] == 1 and "v_occupancy" in rec
    last = mon.flush()
    assert last["step"] == 4 and last["probe_rows_seen"] > 0
    assert "v_meas_error" in last and "v_error_ratio" in last


# ------------------------------------------------------------- LM stack
def _lm(dev, optimizer="cs_adam", backend="auto", arch="qwen2_0_5b",
        **over):
    from repro_torch import configs
    from repro_torch.train.steps import make_train_step
    cfg = configs.get(arch).reduced(vocab_size=2048, **over)
    return cfg, make_train_step(cfg, optimizer=optimizer,
                                kernel_backend=backend, device=dev)


def _lm_batches(cfg, n=3, b=4, s=32):
    """Zipf tokens; for the enc-dec and the VLM also their stub frontend's
    normal ``frames`` or ``patches``."""
    from repro_torch.train.steps import stub_input
    rng = np.random.RandomState(0)
    stub = stub_input(cfg)
    out = []
    for _ in range(n):
        tok = ((rng.zipf(1.1, (b, s)) - 1) % cfg.vocab).astype(np.int32)
        out.append({"tokens": tok, "labels": np.roll(tok, -1, axis=1)})
        if stub is not None:
            out[-1][stub[0]] = rng.standard_normal(
                (b, stub[1], cfg.d_model)).astype(np.float32)
    return out


def _lm_run(ts, params, batches, dev):
    from repro_torch.core.partition import leaf_paths
    params = _lm_clone(params)
    state = ts.optimizer.init(params)
    losses = []
    for b in batches:
        params, state, m = ts.step_fn(params, state, {
            k: torch.from_numpy(v).to(dev) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, dict(leaf_paths(params)), dict(leaf_paths(state))


def _lm_clone(tree):
    if isinstance(tree, dict):
        return {k: _lm_clone(v) for k, v in tree.items()}
    return tree.clone()


def test_lm_gather_backward_is_deterministic(cuda_device):
    table = torch.randn((2048, 64), device=cuda_device)
    rng = np.random.RandomState(1)
    tok = torch.from_numpy(((rng.zipf(1.1, 8192) - 1) % 2048)
                           .astype(np.int64)).to(cuda_device)
    up = torch.randn((8192, 64), device=cuda_device,
                     dtype=torch.bfloat16)
    grads = []
    for _ in range(2):
        t = table.detach().requires_grad_()
        (t.to(torch.bfloat16)[tok] * up).float().sum().backward()
        grads.append(t.grad)
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "whisper_medium",
                                  "internvl2_2b"])
def test_lm_step_auto_equals_xla_and_itself(cuda_device, arch):
    """The LM step of the dense transformer, the enc-dec and the VLM at
    ``reduced()`` (vocab 2,048: both tables sketched): B3 4 a step, equal
    to ``xla`` and to itself to the bit."""
    from repro_torch.kernels.cs_ema_tiled import cs_ema_tiled as b3
    cfg, ts = _lm(cuda_device, arch=arch)
    params = ts.init_fn(torch.Generator(device=cuda_device).manual_seed(0))
    batches = _lm_batches(cfg)
    n0 = b3.launches
    a = _lm_run(ts, params, batches, cuda_device)
    assert b3.launches - n0 == 4 * len(batches)
    b = _lm_run(ts, params, batches, cuda_device)
    x = _lm_run(_lm(cuda_device, backend="xla", arch=arch)[1], params,
                batches, cuda_device)
    for other in (b, x):
        assert other[0] == a[0]
        for i in (1, 2):
            assert all(torch.equal(other[i][p], a[i][p]) for p in a[i]
                       if isinstance(a[i][p], torch.Tensor))


def test_lm_step_on_the_card_follows_a_cpu_copy(cuda_device):
    cfg, ts = _lm(cuda_device)
    params = ts.init_fn(torch.Generator(device=cuda_device).manual_seed(0))
    batches = _lm_batches(cfg)
    got = _lm_run(ts, params, batches, cuda_device)
    cpu = torch.device("cpu")
    want = _lm_run(_lm(cpu, backend="xla")[1], _lm_to(params, cpu), batches,
                   cpu)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    for p, t in want[2].items():
        if isinstance(t, torch.Tensor) and t.dim():
            torch.testing.assert_close(got[2][p].cpu(), t, rtol=1e-4,
                                       atol=1e-5, msg=p)


def _lm_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _lm_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def test_flash_attention_on_the_card_matches_cpu(cuda_device):
    from repro_torch.models import attention as A
    gen = torch.Generator().manual_seed(2)
    q = torch.randn((2, 64, 8, 16), generator=gen)
    k = torch.randn((2, 64, 2, 16), generator=gen)
    v = torch.randn((2, 64, 2, 16), generator=gen)
    outs, grads = [], []
    for dev in (torch.device("cpu"), cuda_device):
        xs = [t.to(dev).requires_grad_() for t in (q.clone(), k.clone(),
                                                 v.clone())]
        o = A.flash_attention(*xs, True, 16, 0)
        torch.sum(torch.square(o)).backward()
        outs.append(o.detach().cpu())
        grads.append([t.grad.cpu() for t in xs])
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=1e-4)
    for a, b in zip(grads[1], grads[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3)


def test_decode_matches_prefill_on_the_card(cuda_device):
    from repro_torch import configs
    from repro_torch.serve import make_serve_step
    cfg = configs.get("qwen2_0_5b").reduced()
    ss = make_serve_step(cfg, batch=2, max_seq=24)
    from repro_torch.models import transformer as T
    params = T.init(torch.Generator(device=cuda_device).manual_seed(0), cfg)
    tok = torch.randint(1, cfg.vocab, (2, 12), device=cuda_device,
                        dtype=torch.int32)
    logits, cache = ss.prefill_fn(params, {"tokens": tok})
    assert cache["k"].device.type == "cuda"
    seq = tok
    for _ in range(4):
        nxt = logits.argmax(-1).to(torch.int32)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
        logits, cache = ss.decode_fn(params, cache, nxt)
        want, _ = ss.prefill_fn(params, {"tokens": seq})
        torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ sharded slabs
@pytest.mark.parametrize("layout", ["width", "hash"])
@pytest.mark.parametrize("signed", [True, False])
def test_slab_scatter_equals_plain_and_cpu(cuda_device, layout, signed):
    """B5 in slab mode (``cs_update_slab``): bit-equal to its plain version
    on a collision-free batch, within atol 2e-5 of it under collisions and
    bit-equal to a CPU copy there; the shards' slabs concatenate to the
    full-width B5 update to the bit."""
    from repro_torch.kernels.cs_update import cs_update_slab
    dev = cuda_device
    spec = cs.SketchSpec(depth=3, width=4096, dim=96, signed=signed,
                         seed=5, shards=4, layout=layout)
    gen = torch.Generator(device=dev).manual_seed(3)
    for ids in (torch.randperm(4096, generator=gen, device=dev)[:64],
                torch.randint(0, 300, (2048,), generator=gen, device=dev)):
        ids = ids.to(torch.int32)
        rows = torch.randn((ids.numel(), spec.dim), generator=gen,
                           device=dev)
        signs = spec.family.sign(ids) if signed else None
        full = cs.update(spec, cs.init(spec, dev), ids, rows)
        slabs = []
        for s in range(spec.shards):
            local, _ = cs._slab_buckets(spec, ids, s)
            start = torch.randn(spec.slab_shape, generator=gen, device=dev)
            got = cs_update_slab(start.clone(), local, signs, rows)
            want = ref.cs_update_slab_ref(start.clone(), local, signs, rows)
            host = ref.cs_update_slab_ref(start.cpu(), local.cpu(),
                                          None if signs is None
                                          else signs.cpu(), rows.cpu())
            assert torch.equal(got.cpu(), host)
            assert float((got - want).abs().max()) <= 2e-5
            if ids.numel() == 64:
                assert torch.equal(got, want)
            slabs.append(cs.update_slab(spec, cs.init_slab(spec, dev), ids,
                                        rows, s))
        assert torch.equal(torch.cat(slabs, dim=1), full)


def test_sharded_step_on_the_card_equals_dp_step(cuda_device):
    """The 2 x 2 sharded step (``ReplicaMesh`` threads on the card) equals
    the DP step at dp 2 to the bit over 3 dyadic steps, and a CPU copy."""
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.core.stores import StoreTree
    from repro_torch.distributed import (ReplicaGroup, ReplicaMesh,
                                         join_slabs, shard_state)
    from repro_torch.train.steps import sparse_embedding_stores
    n, d, k = 4096, 64, 512
    hp = SketchHParams(compression=4.0, width_multiple=64)
    kw = dict(lr=1e-2, b1=0.5, b2=0.5, hparams=hp)
    gen = torch.Generator().manual_seed(1)
    batches = [(torch.randint(0, n // 4, (k,), generator=gen,
                              dtype=torch.int32),
                torch.randint(-3, 4, (k, d), generator=gen).float())
               for _ in range(3)]
    table0 = torch.randn((n, d), generator=gen)

    def sharded(dev):
        mesh = ReplicaMesh((2, 2), timeout=120.0)
        _, step, opt = make_sparse_embedding_step(
            n, d, sketch_shards=2, dp_axis=mesh.axis("data"),
            shard_axis=mesh.axis("model"), error_feedback=True,
            device=dev, **kw)
        full = opt.init()
        tabs = [table0.clone().to(dev) for _ in range(4)]
        sts = [shard_state(full, 2, r % 2) for r in range(4)]
        for ids, rows in batches:
            outs = mesh.run(step, [
                (tabs[r], sts[r], ids[(r // 2) * (k // 2):][:k // 2].to(dev),
                 rows[(r // 2) * (k // 2):][:k // 2].to(dev))
                for r in range(4)])
            tabs, sts = [o[0] for o in outs], [o[1] for o in outs]
        return tabs[0].cpu(), {key: v.cpu() for key, v in
                               join_slabs(sts[:2]).items()
                               if isinstance(v, torch.Tensor)}

    def dp(dev):
        m_st, v_st = sparse_embedding_stores(n, d, hparams=hp,
                                             sketch_shards=2)
        group = ReplicaGroup(2, timeout=120.0)
        _, step, opt = make_sparse_embedding_step(
            n, d, stores=StoreTree(rules=(("sparse_embedding", m_st,
                                           v_st),)),
            dp_axis=group, error_feedback=True, device=dev, **kw)
        tabs = [table0.clone().to(dev) for _ in range(2)]
        sts = [opt.init() for _ in range(2)]
        for ids, rows in batches:
            outs = group.run(step, [
                (tabs[r], sts[r], ids[r * (k // 2):][:k // 2].to(dev),
                 rows[r * (k // 2):][:k // 2].to(dev)) for r in range(2)])
            tabs, sts = [o[0] for o in outs], [o[1] for o in outs]
        return tabs[0].cpu(), {key: v.cpu() for key, v in sts[0].items()
                               if isinstance(v, torch.Tensor)}

    got, want, host = sharded(cuda_device), dp(cuda_device), sharded("cpu")
    for other in (want, host):
        assert torch.equal(got[0], other[0])
        for key in ("m", "v", "residual"):
            assert torch.equal(got[1][key], other[1][key]), key
