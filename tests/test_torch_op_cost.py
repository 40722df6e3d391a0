"""``repro_torch.launch.op_cost``: the counterparts of
``tests/test_hlo_cost.py``.

An eager step is counted as it executes, so a loop's FLOPs are its
body's times its trips, nested loops multiply, and
``torch.utils.checkpoint``'s recompute counts when it runs; each program
is also compiled as JAX and held to ``hlo_cost.analyze``, which must
recover the same counts from the HLO.  Bytes are each op's operands and
result; the stand-in axis records the reference's ring-model bytes for
the same collectives as ``parse_collectives``/``hlo_cost`` read from
HLO text.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.launch import analysis as ref_analysis
from repro.launch import hlo_cost
from repro_torch.launch.op_cost import OpCost, StandInAxis, _tensor_bytes

X, W = (128, 256), (8, 256, 256)
LAYER = 2 * 128 * 256 * 256


def _meta(shape, grad=False):
    return torch.empty(shape, device="meta").requires_grad_(grad)


def _hlo_flops(fn, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return hlo_cost.analyze(jax.jit(fn).lower(*args).compile().as_text(),
                            1).flops


def test_loop_counts_every_trip():
    x, ws = _meta(X), _meta(W)
    with OpCost() as c:
        for w in ws:
            x = torch.tanh(x @ w)
    assert c.flops == 8 * LAYER

    def scanned(x, ws):
        return jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), x, ws)[0]
    assert _hlo_flops(scanned, X, W) == c.flops


def test_nested_loop_flops():
    x, ws = _meta(X), _meta(W)
    with OpCost() as c:
        for w in ws:
            for _ in range(3):
                x = torch.tanh(x @ w)
    assert c.flops == 8 * 3 * LAYER

    def nested(x, ws):
        def inner(x, w):
            return jax.lax.scan(lambda c, _: (jnp.tanh(c @ w), None), x,
                                None, length=3)[0], None
        return jax.lax.scan(inner, x, ws)[0]
    assert _hlo_flops(nested, X, W) == c.flops


def test_grad_with_checkpoint_counts_recompute():
    """Forward, the recompute and two backward products a layer: 4x the
    forward (the input needs its gradient too, as every layer's does in
    the reference's scan)."""
    x, ws = _meta(X, grad=True), _meta(W, grad=True)
    with OpCost() as c:
        h = x
        for i in range(8):
            h = checkpoint(lambda c_, w: torch.tanh(c_ @ w), h, ws[i],
                           use_reentrant=False)
        torch.autograd.grad(h.sum(), [x, ws])
    assert c.flops == 4 * 8 * LAYER

    def loss(ws, x):
        body = jax.checkpoint(lambda c_, w: (jnp.tanh(c_ @ w), None))
        return jnp.sum(jax.lax.scan(body, x, ws)[0])
    assert _hlo_flops(jax.grad(loss), W, X) == c.flops


def test_plain_matmul():
    a, b = _meta((64, 128)), _meta((128, 32))
    with OpCost() as c:
        a @ b
    assert c.flops == 2 * 64 * 128 * 32
    # read a (32 KiB) and b (16 KiB), write the product (8 KiB): exact,
    # where hlo_cost's fusion-level count lies in 40,000-200,000
    assert c.bytes == 4 * (64 * 128 + 128 * 32 + 64 * 32)
    assert 40_000 < c.bytes < 200_000
    assert _hlo_flops(lambda a, b: a @ b, (64, 128), (128, 32)) == c.flops


def test_tensor_bytes_tuple():
    assert _tensor_bytes((torch.empty(2, 4), torch.empty(8,
                         dtype=torch.bfloat16))) == 2 * 4 * 4 + 8 * 2
    assert _tensor_bytes(torch.empty(16, dtype=torch.bool)) == 16
    assert hlo_cost._shape_bytes("(f32[2,4]{1,0}, bf16[8])") == 48


def test_views_move_no_bytes():
    """Views and bare allocations count nothing; a reshape that must
    copy counts its read and its write."""
    x = _meta((64, 128))
    with OpCost() as c:
        x.view(128, 64).t().unsqueeze(0)
        torch.empty((1024,), device="meta")
    assert c.bytes == 0 and c.flops == 0
    with OpCost() as c:
        x.t().reshape(-1)
    assert c.bytes == 2 * 64 * 128 * 4


@pytest.mark.parametrize("g", [2, 8])
def test_stand_in_axis_ring_bytes_equal_reference(g):
    """An all-reduce (psum and pmean) and an all-gather of an f32
    (64, 128) through a stand-in axis of size g: the same count, bytes
    and link bytes as the reference reads from HLO with that group."""
    t = torch.empty((64, 128), device="meta")
    cost = OpCost()
    axis = StandInAxis(g, cost)
    with cost:
        out = axis.psum(t), axis.pmean(t), axis.all_gather(t)
    assert [tuple(o.shape) for o in out] == [(64, 128), (64, 128),
                                             (g, 64, 128)]
    groups = f"replica_groups=[{32 // g},{g}]<=[32]"
    hlo = f"""
HloModule test

ENTRY %main (p: f32[64,128]) -> f32[{g},64,128] {{
  %p = f32[64,128]{{1,0}} parameter(0)
  %all-reduce.1 = f32[64,128]{{1,0}} all-reduce(%p), channel_id=1, {groups}, use_global_device_ids=true, to_apply=%add
  %all-reduce.2 = f32[64,128]{{1,0}} all-reduce(%p), channel_id=2, {groups}, use_global_device_ids=true, to_apply=%add
  ROOT %all-gather.3 = f32[{g},64,128]{{2,1,0}} all-gather(%p), channel_id=3, {groups}, dimensions={{0}}, use_global_device_ids=true
}}
"""
    want = hlo_cost.analyze(hlo, 32).collectives
    parsed = ref_analysis.parse_collectives(hlo, 32)
    for kind in ("all-reduce", "all-gather"):
        got = cost.collectives[kind]
        assert got["count"] == want[kind]["count"] == parsed[kind]["count"]
        assert got["bytes"] == want[kind]["bytes"] == parsed[kind]["bytes"]
        assert got["link_bytes"] == pytest.approx(want[kind]["link_bytes"],
                                                  rel=1e-12)
        assert got["link_bytes"] == pytest.approx(
            parsed[kind]["link_bytes"], rel=1e-12)


def test_breakdown_rows_and_the_device_step():
    """``breakdown``'s rows add up to the trace's counts and name their
    sources; the step it runs on a card, here built on the CPU, counts
    the meta trace's FLOPs (train and decode)."""
    from repro_torch import configs
    from repro_torch.launch import breakdown, dryrun
    cfg = configs.get("qwen2_0_5b").reduced(vocab_size=2048)
    for shape in (configs.ShapeConfig("t", "train", 32, 2),
                  configs.ShapeConfig("d", "decode", 64, 2)):
        meta = dryrun.trace_cell(cfg, shape, sources=True)[0]
        rows = breakdown.collect_rows(meta)
        assert sum(r[0] for r in rows["flops"]) == meta.flops > 0
        assert sum(r[0] for r in rows["bytes"]) == meta.bytes
        assert any("models/attention.py" in r[4] for r in rows["flops"])
        step, run_shape = breakdown.device_step(
            cfg, shape, 2, None, torch.device("cpu"), optimizer="cs_adam",
            store_backend="")
        assert run_shape == shape
        with OpCost() as card:
            step()
        assert card.flops == meta.flops


def test_grid_records_the_gradient_all_reduce():
    """On a 2 x 1 grid a train step all-reduces every gradient leaf and
    the loss over the stand-in 'data' axis, under the ring model."""
    from repro_torch import configs
    from repro_torch.core.partition import leaf_paths
    from repro_torch.launch import dryrun
    cfg = configs.get("qwen2_0_5b").reduced(vocab_size=2048)
    cost, ps, *_ = dryrun.trace_cell(
        cfg, configs.ShapeConfig("t", "train", 32, 2), "2x1")
    leaves = [x for _p, x in leaf_paths(ps)]
    ar = cost.collectives["all-reduce"]
    assert ar["count"] == len(leaves) + 1
    nbytes = sum(x.nbytes for x in leaves) + 4
    assert ar["bytes"] == nbytes
    assert ar["link_bytes"] == pytest.approx(2 * nbytes * (2 - 1) / 2)
