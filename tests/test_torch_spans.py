"""The profiler spans inside the port's two training steps.

The sparse step (``make_sparse_embedding_step``) runs its stages in
``obs.dedup``, ``obs.hash``, ``obs.adam_rows`` (``kernels/ops.py``) and
``obs.apply``; the LM step (``make_train_step``) its loss in
``obs.forward`` and its gradient in ``obs.backward``, both inside
``obs.grad``, then ``obs.clip``, ``obs.kernel`` and ``obs.apply``.  One
step is profiled on the CPU: each span appears once, the spans of one
level do not overlap, and together they hold every operator the step
runs except the ones named here: host scalar bookkeeping (the step
counters and their read on the host), views, and in the sparse step the
learning rate's scale of the direction (``transforms.scale_by_lr``),
which the benchmark's ``unspanned_ms.sparse`` reads.  A step under the
profiler gives the same bits as one without it."""
from __future__ import annotations

import copy

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.core.optimizers import SketchHParams
from repro_torch.core.partition import leaf_paths
from repro_torch.train.steps import (make_sparse_embedding_step,
                                     make_train_step)

N, D, K = 512, 16, 64
SPARSE_SPANS = {"xla": ["obs.dedup", "obs.hash", "obs.adam_rows",
                        "obs.apply"],
                "tiled": ["obs.dedup", "obs.hash", "obs.adam_rows",
                          "obs.apply"],
                "ref": ["obs.hash", "obs.adam_rows", "obs.apply"],
                "stream": ["obs.hash", "obs.adam_rows", "obs.apply"]}
# the LM step's aliases of its params, views that launch nothing
VIEWS = {"aten::detach"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sparse(backend, cells="float32"):
    hp = SketchHParams(compression=5.0, depth=3, width_multiple=64, seed=1,
                       backend=backend, dtype=cells)
    init, step_fn, opt = make_sparse_embedding_step(N, D, lr=1e-2,
                                                    hparams=hp, device="cpu")
    table = init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batches = [(torch.randint(0, N, (K,), generator=g, dtype=torch.int32),
                torch.randn(K, D, generator=g)) for _ in range(3)]
    return step_fn, table, opt.init(), batches


def _lm(arch):
    cfg = configs.get(arch).reduced(compute_dtype="float32")
    ts = make_train_step(cfg, optimizer="cs_adam", lr=1e-3, device="cpu")
    params = ts.init_fn(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(1, cfg.vocab_size, (2, 33), generator=g)
    batch = {"tokens": tok[:, :-1].contiguous(),
             "labels": tok[:, 1:].contiguous()}
    return ts, params, ts.optimizer.init(params), batch


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        out = fn()
    return out, prof.events()


def _spans(events):
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in events if e.name.startswith("obs.")]


def _outside(events, spans):
    """``(name, input shapes)`` of the outermost ``aten::`` operators
    that no span holds."""
    out = []
    for e in events:
        if not e.name.startswith("aten::") or e.name in VIEWS:
            continue
        if e.cpu_parent is not None and e.cpu_parent.name.startswith(
                "aten::"):
            continue
        t = e.time_range.start
        if not any(a <= t <= b for _n, a, b in spans):
            out.append((e.name, [list(s) for s in e.input_shapes]))
    return out


def _scalar(shapes) -> bool:
    return all(s == [] for s in shapes)


def _disjoint(spans) -> bool:
    iv = sorted((a, b) for _n, a, b in spans)
    return all(b0 <= a1 for (_a0, b0), (a1, _b1) in zip(iv, iv[1:]))


def _leaves(tree):
    return [x for _p, x in leaf_paths(tree) if isinstance(x, torch.Tensor)]


@pytest.mark.parametrize("backend", sorted(SPARSE_SPANS))
def test_sparse_step_stages_are_spans(backend):
    step_fn, table, state, batches = _sparse(backend)
    table, state = step_fn(table, state, *batches[0])
    (table, state), events = _profiled(
        lambda: step_fn(table, state, *batches[1]))
    spans = _spans(events)
    assert [n for n, _a, _b in spans] == SPARSE_SPANS[backend]
    assert _disjoint(spans)
    rest = _outside(events, spans)
    # the step counters (+1) and the host's read of the step, on 0-d
    # host tensors; the learning rate's scale of the (k, d) direction
    assert all(_scalar(s) for n, s in rest if n != "aten::mul"), rest
    assert [s for n, s in rest if n == "aten::mul"] == [[[K, D], []]]


def test_sparse_spans_once_a_step():
    step_fn, table, state, batches = _sparse("xla")

    def two():
        t, s = table, state
        for ids, rows in batches[:2]:
            t, s = step_fn(t, s, ids, rows)
        return t, s
    _out, events = _profiled(two)
    names = [n for n, _a, _b in _spans(events)]
    assert names == SPARSE_SPANS["xla"] * 2


def test_lowp_cells_take_the_xla_spans():
    step_fn, table, state, batches = _sparse("tiled", cells="bfloat16")
    table, state = step_fn(table, state, *batches[0])
    _out, events = _profiled(lambda: step_fn(table, state, *batches[1]))
    spans = _spans(events)
    assert [n for n, _a, _b in spans] == SPARSE_SPANS["xla"]
    assert _disjoint(spans)


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "rwkv6_7b"])
def test_lm_step_stages_are_spans(arch):
    ts, params, state, batch = _lm(arch)
    params, state, _m = ts.step_fn(params, state, batch)
    _out, events = _profiled(lambda: ts.step_fn(params, state, batch))
    spans = _spans(events)
    attn = [s for s in spans if s[0] == "obs.attn"]
    spans = [s for s in spans if s[0] != "obs.attn"]
    names = [n for n, _a, _b in spans]
    assert names == ["obs.grad", "obs.forward", "obs.backward", "obs.clip",
                     "obs.kernel", "obs.apply"]
    by = {n: (a, b) for n, a, b in spans}
    g0, g1 = by["obs.grad"]
    for inner in ("obs.forward", "obs.backward"):
        assert g0 <= by[inner][0] and by[inner][1] <= g1
    top = [s for s in spans if s[0] not in ("obs.forward", "obs.backward")]
    assert _disjoint(top)
    assert _disjoint([s for s in spans if s[0] in ("obs.forward",
                                                   "obs.backward")])
    # attention's forward, its recompute under remat and its backward,
    # a layer each, inside the forward's and the backward's spans
    cfg = configs.get(arch).reduced()
    n_attn = cfg.n_layers if cfg.family == "gqa" else 0
    assert len(attn) == 3 * n_attn
    assert all(any(by[o][0] <= a and b <= by[o][1]
                   for o in ("obs.forward", "obs.backward"))
               for _n, a, b in attn)
    rest = _outside(events, spans)
    # the loss's cast to f32 for the metrics, a 0-d tensor
    assert all(_scalar(s) for _n, s in rest), rest


@pytest.mark.parametrize("backend", ["xla", "tiled"])
def test_sparse_step_bits_with_and_without_the_profiler(backend):
    step_fn, table, state, batches = _sparse(backend)
    t0, s0 = table.clone(), copy.deepcopy(state)
    for ids, rows in batches:
        t0, s0 = step_fn(t0, s0, ids, rows)
    t1, s1 = table.clone(), copy.deepcopy(state)
    for ids, rows in batches:
        (t1, s1), _ev = _profiled(lambda: step_fn(t1, s1, ids, rows))
    assert torch.equal(t0, t1)
    for a, b in zip(_leaves(s0), _leaves(s1), strict=True):
        assert torch.equal(a, b)


def test_lm_step_bits_with_and_without_the_profiler():
    ts, params, state, batch = _lm("qwen2_0_5b")
    p0, s0 = copy.deepcopy(params), copy.deepcopy(state)
    p1, s1 = copy.deepcopy(params), copy.deepcopy(state)
    for _ in range(2):
        p0, s0, m0 = ts.step_fn(p0, s0, batch)
        (p1, s1, m1), _ev = _profiled(lambda: ts.step_fn(p1, s1, batch))
        for k in ("loss", "grad_norm"):
            assert torch.equal(m0[k], m1[k])
    for a, b in zip(_leaves(p0) + _leaves(s0), _leaves(p1) + _leaves(s1),
                    strict=True):
        assert torch.equal(a, b)
