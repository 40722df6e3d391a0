"""The ``granite-4.0-h-small.lm_train_8k`` cell's own pieces on the CPU:
``arith_hybrid_moe``'s FLOPs against counts worked out by hand, the four
readers of the new spans and counter on a hand-written trace, and the
``lm_train_hybrid_moe`` kind at a tiny size (its own tiny GraniteMoeHybrid
configuration: one period of 10 layers, 4 experts held of 8, top-2,
float32 products): a sound run is correct, a traced run reports what a
CPU can count and its counts hold the held experts' rows, and the broken
step, the half batch and the float8 control come out not correct under
the cell's committed limits."""
from __future__ import annotations

import copy
import json
import time

import pytest
import torch

from harness_tiny import manifest
from harness import arith, arith_hybrid_moe as am
from harness.runner import run_cell
from harness.trace import Trace

CELL = "granite-4.0-h-small.lm_train_8k"
TINY = dict(n_layers=10, d_model=64, n_heads=4, n_kv=2, head_dim=16,
            d_ff=32, vocab_size=2048, n_experts=8, experts_held=4,
            expert_rank=1, top_k=2, shared_d_ff=48, ssm_state=16,
            ssm_head_dim=16, rwkv_chunk=16, attn_chunk=16, loss_chunk=32,
            attention_multiplier=1 / 16, compute_dtype="float32")


def _tiny_spec():
    spec = manifest.cell(CELL)
    spec.config = json.loads(json.dumps(spec.config))
    spec.config["arch"].update(TINY)
    spec.traffic = dict(spec.traffic, batch=2, seq_len=64, pool=4)
    return spec


# ---------------------------------------------------------------- FLOPs
def test_flops_of_a_tiny_config_by_hand():
    c = dict(TINY, layer_types=["mamba"] * 5 + ["attention"] + ["mamba"] * 4,
             ssm_expand=2)
    # Mamba2: d·(2·di + 2·n + h) + di·d, di 128, n 16, h 8
    assert am.mamba_params(c) == 64 * (256 + 32 + 8) + 128 * 64
    assert am.attention_params(c) == 64 * 64 + 2 * 64 * 32 + 64 * 64
    # router 64·8, shared 3·64·48, the held experts' share 2·4/8 of
    # 3·64·32
    assert am.moe_active_params(c) == 512 + 9216 + 6144
    n = 9 * 27136 + 12288 + 10 * 15872 + 2048 * 64
    assert am.active_params(c) == n
    ssd = 3 * (2 * 16 * 16 + 2 * 16 * 8 * 16 + 4 * 8 * 16 * 16)
    assert am.ssd_flops_per_token(c) == ssd
    assert am.lm_flops_per_token(c, 64) == 6 * n + 12 * 4 * 16 * 64 + 9 * ssd
    assert am.expert_flops_per_row(c) == 6 * 64 * 32


def test_flops_of_the_cell():
    a = manifest.cell(CELL).config["arch"]
    assert am.active_params(a) == 1_682_767_872
    assert am.mixer_flops_per_token(a, 8192) == 402_653_184 + 228_261_888
    assert am.lm_flops_per_token(a, 8192) == 10_727_522_304


def test_projection_counts_match_the_port_on_meta():
    from harness.kinds.lm_train import arch_config
    from repro_torch.models import granite
    from repro_torch.core.partition import leaf_paths
    a = manifest.cell(CELL).config["arch"]
    p = dict(leaf_paths(granite.init(None, arch_config({"arch": a}),
                                     device="meta")))
    proj = sum(p[f"layers/mamba/{k}"].numel() for k in
               ("z_proj", "x_proj", "bc_proj", "dt_proj", "out_proj"))
    assert proj == 9 * am.mamba_params(a)
    assert sum(p[f"layers/attn/{k}"].numel() for k in
               ("wq", "wk", "wv", "wo")) == am.attention_params(a)
    assert p["layers/ffn/w_gate"].shape[1] == am.held(a) == 9


# -------------------------------------------------------------- readers
STEPS, PERIOD = 2, 1000.0


def _trace(spans=True):
    events, corr = [], [0]

    def span(name, a, b):
        for j in range(STEPS):
            events.append({"cat": "user_annotation", "ph": "X", "name": name,
                           "ts": j * PERIOD + a, "dur": b - a})

    def launch(t, dur):
        for j in range(STEPS):
            corr[0] += 1
            o = j * PERIOD
            events.append({"cat": "cuda_runtime", "ph": "X",
                           "name": "cudaLaunchKernel", "ts": o + t,
                           "dur": 1.0, "args": {"correlation": corr[0]}})
            events.append({"cat": "kernel", "ph": "X", "name": f"op{t}",
                           "ts": o + t + 0.5, "dur": dur,
                           "args": {"correlation": corr[0]}})

    span("obs.grad", 0.0, 900.0)
    span("obs.forward", 10.0, 300.0)
    if spans:
        span("obs.mamba", 20.0, 120.0)
        span("obs.ssd", 50.0, 90.0)
        span("obs.moe", 130.0, 250.0)
        span("obs.experts", 145.0, 170.0)
        span("obs.experts", 200.0, 220.0)
    launch(30.0, 20.0)      # a projection
    launch(60.0, 25.0)      # the SSD
    launch(140.0, 9.0)      # the dispatch, inside obs.moe only
    launch(150.0, 12.0)     # gate and up products
    launch(180.0, 4.0)      # the SwiGLU between them
    launch(210.0, 6.0)      # the down product
    launch(230.0, 5.0)      # the combine and shared expert
    launch(400.0, 100.0)    # the backward
    return Trace(events, STEPS, STEPS * PERIOD * 1e-6)


COUNTS = {"expert_rows": 1000, "expert_flops_per_row": 6 * 4096 * 768}


def _read(metric, trace, counts=COUNTS, unit="tokens"):
    return manifest.reader(metric)({"trace": trace, "unit": unit,
                                    "counts": counts})


@pytest.mark.parametrize("metric,want", [
    ("mamba_ms.lm", 0.045), ("ssd_ms.lm", 0.025), ("moe_ms.lm", 0.036)])
def test_span_readers(metric, want):
    tr = _trace()
    assert _read(metric, tr) == pytest.approx(want)
    assert _read(metric, tr, unit="rows") is None
    assert _read(metric, None) is None
    assert _read(metric, _trace(spans=False)) is None


def test_experts_roofline_reads_the_counter_over_the_span():
    tr = _trace()
    secs = (12.0 + 6.0) * STEPS * 1e-6
    want = 100.0 * 1000 * 6 * 4096 * 768 / arith.PEAK_BF16_FLOPS / secs
    assert _read("experts_roofline.lm", tr) == pytest.approx(want)
    assert _read("experts_roofline.lm", _trace(spans=False)) is None
    assert _read("experts_roofline.lm", tr, counts={}) is None
    assert _read("experts_roofline.lm", None) is None


def test_nested_spans_sit_inside_their_parents():
    tr = _trace()
    assert _read("ssd_ms.lm", tr) <= _read("mamba_ms.lm", tr)
    assert tr.span_device_s("obs.experts") * 1e3 / STEPS \
        <= _read("moe_ms.lm", tr)


# ------------------------------------------------------------ the kind
def _run(spec, trace=False):
    return run_cell(spec, 2**31 + 77, 0.2, trace, torch.device("cpu"),
                    time.perf_counter())


def test_sound_run_is_correct():
    res = _run(_tiny_spec())
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0


def test_traced_run_reports_what_a_cpu_can_count():
    res = _run(_tiny_spec(), trace=True)
    assert res["correct"], res["check"]
    assert set(res["metrics"]) == {"step_mfu.lm", "opt_state_gib"}


def test_counts_hold_the_traced_steps_expert_rows():
    from repro_torch.models import moe
    spec = _tiny_spec()
    cell = manifest.kind(spec.traffic).Cell(spec, 5, torch.device("cpu"))
    cell.build()
    counter = moe.expert_rows("cpu")
    for i in range(3):
        cell.step(i)
    before = int(counter)
    for i in (3, 4):
        cell.step(i)
    got = cell.counts([3, 4])
    assert got["expert_rows"] == int(counter) - before > 0
    assert got["expert_flops_per_row"] == 6 * 64 * 32
    s = spec.traffic["seq_len"]
    assert got["flops_per_step"] == am.lm_flops_per_token(
        spec.config["arch"], s) * 2 * s


@pytest.mark.parametrize("fault", ["frozen", "unapplied", "half"])
def test_broken_step_is_not_correct(fault, monkeypatch):
    """``frozen`` returns the state and the parameters unchanged;
    ``unapplied`` updates the moments but applies no update, which the
    moments' numbers cannot see; ``half`` leaves out half the batch."""
    from repro_torch.train import steps
    orig = steps.make_train_step

    def factory(*a, **k):
        ts = orig(*a, **k)
        step = ts.step_fn

        def broken(params, opt_state, batch):
            if fault == "frozen":
                _p, _s, metrics = step(copy.deepcopy(params),
                                       copy.deepcopy(opt_state), batch)
                return params, opt_state, metrics
            if fault == "unapplied":
                _p, state, metrics = step(copy.deepcopy(params),
                                          opt_state, batch)
                return params, state, metrics
            h = batch["tokens"].shape[0] // 2
            return step(params, opt_state,
                        {k: v[:h] for k, v in batch.items()})
        ts.step_fn = broken
        return ts
    monkeypatch.setattr(steps, "make_train_step", factory)
    assert not _run(_tiny_spec())["correct"]


def test_control_is_not_correct():
    import control
    from harness import check
    spec = _tiny_spec()
    got = control.readings(spec, 5, torch.device("cpu"))
    limits = manifest.limits_of(spec)
    assert check.verdict(got["sound"], limits)[0]
    assert not check.verdict(got["control"], limits)[0]
    assert not check.verdict(got["half"], limits)[0]
