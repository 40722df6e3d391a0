"""The plain references and the frozen copies against the port at small
sizes on the CPU."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from harness_tiny import tiny_spec
from harness import weights, zipf
from reference import common, gqa, rwkv6
from reference.hashing import Hash, leaf_seed, sketch_width
from reference.optim import Optimizer, SketchPair, cs_adam_rows


def test_frozen_hash_is_the_ports():
    from repro_torch.core.hashing import HashFamily
    from repro_torch.core.sketch import for_param
    from repro_torch.core.stores import leaf_seed as port_leaf_seed
    ids = torch.randint(0, 151936, (4096,), generator=torch.Generator()
                        .manual_seed(0))
    for path in ("sparse_embedding", "tok_embed/table", "lm_head/table"):
        seed = leaf_seed(path, 0)
        assert seed == port_leaf_seed(path, 0)
        for n in (151936, 65536, 2048):
            w = sketch_width(n)
            assert w == for_param((n, 8)).width
            fam, ours = HashFamily(seed=seed, depth=3, width=w), Hash(seed, 3, w)
            assert torch.equal(ours.bucket(ids % n),
                               fam.bucket(ids % n).long())
            assert torch.equal(ours.sign(ids % n), fam.sign(ids % n))


def test_frozen_stream_is_the_ports():
    from repro_torch.data.pipeline import ZipfLM, ZipfLMConfig
    ours = zipf.stream({"batch": 2, "seq_len": 64}, 4096, 2**31 + 7)
    port = ZipfLM(ZipfLMConfig(vocab_size=4096, seq_len=64, global_batch=2,
                               seed=2**31 + 7))
    for step in (0, 3):
        for k in ("tokens", "labels"):
            assert np.array_equal(ours.batch(step)[k], port.batch(step)[k])


def test_sparse_reference_is_the_ports_xla_step():
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.train.steps import make_sparse_embedding_step
    n, d, k = 1024, 16, 300
    g = torch.Generator().manual_seed(3)
    table = torch.randn((n, d), generator=g)
    ids = torch.randint(0, 64, (k,), generator=g)
    rows = torch.randn((k, d), generator=g)
    _i, step, opt = make_sparse_embedding_step(
        n, d, lr=1e-3, hparams=SketchHParams(), device="cpu")
    state, ours = opt.init(), table.clone()
    sk = SketchPair(n, d, path="sparse_embedding", compression=5.0, depth=3)
    for t in (1, 2):
        table, state = step(table, state, ids.to(torch.int32), rows)
        cs_adam_rows(ours, sk, ids, rows, t, lr=1e-3)
    torch.testing.assert_close(ours, table, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(sk.M, state["m"], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(sk.V, state["v"], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("cell,model", [("qwen2-0.5b.lm_train_b8", gqa),
                                        ("rwkv6-7b.lm_train", rwkv6)])
def test_model_references_are_the_ports_loss(cell, model):
    from repro_torch.train.steps import family_module
    from harness.kinds.lm_train import arch_config
    spec = tiny_spec(cell)
    cfg = arch_config(spec.config)
    shapes = {p: tuple(x.shape) for p, x in weights.flatten(
        family_module(cfg).init(None, cfg, device="meta")).items()}
    flat = weights.make_all(spec.config["init"], shapes, 5, "cpu")
    tokens = torch.randint(0, 2048, (2, 32), generator=torch.Generator()
                           .manual_seed(1))
    labels = torch.roll(tokens, -1, 1)
    ours = model.loss(spec.config["arch"], flat, tokens, labels)
    port = family_module(cfg).train_loss(
        cfg, weights.unflatten(flat), {"tokens": tokens, "labels": labels},
        remat=False)
    torch.testing.assert_close(ours, port, rtol=2e-6, atol=0.0)


def test_fp8_products_round_their_inputs():
    x = torch.randn(64, 32)
    w = torch.randn(32, 16)
    exact, low = common.matmul(x, w), common.fp8_matmul(x, w)
    rel = float((low - exact).norm() / exact.norm())
    assert 1e-3 < rel < 0.2


def test_reference_optimizer_is_the_ports_cs_adam():
    from repro_torch.core.optimizers import (SketchHParams, apply_updates,
                                             countsketch_adam)
    from repro_torch.core.partition import SketchPolicy
    g = torch.Generator().manual_seed(2)
    params = {"tok_embed": {"table": torch.randn((2048, 8), generator=g)},
              "w": torch.randn((8, 8), generator=g)}
    opt = countsketch_adam(1e-3, policy=SketchPolicy(min_rows=1024),
                           hparams=SketchHParams(backend="auto"))
    state = opt.init(params)
    flat = {k: v.clone() for k, v in weights.flatten(params).items()}
    ours = Optimizer(flat, lr=1e-3, sketched=["tok_embed/table"],
                     compression=5.0, depth=3)
    for _ in range(3):
        grads = {"tok_embed": {"table": torch.randn((2048, 8), generator=g)
                               * (torch.rand((2048, 1), generator=g) < 0.3)},
                 "w": torch.randn((8, 8), generator=g)}
        upd, state = opt.update(grads, state, params)
        params = apply_updates(params, upd)
        ours.step(flat, weights.flatten(grads))
    for k, v in weights.flatten(params).items():
        torch.testing.assert_close(flat[k], v, rtol=1e-5, atol=1e-7)
