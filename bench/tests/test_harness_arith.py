"""The yardstick's FLOP and byte arithmetic against counts worked out by
hand and against the port's own parameter trees."""
from __future__ import annotations

from harness_tiny import manifest
from harness import arith


def _arch(cell):
    return manifest.cell(cell).config["arch"]


def test_parameter_counts():
    assert arith.gqa_params(_arch("qwen2-0.5b.lm_train_b8")) == 494_032_768
    assert arith.rwkv6_params(_arch("rwkv6-7b.lm_train")) == 2_017_857_536


def test_parameter_counts_match_the_port_on_meta():
    from repro_torch.train import steps
    from harness.kinds.lm_train import arch_config
    for cell in ("qwen2-0.5b.lm_train_b8", "rwkv6-7b.lm_train"):
        spec = manifest.cell(cell)
        cfg = arch_config(spec.config)
        p = steps.family_module(cfg).init(None, cfg, device="meta")
        total = sum(x.numel() for _k, x in
                    steps.leaf_paths(p)) - p["tok_embed"]["table"].numel()
        assert total == arith.PARAMS[cfg.family](spec.config["arch"])


def test_flops_per_token():
    q = _arch("qwen2-0.5b.lm_train_b8")
    assert arith.mixer_flops_per_token(q, 2048) == 528_482_304
    assert arith.lm_flops_per_token(q, 2048) == 3_492_678_912
    r = _arch("rwkv6-7b.lm_train")
    assert arith.mixer_flops_per_token(r, 2048) == 12 * 8 * 64 * 64 * 64


def test_byte_bounds_at_the_phase_5_and_6_shapes():
    # PERF.md section 6: B1 at k 16,384, k_u 8,086, 16,816 touched rows a
    # moment; B3 on qwen2-0.5b's table with its (3, 10,240, 896) sketch
    assert arith.b1_bytes(896, 16384, 8086, 16816, 16816, 3) == 329_196_828
    assert arith.b3_bytes(151936, 896, 3, 10240, True) == 1_313_532_416
    assert arith.b3_bytes(151936, 896, 3, 10240, False) == \
        1_313_532_416 - 4 * 3 * 151936
    assert arith.b5_bytes(16384, 896, 8086, 1) == \
        4 * (16384 * 896 + 2 * 8086 * 896 + 2 * 16384)


def test_sparse_step_bytes():
    assert arith.sparse_step_bytes(8, 3, 2, 5, 5) == 4 * 8 + 4 * 2 * (9 + 20)


def test_configs_keep_the_published_widths():
    for cell, keys in (("qwen2-0.5b.lm_train_b8",
                        {"d_model": "hidden_size", "d_ff": "intermediate_size",
                         "n_heads": "num_attention_heads",
                         "n_kv": "num_key_value_heads",
                         "vocab_size": "vocab_size"}),
                       ("rwkv6-7b.lm_train",
                        {"d_model": "hidden_size", "d_ff": "intermediate_size",
                         "rwkv_head_dim": "head_size",
                         "vocab_size": "vocab_size"})):
        conf = manifest.cell(cell).config
        for ours, theirs in keys.items():
            assert conf["arch"][ours] == conf["published"][theirs]
    assert _arch("rwkv6-7b.lm_train")["n_layers"] == 8
    assert _arch("qwen2-0.5b.lm_train_b8")["n_layers"] == 24
