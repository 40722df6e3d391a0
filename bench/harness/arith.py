"""The yardstick's arithmetic: the chip's peaks, model FLOPs and the
bytes a step or a kernel needs.  Frozen here so that later changes to
the port cannot move it.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit.

Byte bounds count each input byte read once and each output byte
written once.  ``b1_bytes`` is ``chip_smoke.py::b1_bytes`` (line 1361),
``b5_bytes`` the B5 formula of ``chip_smoke.py`` phase 5 (line 1750) and
``b3_bytes`` the B3 formula of ``chip_smoke.py:1540-1541``, at commit
5fd53a1; ``b3_bytes`` reads signs only for a signed sketch, where the
original counted them for both moments.

Model FLOPs (``lm_flops_per_token``) are 6·N a token for N the
parameters other than the embedding table, whose gather is no product
(the vocabulary head counts), plus the sequence mixer: attention's
12·L·heads·head_dim·seq (PaLM, arXiv:2204.02311, appendix B) or RWKV6's
state products 12·L·heads·K·V (reading the state r·S and writing k·vᵀ,
2·K·V each, forward, and twice that backward).  Recomputation under
checkpoint is not counted.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989.4e12      # dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12       # HBM3 bandwidth


def gqa_params(c: dict) -> int:
    """Parameters of a GQA transformer (``family`` gqa) but the embedding
    table: per layer Q/K/V/O, their biases, the SwiGLU and two norms;
    the final norm and the vocabulary head."""
    d, hq, hkv, hd, f = (c["d_model"], c["n_heads"], c["n_kv"],
                         c["head_dim"], c["d_ff"])
    attn = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
    bias = (hq + 2 * hkv) * hd if c.get("qkv_bias") else 0
    layer = attn + bias + 3 * d * f + 2 * d
    return c["n_layers"] * layer + d + c["vocab_size"] * d


def rwkv6_params(c: dict) -> int:
    """Parameters of an RWKV6 model (``family`` rwkv6) but the embedding
    table: per layer the time mix (five d×d projections, the decay LoRA
    of rank max(32, d/64), u, five lerps, the base decay, the group
    norm), the channel mix (d×f, f×d, d×d, two lerps) and two norms; the
    final norm and the vocabulary head."""
    d, f, hd = c["d_model"], c["d_ff"], c["rwkv_head_dim"]
    lora = max(32, d // 64)
    tm = 5 * d * d + 2 * d * lora + (d // hd) * hd + 7 * d
    cm = 2 * d * f + d * d + 2 * d
    return c["n_layers"] * (tm + cm + 2 * d) + d + c["vocab_size"] * d


PARAMS = {"gqa": gqa_params, "rwkv6": rwkv6_params}


def mixer_flops_per_token(c: dict, seq: int) -> int:
    if c["family"] == "gqa":
        return 12 * c["n_layers"] * c["n_heads"] * c["head_dim"] * seq
    if c["family"] == "rwkv6":
        hd = c["rwkv_head_dim"]
        return 12 * c["n_layers"] * (c["d_model"] // hd) * hd * hd
    raise KeyError(c["family"])


def lm_flops_per_token(c: dict, seq: int) -> int:
    return 6 * PARAMS[c["family"]](c) + mixer_flops_per_token(c, seq)


def b1_bytes(d: int, k: int, k_u: int, rows_m: int, rows_v: int,
             depth: int, track_m: bool = True) -> int:
    """B1: the live gradient rows read, the output rows written, the
    touched M and V rows read and written, the live slots' addressing
    (M's buckets and signs, V's buckets), inv, first_pos, n_valid."""
    return (4 * d * (k_u + k) + 4 * d * 2 * (rows_m + rows_v)
            + 4 * ((3 if track_m else 1) * depth * k_u + 2 * k + 1))


def b5_bytes(k: int, d: int, touched: int, depth: int) -> int:
    """B5: k rows read, the touched sketch rows read and written, the
    items' buckets and signs (or order) read."""
    return 4 * (k * d + 2 * touched * d + 2 * depth * k)


def b3_bytes(n: int, d: int, depth: int, width: int, signed: bool) -> int:
    """B3 over a whole (n, d) table: x read and the estimate written,
    the sketch read and written, the buckets (and signs) and the mask
    read."""
    return 4 * (2 * n * d + 2 * depth * width * d
                + (2 if signed else 1) * depth * n + n)


def sparse_step_bytes(k: int, k_u: int, d: int, rows_m: int,
                      rows_v: int) -> int:
    """A sparse-rows step's needed bytes: the ids; the unique table and
    target rows read and the table rows written; the touched M and V
    sketch rows read and written."""
    return 4 * k + 4 * d * (3 * k_u + 2 * (rows_m + rows_v))
