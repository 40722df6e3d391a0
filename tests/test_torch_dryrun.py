"""``repro_torch.launch.dryrun``: cells traced on the ``meta`` device.

  * qwen2-0.5b ``train_4k`` on one card (``1x1``): the global FLOPs are
    256 x the ``flops_per_device`` of the reference's committed record
    (``experiments/dryrun/single``, a 16 x 16 grid), and the record has
    the reference's keys;
  * the same cell on ``16x16``: the optimizer state's sharding coverage
    equals the record's {30, 30, 4, 4}, and the per-device argument
    bytes (each leaf's block under the spec trees) equal its
    ``argument_size_in_bytes`` 171,168,964 to the byte (the check
    allows 1%): there is no gap to explain;
  * reduced configs of each family: the port's FLOPs against
    ``hlo_cost.analyze`` of the reference's compiled one-device step.
    With 8 loss chunks and an encoder of 4 attention chunks XLA keeps
    its loops, so neither side computes a product the other skips: the
    gqa, moe, enc-dec and VLM families are equal.  rwkv6 is 65,536
    FLOPs under: the WKV's bonus term ``einsum('bihk,bihv->bihv')``
    reduces one operand only, which XLA lowers to a dot and torch to a
    product and a sum.  The hybrid is 57,704,448 under (6.07%), in two
    parts: the reference's nested remat reruns the 8,388,608-FLOP
    projections (d_model to d_inner and back, the shared block's MLP)
    80 times in all where the port's runs them 74 times (50,331,648),
    and the SSD's chunk products decompose differently (the
    reference's scan over chunks makes 1,320 dots of 1,024 to 1,048,576
    FLOPs, 73,728,000 in all; the port's batched einsums make 108
    products, 66,355,200: 7,372,800);
  * ``--aux-budget config`` on 16x16: the reference's committed planned
    record's plan, FLOPs and argument bytes (176,218,820);
  * every registry arch's ``decode_32k`` cell and the two ``long_500k``
    cells give ``ok``; ``long_500k`` of a full-attention arch gives the
    reference's ``skipped``.
"""
import json
from pathlib import Path

import jax
import pytest

from repro import configs as ref_configs
from repro.launch import hlo_cost
from repro.train.steps import make_train_step as ref_train_step
from repro_torch import configs
from repro_torch.launch import dryrun

REPO = Path(__file__).resolve().parents[1]
RECORD = json.loads((REPO / "experiments" / "dryrun" / "single"
                     / "qwen2_0_5b__train_4k.json").read_text())
# the reduced step: 2 x 64 tokens, 8 loss chunks, 4 encoder chunks
REDUCED = dict(loss_chunk=16)
# FLOPs the port counts under the reference (see the docstring)
GAPS = {"rwkv6_7b": 65_536, "zamba2_2_7b": 57_704_448}
# (FLOPs, bytes, argument bytes) of qwen2-0.5b's cells on one card:
# chip_smoke.py phase 18a holds its trace in the card's process to them
QWEN_1X1 = {"train_4k": (5_586_756_019_683_328, 269_513_461_305_048,
                         5_832_645_124),
            "decode_32k": (487_231_324_160, 503_582_576_100,
                           54_060_277_764)}


def _counts(rec):
    return (rec["roofline"]["flops_per_device"],
            rec["roofline"]["bytes_per_device"],
            rec["memory"]["argument_size_in_bytes"])


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    assert dryrun.main(["--arch", "qwen2_0_5b", "--shape", "train_4k",
                        "--out", str(out)]) == 0
    wide = dryrun.run_cell("qwen2_0_5b", "train_4k", "16x16", out_root=out)
    return json.loads((out / "1x1" / "qwen2_0_5b__train_4k.json")
                      .read_text()), wide


def test_one_card_flops_equal_reference(records):
    one, _ = records
    assert one["status"] == "ok" and one["devices"] == 1
    assert one["roofline"]["flops_per_device"] == \
        256 * RECORD["roofline"]["flops_per_device"] == 5_586_756_019_683_328
    # the committed record predates the ``store_backend`` key that the
    # reference's ``run_cell`` now writes into every ``ok`` record
    assert set(one) == set(RECORD) | {"store_backend"}
    assert set(one["roofline"]) == set(RECORD["roofline"])
    assert set(one["roofline"]["collectives"]) == \
        set(RECORD["roofline"]["collectives"])
    assert set(one["memory"]) <= set(RECORD["memory"])
    assert one["memory"]["peak_bytes_per_device"] is None
    assert (one["n_params"], one["n_params_active"], one["tokens_global"]) \
        == (RECORD["n_params"], RECORD["n_params_active"],
            RECORD["tokens_global"])
    # no 'data' axis of more than one card: no collective
    assert one["roofline"]["collective_link_bytes"] == 0
    assert _counts(one) == QWEN_1X1["train_4k"]


def test_grid_sharding_and_argument_bytes_equal_reference(records):
    _, wide = records
    assert wide["devices"] == 256
    assert wide["opt_sharding"] == RECORD["opt_sharding"] == {
        "leaves": 30, "sharded": 30, "sketch_leaves": 4,
        "sketch_sharded": 4}
    want = RECORD["memory"]["argument_size_in_bytes"]
    got = wide["memory"]["argument_size_in_bytes"]
    assert abs(got - want) <= 0.01 * want
    assert got == want == 171_168_964
    assert wide["roofline"]["flops_per_device"] == \
        RECORD["roofline"]["flops_per_device"]
    # the gradients' all-reduce over the 16-card 'data' axis, one a leaf
    # and one for the loss; no 'model'-axis collective
    ar = wide["roofline"]["collectives"]["all-reduce"]
    assert ar["count"] > 0 and ar["link_bytes"] > 0
    assert wide["roofline"]["collectives"]["all-gather"]["count"] == 0


def test_planned_cell_equals_reference(tmp_path):
    """``--aux-budget config`` on 16x16: the plan the port's planner
    solves, the FLOPs and the per-device argument bytes of the reference's
    committed planned record."""
    want = json.loads((REPO / "experiments" / "dryrun" / "single"
                       / "qwen2_0_5b__train_4k__plan-config.json")
                      .read_text())
    got = dryrun.run_cell("qwen2_0_5b", "train_4k", "16x16",
                          out_root=tmp_path, aux_budget="config")
    assert got["status"] == "ok", got.get("error")
    assert (tmp_path / "16x16"
            / "qwen2_0_5b__train_4k__plan-config.json").exists()
    assert {k: got["plan"][k] for k in want["plan"]} == want["plan"]
    assert got["roofline"]["flops_per_device"] == \
        want["roofline"]["flops_per_device"]
    assert got["memory"]["argument_size_in_bytes"] == \
        want["memory"]["argument_size_in_bytes"] == 176_218_820


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "qwen2_moe_a2_7b",
                                  "whisper_medium", "internvl2_2b",
                                  "rwkv6_7b", "zamba2_2_7b"])
def test_reduced_flops_against_hlo_cost(arch):
    kw = dict(REDUCED, **({"enc_seq": 64} if arch == "whisper_medium"
                          else {}))
    rcfg = ref_configs.get(arch).reduced(**kw)
    cfg = configs.get(arch).reduced(**kw)
    seq = 64 + (cfg.n_patches if cfg.family == "vlm" else 0)
    ts = ref_train_step(rcfg, optimizer="cs_adam")
    ps = ts.params_shape()
    batch = ref_configs.train_batch_specs(
        rcfg, ref_configs.ShapeConfig("t", "train", seq, 2))
    hlo = jax.jit(ts.step_fn).lower(ps, ts.opt_shape(ps), batch) \
        .compile().as_text()
    want = hlo_cost.analyze(hlo, 1).flops
    cost = dryrun.trace_cell(cfg, configs.ShapeConfig("t", "train", seq,
                                                      2))[0]
    assert want - cost.flops == GAPS.get(arch, 0)


@pytest.mark.parametrize("arch,shape", [(a, "decode_32k")
                                        for a in configs.ARCH_IDS]
                         + [("rwkv6_7b", "long_500k"),
                            ("zamba2_2_7b", "long_500k"),
                            ("yi_9b", "long_500k")])
def test_serve_cells(tmp_path, arch, shape):
    rec = dryrun.run_cell(arch, shape, out_root=tmp_path)
    if configs.cell_skip(arch, shape):
        assert rec["status"] == "skipped"
        assert rec["reason"] == ref_configs.cell_skip(arch, shape)
        return
    assert rec["status"] == "ok", rec.get("error")
    assert rec["kind"] == "decode" and rec["optimizer"] is None
    assert rec["roofline"]["flops_per_device"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    if (arch, shape) == ("qwen2_0_5b", "decode_32k"):
        assert _counts(rec) == QWEN_1X1[shape]
