"""The port's checkpoints against the JAX package's, on one format.

A checkpoint either package writes restores in the other: the same leaf
path strings (dicts sorted, sequences by index, NamedTuple fields as
``.name``, None a leaf with no file), the same ``leaf-%05d.npy`` files
and manifest, f32/int32/int8 leaves bit for bit.  bf16 files are
byte-equal; the reference cannot load them back itself (``np.load``
gives ``|V2`` words, which ``jnp.asarray`` refuses; ROADMAP C), so the
port's restore of a JAX-written bf16 leaf is held to the bit and the JAX
restore is not asked for one.  Also: ``LATEST``, ``tmp-N`` and ``keep``;
an async save followed by an in-place write (the files keep the old
values); restore builds new tensors; ``fold_sketches`` and
``fold_predicate_from_manifest`` decide and fold as the reference does.
"""
import json
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import plan as JP
from repro.checkpoint import store as J
from repro.core.quantize import QuantState as JQ
from repro.core.stores import Rank1Moment as JR
from repro_torch import plan as TP
from repro_torch.checkpoint import store as T
from repro_torch.core.quantize import QuantState as TQ
from repro_torch.core.stores import Rank1Moment as TR

torch.set_num_threads(1)


def _arrays(seed=0):
    """One tree (f32, int32, int8, None, a rank-1 pair, an int8 sketch
    state, a list and a tuple) in its reference and port forms."""
    rng = np.random.RandomState(seed)
    x = [rng.randn(64, 8), rng.randn(3), rng.randn(2, 2), rng.rand(64),
         rng.rand(8), rng.randint(-127, 128, (3, 16, 8)), rng.rand(3, 1),
         rng.randint(0, 9, 5)]
    x = [a.astype(t) for a, t in zip(x, [np.float32] * 5 + [np.int8,
                                                      np.float32, np.int32])]

    def tree(arr, rank1, quant):
        return {"params": {"tok_embed": {"table": arr(x[0])},
                           "blocks": [arr(x[1]), (arr(x[2]), None)]},
                "opt_state": {"step": arr(np.asarray(7, np.int32)),
                              "m": {"tok_embed": {"table": None}},
                              "v": {"tok_embed": {"table": rank1(
                                  arr(x[3]), arr(x[4]))},
                                    "lm_head": {"table": quant(
                                        arr(x[5]), arr(x[6]))}},
                              "ids": arr(x[7])}}

    return (tree(jnp.asarray, JR, JQ),
            tree(lambda a: torch.from_numpy(a.copy()), TR, TQ))


def _host(tree):
    return [(p, None if x is None else np.asarray(x))
            for p, x in J._flatten(jax.device_get(tree))[0]]


def _assert_trees_equal(t_tree, j_tree):
    got = [(p, None if x is None else x.numpy()) for p, x in
           T._flatten(t_tree)]
    want = _host(j_tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        assert (a is None) == (b is None), p
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, p
            np.testing.assert_array_equal(a, b, err_msg=p)


def test_leaf_paths_are_the_reference_strings():
    j_tree, t_tree = _arrays()
    want = [p for p, _ in J._flatten(j_tree)[0]]
    assert [p for p, _ in T._flatten(t_tree)] == want
    assert "opt_state/v/tok_embed/table/.r" in want
    assert "opt_state/v/lm_head/table/.scales" in want
    assert "opt_state/m/tok_embed/table" in want       # a None leaf


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    j_tree, t_tree = _arrays(1)
    T.save(tmp_path / "t", 12, t_tree, extra={"note": [1, 2]})
    J.save(tmp_path / "j", 12, j_tree, extra={"note": [1, 2]})
    assert T.read_manifest(tmp_path / "t") == J.read_manifest(tmp_path / "j")
    step, back = J.restore(tmp_path / "t", j_tree)
    assert step == 12
    _assert_trees_equal(t_tree, back)
    for f in sorted((tmp_path / "j" / "step-12").glob("leaf-*.npy")):
        assert (tmp_path / "t" / "step-12" / f.name).read_bytes() == \
            f.read_bytes(), f.name


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    j_tree, t_tree = _arrays(2)
    J.save(tmp_path, 3, j_tree)
    like = _arrays(9)[1]
    step, back = T.restore(tmp_path, like, device="cpu")
    assert step == 3
    _assert_trees_equal(back, j_tree)
    assert isinstance(back["opt_state"]["v"]["tok_embed"]["table"], TR)
    assert isinstance(back["opt_state"]["v"]["lm_head"]["table"], TQ)
    assert isinstance(back["params"]["blocks"][1], tuple)
    s = back["opt_state"]["step"]
    assert s.dtype == torch.int32 and s.dim() == 0 and int(s) == 7
    # new tensors: restoring into a live tree never aliases it
    for (_, a), (_, b) in zip(T._flatten(back), T._flatten(like)):
        if a is not None:
            assert a.data_ptr() != b.data_ptr()


def test_bf16_files_byte_equal_and_restored_to_the_bit(tmp_path):
    rng = np.random.RandomState(3)
    bits = rng.randint(0, 1 << 16, (3, 40, 6)).astype(np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] = 0x3F80     # no NaN/inf patterns
    j_arr = bits.view(ml_dtypes.bfloat16)
    t_arr = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    J.save(tmp_path / "j", 1, {"s": jnp.asarray(j_arr), "x": jnp.ones(2)})
    T.save(tmp_path / "t", 1, {"s": t_arr, "x": torch.ones(2)})
    for name in ("leaf-00000.npy", "leaf-00001.npy", "manifest.json"):
        assert (tmp_path / "t" / "step-1" / name).read_bytes() == \
            (tmp_path / "j" / "step-1" / name).read_bytes(), name
    entry = T.read_manifest(tmp_path / "t")["leaves"][0]
    assert entry["dtype"] == "bfloat16" and entry["shape"] == [3, 40, 6]
    _, back = T.restore(tmp_path / "j", {"s": None, "x": None},
                        device="cpu")
    assert back["s"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        back["s"].view(torch.int16).numpy().view(np.uint16), bits)


def test_latest_tmp_and_keep(tmp_path):
    tree = {"a": torch.arange(4.0), "step": torch.tensor(0, dtype=torch.int32)}
    assert T.latest_step(tmp_path) is None
    with pytest.raises(FileNotFoundError):
        T.restore(tmp_path, tree, device="cpu")
    (tmp_path / "tmp-9").mkdir()            # a crashed write
    (tmp_path / "tmp-9" / "junk").write_text("x")
    for step in (1, 2, 3, 9):
        tree["a"] += 1
        T.save(tmp_path, step, tree, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["LATEST", "step-3", "step-9"]
    assert T.latest_step(tmp_path) == 9 and J.latest_step(tmp_path) == 9
    assert T.restore(tmp_path, tree, step=3, device="cpu")[1]["a"].tolist() \
        == [3.0, 4.0, 5.0, 6.0]
    (tmp_path / "LATEST").write_text("4")   # LATEST naming a missing step
    assert T.latest_step(tmp_path) is None
    # placed: this replica's block of each saved global leaf
    from repro_torch.distributed.sharding import Grid, Placement
    _, placed = T.restore(tmp_path, tree, step=9, device="cpu",
                          shardings=Placement({"a": ("model",), "step": ()},
                                              Grid((1, 2)), (0, 1)))
    assert placed["a"].tolist() == [6.0, 7.0]


def test_async_save_copies_before_returning(tmp_path):
    """The port's steps write in place: an in-place write right after an
    async save must not reach its files."""
    table = torch.arange(1 << 16, dtype=torch.float32)
    gate = threading.Event()
    orig = T._write_leaf

    def slow(*a):
        gate.wait(10)
        orig(*a)
    T._write_leaf = slow
    try:
        writer = T.save(tmp_path, 5, {"t": table}, async_=True)
        table.add_(1.0)                     # the next step, in place
        gate.set()
        writer.join(10)
    finally:
        T._write_leaf = orig
    assert not writer.is_alive()
    _, back = T.restore(tmp_path, {"t": None}, device="cpu")
    np.testing.assert_array_equal(back["t"].numpy(),
                                  np.arange(1 << 16, dtype=np.float32))


def _planned_manifest(tmp_path):
    """A JAX-planned run's checkpoint: its plan and StoreTree in
    ``extra``, the moments laid out as ``opt_state/{m,v}/<param path>``."""
    shapes = {"tok_embed": {"table": (4096, 8)}, "lm_head": {"table": (2048, 8)},
              "w": (16, 8)}
    j_ps = {k: ({"table": jnp.zeros(v["table"])} if isinstance(v, dict)
                else jnp.zeros(v)) for k, v in shapes.items()}
    plan = JP.plan_for_params(j_ps, int(0.3 * JP.dense_budget_bytes(j_ps)),
                              width_multiple=16)
    state = plan.make_optimizer(1e-3).init(j_ps)
    state = jax.tree_util.tree_map(
        lambda x: x + jnp.arange(x.size, dtype=x.dtype).reshape(x.shape)
        % 7, state)
    J.save(tmp_path, 1, {"params": j_ps, "opt_state": state},
           extra={"plan": plan.to_json(),
                  "store_tree": plan.store_tree().to_json()})
    return plan, {"params": j_ps, "opt_state": state}


def test_fold_predicate_and_fold_match_reference(tmp_path):
    jplan, j_tree = _planned_manifest(tmp_path)
    manifest = T.read_manifest(tmp_path)
    t_pred = T.fold_predicate_from_manifest(manifest)
    j_pred = J.fold_predicate_from_manifest(manifest)
    flat = J._flatten(j_tree)[0]
    decisions = [j_pred(p, x) for p, x in flat]
    assert [t_pred(p, x) for p, x in flat] == decisions
    assert sum(decisions) == 4          # m and v of both tables
    assert [T.default_is_sketch(p, x) for p, x in flat] == \
        [J.default_is_sketch(p, x) for p, x in flat]
    _, t_tree = T.restore(tmp_path, _like(j_tree), device="cpu")
    t_fold = T.fold_sketches(t_tree, t_pred)
    j_fold = J.fold_sketches(j_tree, j_pred)
    _assert_trees_equal(t_fold, j_fold)
    tplan = TP.Plan.from_json(manifest["extra"]["plan"])
    for path, d in tplan.fold().specs().items():
        top, leaf = path.split("/")
        for moment, spec in d.items():
            assert tuple(t_fold["opt_state"][moment][top][leaf].shape) == \
                spec.shape
    assert tplan.fold().to_json() == jplan.fold().to_json()
    # no StoreTree in the manifest: the name rule
    assert T.fold_predicate_from_manifest({"extra": {}}) is \
        T.default_is_sketch
    with pytest.raises(ValueError, match="default_v is sketch-backed"):
        from repro_torch.core.stores import CountMinStore, StoreTree
        T.is_sketch_from_store_tree(StoreTree(default_v=CountMinStore()))


def _like(j_tree):
    """A port tree of the same structure (zeros)."""
    def conv(x):
        if x is None:
            return None
        return torch.zeros(tuple(x.shape))
    return jax.tree_util.tree_map(conv, jax.device_get(j_tree),
                                  is_leaf=lambda x: x is None)


def test_manifest_is_json_the_reference_reads(tmp_path):
    _, t_tree = _arrays(4)
    T.save(tmp_path, 2, t_tree, extra={"plan": None})
    m = json.loads((tmp_path / "step-2" / "manifest.json").read_text())
    assert m["step"] == 2 and m["extra"] == {"plan": None}
    files = [e["file"] for e in m["leaves"]]
    assert files[0] == "leaf-00000.npy" and None in files
