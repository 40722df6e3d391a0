"""The port's placement rules (``repro_torch.distributed.sharding``) against
the reference's (``repro.distributed.sharding``).

Both packages' rules read a mesh's ``axis_names`` and sizes only, so one
device-free stand-in (``SimpleNamespace(axis_names=..., devices=np.empty(
shape, object))``) serves both, on the meshes 1 x 1, 2 x 4, 8 x 1,
16 x 16 and the pod 2 x 16 x 16.  Specs compare as tuples (a
``PartitionSpec`` is one).  Inputs: every parameter of every reference
config (``spec_for`` on the reference's own paths and shapes, with and
without fsdp), qwen2-0.5b's params and ``cs_adam`` state built on the
``meta`` device against the reference's ``eval_shape`` trees (whole
``TrainStep.shardings`` and ``ServeStep`` specs, the reference's
``NamedSharding`` wrapping patched out), planned store trees including
llama4's 8-shard vocab plan, the strict errors word for word, and
``batch_spec``/``dp_axes`` over batch sizes.  ``local_block`` is held to
numpy slices and ``global_leaf`` to its inverse on ``ReplicaMesh``
threads.
"""
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.distributed import sharding as J
from repro.plan import cli as JCLI
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.store import _flatten
from repro_torch.distributed import ReplicaMesh
from repro_torch.distributed import sharding as T
from repro_torch.plan import cli as TCLI
from repro_torch.train import steps as TS

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "8x1": ((8, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "pod": ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(name):
    shape, names = MESHES[name]
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, object))


def _jflat(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P) or x is None)
    return {"/".join(J._kp_str(kp)): None if s is None else tuple(s)
            for kp, s in flat}


def _tflat(specs, like):
    return {p: None if s is None else tuple(s) for (p, _), s in
            zip(_flatten(like), T._spec_leaves(specs, like))}


@pytest.fixture(scope="module")
def jparams():
    return {a: JCLI.params_shapes_for_config(jconfigs.get(a))
            for a in jconfigs.ARCH_IDS}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("fsdp", [False, True])
def test_spec_for_every_config_leaf(jparams, mesh, fsdp):
    m = _mesh(mesh)
    n = 0
    for arch, ps in jparams.items():
        for es in ("ep", "tp"):
            for kp, x in jax.tree_util.tree_flatten_with_path(ps)[0]:
                path = "/".join(J._kp_str(kp))
                want = J.spec_for(path, tuple(x.shape), m, fsdp=fsdp,
                                  expert_sharding=es)
                got = T.spec_for(path, tuple(x.shape), m, fsdp=fsdp,
                                 expert_sharding=es)
                assert got == tuple(want), (arch, path)
                n += 1
    assert n > 300            # 187 leaves in the ten configs, twice


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("fsdp", [False, True])
def test_param_specs_qwen2_meta(mesh, fsdp):
    m = _mesh(mesh)
    tps = TCLI.params_shapes_for_config(tconfigs.get("qwen2_0_5b"))
    jps = JCLI.params_shapes_for_config(jconfigs.get("qwen2_0_5b"))
    got = _tflat(T.param_specs(tps, m, fsdp=fsdp), tps)
    want = _jflat(J.param_specs(jps, m, fsdp=fsdp))
    assert got == want
    assert any(s for s in got.values())


def _unwrapped(monkeypatch):
    """The reference's placement methods without their NamedSharding
    wrapping, so they run on a device-free mesh."""
    import repro.serve.steps as JSS
    import repro.train.steps as JTS
    monkeypatch.setattr(J, "named", lambda mesh, tree: tree)
    monkeypatch.setattr(JTS, "NamedSharding", lambda mesh, s: s)
    return JTS, JSS


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("budget", [None, "floor", "config"])
def test_train_step_shardings(monkeypatch, mesh, budget):
    JTS, _ = _unwrapped(monkeypatch)
    m = _mesh(mesh)
    jcfg, tcfg = jconfigs.get("qwen2_0_5b"), tconfigs.get("qwen2_0_5b")
    jplan = tplan = None
    if budget is not None:
        from repro.plan import plan_for_config as jpfc
        jplan, tplan = jpfc(jcfg, budget), TCLI.plan_for_config(tcfg, budget)
    jts = JTS.make_train_step(jcfg, plan=jplan)
    tts = TS.make_train_step(tcfg, plan=tplan, device="meta")
    batch = {"tokens": np.zeros((16, 8), np.int32),
             "labels": np.zeros((16, 8), np.int32)}
    jb = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()}
    jp, jo, jbs, jm = jts.shardings(m, jb)
    tp, to, tbs, tm = tts.shardings(m, batch)
    tps = tts.params_shape()
    assert _tflat(tp, tps) == _jflat(jp)
    assert _tflat(to, tts.opt_shape(tps)) == _jflat(jo)
    assert {k: tuple(v) for k, v in jbs.items()} == tbs
    assert tm == tuple(jm) == ()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_serve_step_specs(monkeypatch, mesh):
    _, JSS = _unwrapped(monkeypatch)
    from repro_torch.serve import steps as TSS
    m = _mesh(mesh)
    cfg = "qwen2_0_5b"
    js = JSS.make_serve_step(jconfigs.get(cfg), batch=16, max_seq=256)
    ts = TSS.make_serve_step(tconfigs.get(cfg), batch=16, max_seq=256)
    assert _tflat(ts.cache_specs(m), ts.cache_shape()) == \
        _jflat(js.cache_specs(m))
    assert _tflat(ts.param_shardings(m), ts.params_shape()) == \
        _jflat(js.param_shardings(m))


LLAMA4_VOCAB = {"tok_embed/table": (202048, 5120),
                "lm_head/table": (202048, 5120)}


def _table_trees(shapes):
    import jax.numpy as jnp
    jp, tp = {}, {}
    for path, shape in shapes.items():
        a, b = path.split("/")
        jp.setdefault(a, {})[b] = jax.ShapeDtypeStruct(shape, jnp.float32)
        tp.setdefault(a, {})[b] = torch.empty(shape, device="meta")
    return jp, tp


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", ["llama4_8_shards", "qwen2_0.25x_hash",
                                  "qwen2_int8"])
def test_opt_specs_for_planned_state(mesh, case):
    from repro import plan as JP
    from repro_torch import plan as TP
    m = _mesh(mesh)
    if case == "llama4_8_shards":
        shapes, kw = LLAMA4_VOCAB, dict(optimizer="cs_adam", shards=8)
        budget = tconfigs.get("llama4_maverick_400b_a17b").aux_budget_bytes
    elif case == "qwen2_0.25x_hash":
        shapes = {"tok_embed/table": (151936, 896)}
        kw, budget = dict(optimizer="cs_adam", shards=4,
                          shard_layout="hash"), "0.25x"
    else:
        shapes = {"tok_embed/table": (151936, 896)}
        kw, budget = dict(optimizer="cs_rmsprop",
                          sketch_dtype="int8"), "0.25x"
    jplan = JP.plan_for_tables(shapes, budget, **kw)
    tplan = TP.plan_for_tables(shapes, budget, **kw)
    jps, tps = _table_trees(shapes)
    jstate = jax.eval_shape(jplan.make_optimizer(1e-3).init, jps)
    tstate = tplan.make_optimizer(1e-3).init(tps)
    for strict in (True, False):
        try:
            want = _jflat(J.opt_specs_for_state(
                jstate, jps, m, store_tree=jplan.store_tree(),
                strict=strict))
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                T.opt_specs_for_state(tstate, tps, m,
                                      store_tree=tplan.store_tree(),
                                      strict=strict)
            assert str(got.value) == str(e)
            continue
        got = _tflat(T.opt_specs_for_state(tstate, tps, m,
                                           store_tree=tplan.store_tree(),
                                           strict=strict), tstate)
        assert got == want


def test_strict_errors_word_for_word():
    m = _mesh("2x4")
    import jax.numpy as jnp
    # a sketch-like moment with no param behind it
    jst = {"m": {"ghost": jax.ShapeDtypeStruct((3, 64, 8), jnp.float32)}}
    tst = {"m": {"ghost": torch.empty((3, 64, 8), device="meta")}}
    with pytest.raises(ValueError) as je:
        J.opt_specs_for_state(jst, {}, m)
    with pytest.raises(ValueError) as te:
        T.opt_specs_for_state(tst, {}, m)
    assert str(te.value) == str(je.value)
    assert "refusing to silently replicate" in str(te.value)
    # non-strict: replicated, as the reference
    assert _tflat(T.opt_specs_for_state(tst, {}, m, strict=False), tst) == \
        _jflat(J.opt_specs_for_state(jst, {}, m, strict=False))
    # a sharded sketch on a mesh whose 'model' axis does not divide it
    from repro import plan as JP
    from repro_torch import plan as TP
    shapes = {"tok_embed/table": (151936, 896)}
    jplan = JP.plan_for_tables(shapes, "0.25x", optimizer="cs_adam",
                               shards=2)
    tplan = TP.plan_for_tables(shapes, "0.25x", optimizer="cs_adam",
                               shards=2)
    jps, tps = _table_trees(shapes)
    bad = types.SimpleNamespace(axis_names=("data", "model"),
                                devices=np.empty((1, 5), object))
    with pytest.raises(ValueError) as je:
        J.opt_specs_for_state(
            jax.eval_shape(jplan.make_optimizer(1e-3).init, jps), jps, bad,
            store_tree=jplan.store_tree())
    with pytest.raises(ValueError) as te:
        T.opt_specs_for_state(tplan.make_optimizer(1e-3).init(tps), tps,
                              bad, store_tree=tplan.store_tree())
    assert str(te.value) == str(je.value)
    assert "2-shard sketch" in str(te.value)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_sketch_and_zero1_rules(mesh):
    m = _mesh(mesh)
    for b in (1, 2, 3, 4, 6, 8, 16, 24, 32, 48, 64, 512, 1000):
        assert T.dp_axes(m, b) == J.dp_axes(m, b)
        for shape, seq in (((b,), None), ((b, 128), None), ((b, 256, 4), 1),
                           ((b, 7, 4), 1)):
            assert T.batch_spec(m, shape, seq_axis=seq) == \
                tuple(J.batch_spec(m, shape, seq_axis=seq))
    for shape in ((3, 10240, 896), (3, 1000, 7), (4, 64, 16), (3, 5, 5)):
        for shards in (1, 2, 4, 16):
            assert T.sketch_spec(m, shape, shards=shards) == \
                tuple(J.sketch_spec(m, shape, shards=shards))
    for spec, shape in (((), (64, 32)), (("model",), (64, 32)),
                        ((None, "model"), (32, 64)), (("data",), (16, 3)),
                        ((), (7, 5)), ((("pod", "data"),), (64, 4))):
        assert T.zero1_spec(spec, shape, m) == \
            tuple(J.zero1_spec(P(*spec), shape, m))


def test_sketch_state_specs():
    import jax.numpy as jnp
    jst = {"step": jnp.zeros((), jnp.int32), "m": jnp.zeros((3, 8, 4)),
           "v": jnp.zeros((3, 8, 4)), "residual": jnp.zeros((3, 8, 4))}
    tst = {"step": torch.zeros((), dtype=torch.int32),
           "m": torch.zeros((3, 8, 4)), "v": torch.zeros((3, 8, 4)),
           "residual": torch.zeros((3, 8, 4))}
    assert _tflat(T.sketch_state_specs(tst), tst) == \
        _jflat(J.sketch_state_specs(jst))
    assert T.sketch_state_specs(tst)["v"] == (None, "model")


@pytest.mark.parametrize("mesh", ["1x1", "2x4", "8x1", "pod"])
def test_local_block_is_the_slice(mesh):
    m = _mesh(mesh)
    shape, names = MESHES[mesh]
    x = np.arange(64 * 32 * 4, dtype=np.float32).reshape(64, 32, 4)
    sizes = dict(zip(names, shape))
    for spec in ((), ("data",), (None, "model"), ("data", "model"),
                 ((tuple(a for a in ("pod", "data") if a in sizes)),)):
        for coords in np.ndindex(*shape):
            at = dict(zip(names, coords))
            want = x
            for dim, entry in enumerate(spec):
                axes = (entry,) if isinstance(entry, str) else tuple(
                    entry or ())
                n, idx = 1, 0
                for a in axes:
                    n, idx = n * sizes[a], idx * sizes[a] + at[a]
                blk = want.shape[dim] // n
                want = np.take(want, range(idx * blk, (idx + 1) * blk),
                               axis=dim)
            got = T.local_block(x, spec, m, coords)
            assert got.is_contiguous()
            np.testing.assert_array_equal(got.numpy(), want)
            got_t = T.local_block(torch.from_numpy(x), spec, m, at)
            assert got_t.data_ptr() != torch.from_numpy(x).data_ptr() \
                or spec == ()
            np.testing.assert_array_equal(got_t.numpy(), want)
    with pytest.raises(ValueError, match="does not split"):
        T.local_block(np.zeros((3, 5)), (None, "model"),
                      _mesh("2x4"), (0, 1))


def test_global_leaf_inverts_local_block():
    x = torch.arange(2 * 12 * 3, dtype=torch.float32).reshape(2, 12, 3)
    mesh = ReplicaMesh((2, 3), timeout=60)
    specs = [(None, "model"), ("data", "model"), (None, ("data", "model")),
             ()]

    def body():
        out = []
        for spec in specs:
            blk = T.local_block(x, spec, mesh)
            out.append(torch.equal(T.global_leaf(blk, spec, mesh), x))
        return out

    assert all(all(r) for r in mesh.run(body, [()] * 6))


def test_grid_and_placement():
    g = T.Grid((2, 4))
    assert g.size == 8 and g.coords(6) == (1, 2)
    assert T.axis_sizes(g) == {"data": 2, "model": 4}
    assert T.axis_sizes(ReplicaMesh((1, 4))) == {"data": 1, "model": 4}
    tree = {"a": torch.zeros((4, 8)), "b": [torch.zeros(8), None]}
    pl = T.Placement({"a": (None, "model"), "b": [(), None]}, g, (1, 3))
    assert pl.spec_leaves(tree) == [(None, "model"), (), None]
    assert not pl.is_writer()
    assert T.Placement(None, g, (0, 0)).is_writer()
    placed = T.place(tree, pl, "cpu")
    assert placed["a"].shape == (4, 2) and placed["b"][1] is None
    with pytest.raises(ValueError, match="one name an axis"):
        T.Grid((2, 2), ("data",))
