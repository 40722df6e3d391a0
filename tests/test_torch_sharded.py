"""The port's sharded sketches against the JAX package.

Sketch state split into width slabs over a shard axis (the reference's
``tests/test_sharded.py``).  The slab primitives are pure functions of
the shard index, so most of the module runs in this process against the
reference on the same numpy inputs:

* ``init_slab``/``update_slab``/``gather_slab``/``finish_query`` under
  both layouts, signed and unsigned, f32 and bf16 cells, to the bit (as
  ``tests/test_torch_lowp.py`` holds ``sketch.update``: no product rounds
  differently); the port's own identities (the slabs concatenate to
  ``update``, their gathers sum to ``query``'s, the hash layout keeps an
  id on one shard, a width-layout state is the unsharded one);
* the registry's coercion of the slab ops' backends, ``fold`` of f32,
  bf16, int8 and hash-layout states and ``HashFamily.fold``, the two
  byte models, ``StoreTree``'s spec tables, sharded plans' JSON and the
  counterparts of ``TestPerShardPlanning``, and ``ReplicaMesh``;
* under the reference's dyadic protocol (β₁ = β₂ = 0.5, integer rows)
  the port's sharded step equals its own DP step at the same dp to the
  bit (the hash layout against the DP step on hash-stamped stores, as
  the reference pairs them);
* the sharded steps against the reference's ``shard_map`` steps, run once
  for the module in a subprocess under
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` that writes every
  result to one ``.npz`` (``_jax_reference``): shard-only over 4 shards
  and a 2 × 2 grid, both layouts, with and without error feedback and
  the first moment.  Update ids to the bit; table and state within rtol
  1e-5/atol 1e-6 after one step and 1e-4/1e-5 after three.

Replicas are ``ReplicaMesh`` threads (``timeout`` 120 s); the subprocess
has its own 900 s limit.  State is compared by value (``torch.equal``),
not by bit pattern: a −0.0 summed with other shards' +0.0 is +0.0 in both
packages.  The port writes sketches and tables in place, so it is given
copies of every numpy buffer JAX sees.  Torch runs on one CPU thread.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as JK
import repro_torch.kernels as TK
from repro import plan as JP
from repro.core import hashing as jh
from repro.core import sketch as jcs
from repro.core import stores as jst
from repro.distributed import sketched_reduce as jsr
from repro_torch import convert
from repro_torch import plan as TP
from repro_torch.core import hashing as th
from repro_torch.core import sketch as tcs
from repro_torch.core import stores as tst
from repro_torch.core.optimizers import SketchHParams as THP
from repro_torch.core.stores import StoreTree
from repro_torch.distributed import (ReplicaGroup, ReplicaMesh, join_slabs,
                                     shard_state)
from repro_torch.distributed import sketched_reduce as tsr
from repro_torch.train.steps import make_sparse_embedding_step as t_make
from repro_torch.train.steps import sparse_embedding_stores as t_stores

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N, D, B = 512, 16, 128                    # table rows, dim, global batch
SHARDS, WIDTH = 4, 64
PATH = "sparse_embedding"
LR, STEPS = 1e-2, 3
TOL = dict(rtol=1e-5, atol=1e-6)          # one step
TRAJ = dict(rtol=1e-4, atol=1e-5)         # after three
MESH_TIMEOUT = 120.0                      # s a replica waits at a barrier
REFERENCE_TIMEOUT = 900                   # s for the JAX subprocess
HP_KW = dict(compression=2.0, width_multiple=64)
LAYOUTS = ["width", "hash"]


def _specs(layout, signed=True, dtype="float32", shards=SHARDS, width=WIDTH):
    """(jax spec, port spec) of one sharded sketch."""
    kw = dict(depth=3, width=width, dim=D, signed=signed, seed=7,
              shards=shards, layout=layout)
    return (jcs.SketchSpec(dtype=jnp.dtype(dtype), **kw),
            tcs.SketchSpec(dtype=dtype, **kw))


def _batch(seed, b=B, dyadic=True):
    """(ids (b,) int32, rows (b, D) f32) as numpy."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, N, size=b).astype(np.int32)
    if dyadic:
        rows = rng.randint(-3, 4, size=(b, D)).astype(np.float32)
    else:
        rows = rng.randn(b, D).astype(np.float32)
    return ids, rows


def _t(a):
    """A torch copy of a numpy or JAX array (the port writes in place)."""
    return torch.tensor(np.asarray(a))


def _bits(x) -> np.ndarray:
    """The values of a port tensor or JAX array, bf16 widened to f32."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x.astype(jnp.float32))


# ------------------------------------------------------------ slab primitives
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_slab_primitives_match_reference(layout, signed, dtype):
    js, ts = _specs(layout, signed, dtype)
    ids, rows = _batch(0, dyadic=False)
    full = jcs.update(js, jcs.init(js), jnp.asarray(ids), jnp.asarray(rows),
                      sr_seed=11)
    t_full = _t(_bits(full)).to(tcs.qz.torch_dtype(dtype))
    q = ids[:32]
    parts_j, parts_t = 0, 0
    for s in range(SHARDS):
        want = jcs.update_slab(js, jcs.init_slab(js), jnp.asarray(ids),
                               jnp.asarray(rows), s, sr_seed=123)
        got = tcs.update_slab(ts, tcs.init_slab(ts, "cpu"), _t(ids),
                              _t(rows), s, sr_seed=123)
        assert got.dtype == tcs.qz.torch_dtype(dtype)
        assert tuple(got.shape) == ts.slab_shape == js.slab_shape
        np.testing.assert_array_equal(_bits(got), _bits(want))
        jg = jcs.gather_slab(js, jcs.slab_of(js, full, s), jnp.asarray(q), s)
        tg = tcs.gather_slab(ts, tcs.slab_of(ts, t_full, s), _t(q), s)
        np.testing.assert_array_equal(_bits(tg), _bits(jg))
        parts_j, parts_t = parts_j + jg, parts_t + tg
    np.testing.assert_array_equal(
        _bits(tcs.finish_query(ts, parts_t, _t(q))),
        _bits(jcs.finish_query(js, parts_j, jnp.asarray(q))))


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_slabs_concatenate_to_the_full_update(layout, signed):
    _, ts = _specs(layout, signed)
    ids, rows = (_t(a) for a in _batch(1, dyadic=False))
    full = tcs.update(ts, tcs.init(ts, "cpu"), ids, rows)
    slabs = [tcs.update_slab(ts, tcs.init_slab(ts, "cpu"), ids, rows, s)
             for s in range(SHARDS)]
    assert torch.equal(torch.cat(slabs, dim=1), full)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_slab_gathers_sum_to_the_full_query(layout, signed):
    _, ts = _specs(layout, signed)
    ids, rows = (_t(a) for a in _batch(2, dyadic=False))
    S = tcs.update(ts, tcs.init(ts, "cpu"), ids, rows)
    q = ids[:48]
    parts = sum(tcs.gather_slab(ts, tcs.slab_of(ts, S, s), q, s)
                for s in range(SHARDS))
    assert torch.equal(tcs.finish_query(ts, parts, q), tcs.query(ts, S, q))


def test_hash_layout_keeps_an_id_on_one_shard():
    _, ts = _specs("hash")
    one = torch.ones((1, D))
    for i in (0, 1, 17, 255, 511):
        ids = torch.tensor([i], dtype=torch.int32)
        touched = [s for s in range(SHARDS) if bool(tcs.update_slab(
            ts, tcs.init_slab(ts, "cpu"), ids, one, s).abs().sum() > 0)]
        assert touched == [int(ts.family.owner(ids)[0])], (i, touched)


def test_width_layout_state_is_the_unsharded_state():
    _, ts = _specs("width")
    plain = dataclasses.replace(ts, shards=1)
    ids, rows = (_t(a) for a in _batch(3, dyadic=False))
    assert torch.equal(tcs.update(ts, tcs.init(ts, "cpu"), ids, rows),
                       tcs.update(plain, tcs.init(plain, "cpu"), ids, rows))


@pytest.mark.parametrize("backend", [None, "auto", "xla", "tiled"])
def test_registry_coerces_slab_backends(backend):
    js, ts = _specs("hash")
    ids, rows = _batch(4, dyadic=False)
    want = tcs.update_slab(ts, tcs.init_slab(ts, "cpu"), _t(ids), _t(rows), 1)
    got = TK.update_slab(ts, tcs.init_slab(ts, "cpu"), _t(ids), _t(rows), 1,
                         backend=backend)
    assert torch.equal(got, want)
    ref = JK.update_slab(js, jcs.init_slab(js), jnp.asarray(ids),
                         jnp.asarray(rows), 1, backend=backend)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert torch.equal(TK.gather_slab(ts, got, _t(ids), 1, backend=backend),
                       tcs.gather_slab(ts, got, _t(ids), 1))


# ------------------------------------------------------------ folds
FOLD_CASES = {"float32": ("width", 1, "float32"),
              "bfloat16": ("width", 1, "bfloat16"),
              "int8": ("width", 1, "int8"),
              "hash": ("hash", SHARDS, "float32"),
              "hash_bf16": ("hash", SHARDS, "bfloat16")}


@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_state_fold_matches_reference(case):
    layout, shards, dtype = FOLD_CASES[case]
    js, ts = _specs(layout, True, dtype, shards=shards, width=128)
    ids, rows = _batch(5, dyadic=False)
    jS = jcs.update(js, jcs.init(js), jnp.asarray(ids), jnp.asarray(rows))
    tS = convert.tree_from_numpy(jax.device_get(jS), "cpu")
    jspec, jF = jcs.fold(js, jS)
    tspec, tF = tcs.fold(ts, tS)
    assert tst.spec_to_json(tspec) == jst.spec_to_json(jspec)
    want = convert.tree_from_numpy(jax.device_get(jF), "cpu")
    if dtype == "int8":
        assert torch.equal(tF.cells, want.cells)
        assert torch.equal(tF.scales, want.scales)
    else:
        assert tF.dtype == want.dtype and torch.equal(tF, want)


def test_hash_layout_fold_is_exact_and_per_slab():
    """The folded hash-layout state is the sketch written at the folded
    spec directly, and ``HashFamily.fold`` is the reference's."""
    _, ts = _specs("hash", width=128)
    ids, rows = (_t(a) for a in _batch(6, dyadic=False))
    spec2, folded = tcs.fold(ts, tcs.update(ts, tcs.init(ts, "cpu"), ids,
                                            rows))
    direct = tcs.update(spec2, tcs.init(spec2, "cpu"), ids, rows)
    np.testing.assert_allclose(folded.numpy(), direct.numpy(), rtol=0,
                               atol=1e-5)
    fam = th.HashFamily(seed=7, depth=3, width=128, shards=SHARDS,
                        layout="hash")
    jfam = jh.HashFamily(seed=7, depth=3, width=128, shards=SHARDS,
                         layout="hash")
    np.testing.assert_array_equal(fam.fold().bucket(ids).numpy(),
                                  np.asarray(jfam.fold().bucket(
                                      jnp.asarray(ids.numpy()))))
    lw2 = 128 // SHARDS // 2
    np.testing.assert_array_equal(
        fam.fold().bucket(ids).numpy() // lw2,
        np.broadcast_to(fam.owner(ids).numpy(), (3, ids.numel())))


# ------------------------------------------------------------ byte models
def test_byte_models_match_reference():
    pairs = [_specs("width"), _specs("hash", False),
             _specs("width", True, "bfloat16"), _specs("hash", False,
                                                       "bfloat16", 8, 256)]
    js, ts = [p[0] for p in pairs], [p[1] for p in pairs]
    assert tsr.sharded_reduce_bytes(*ts, None) == \
        jsr.sharded_reduce_bytes(*js, None)
    for n in (1, 128, 4096):
        assert tsr.routing_bytes(n, *ts, None) == \
            jsr.routing_bytes(n, *js, None)
    for j, t in pairs:
        assert t.shard_nbytes() == j.shard_nbytes() == t.nbytes() // t.shards


# ------------------------------------------------------------ stores, plans
def _tree_pair(shards, layout):
    out = []
    for mod in (jst, tst):
        m = mod.CountSketchStore(width=128, depth=3, width_multiple=64,
                                 seed=7)
        v = mod.CountMinStore(width=128, depth=3, width_multiple=64, seed=7)
        if shards > 1:
            m, v = m.with_sharding(shards, layout), \
                v.with_sharding(shards, layout)
        out.append(mod.StoreTree(rules=(("emb/table", m, v),
                                        ("head/table", None, v))))
    return out


@pytest.mark.parametrize("shards,layout", [(1, "width"), (4, "width"),
                                           (4, "hash")])
def test_store_tree_spec_tables_match_reference(shards, layout):
    jtree, ttree = _tree_pair(shards, layout)
    shapes = {"emb/table": (N, D), "head/table": (N, 2 * D), "w": (4, 4)}
    jspecs = jtree.sketch_state_specs(shapes)
    tspecs = ttree.sketch_state_specs(shapes)
    assert sorted(tspecs) == sorted(jspecs)
    for key, spec in tspecs.items():
        assert tst.spec_to_json(spec) == jst.spec_to_json(jspecs[key])
        assert spec.shards == shards and spec.layout == layout
    assert ttree.sketch_state_shapes(shapes) == \
        jtree.sketch_state_shapes(shapes)
    tparams = {"emb": {"table": torch.zeros(N, D)},
               "head": {"table": torch.zeros(N, 2 * D)},
               "w": torch.zeros(4, 4)}
    jparams = jax.tree_util.tree_map(lambda x: jnp.zeros(tuple(x.shape)),
                                     tparams)
    t_by, j_by = ttree.sketch_specs(tparams), jtree.sketch_specs(jparams)
    assert sorted(t_by) == sorted(j_by)
    for path, d in t_by.items():
        assert {k: tst.spec_to_json(s) for k, s in d.items()} == \
            {k: jst.spec_to_json(s) for k, s in j_by[path].items()}
    m, v = ttree.resolve("emb/table", (N, D))
    assert m.shard_bytes() == m.spec.nbytes() // shards
    assert v.shard_bytes() == v.spec.shard_nbytes()


LLAMA4_VOCAB = {"tok_embed/table": (202048, 5120),
                "lm_head/table": (202048, 5120)}


def test_llama4_vocab_requires_sharding():
    from repro_torch.configs.llama4_maverick_400b_a17b import CONFIG
    budget = CONFIG.aux_budget_bytes
    with pytest.raises(TP.InfeasibleBudgetError):
        TP.plan_for_tables(LLAMA4_VOCAB, budget, optimizer="cs_adam")
    plan = TP.plan_for_tables(LLAMA4_VOCAB, budget, optimizer="cs_adam",
                              shards=8)
    jplan = JP.plan_for_tables(LLAMA4_VOCAB, budget, optimizer="cs_adam",
                               shards=8)
    assert plan.to_json() == jplan.to_json()
    assert plan.predicted_aux_bytes_per_device <= budget \
        < plan.predicted_aux_bytes
    assert all(leaf.mode == TP.MODE_SKETCH for leaf in plan.leaves)
    assert plan.store_tree().to_json() == jplan.store_tree().to_json()
    per_device = sum(store.shard_bytes() for path, shape in
                     LLAMA4_VOCAB.items() for store in
                     plan.store_tree().resolve(path, shape))
    assert per_device == plan.predicted_aux_bytes_per_device


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_plan_stamps_stores_and_specs(layout):
    kw = dict(optimizer="cs_adam", shards=8, shard_layout=layout)
    tables = {"tok_embed/table": (100000, 64)}
    plan = TP.plan_for_tables(tables, 256 * 2**10, **kw)
    jplan = JP.plan_for_tables(tables, 256 * 2**10, **kw)
    assert plan.store_tree().to_json() == jplan.store_tree().to_json()
    m_st, v_st = plan.store_tree().resolve("tok_embed/table", (100000, 64))
    assert v_st.shards == 8 and v_st.shard_layout == layout
    assert m_st.spec.shards == 8 and m_st.spec.layout == layout
    assert v_st.spec.width % 8 == 0
    back = TP.Plan.from_json(json.loads(json.dumps(plan.to_json())))
    assert back.sketch_shards == 8 and back.shard_layout == layout
    assert back.predicted_aux_bytes_per_device == \
        plan.predicted_aux_bytes_per_device
    assert back.store_tree().to_json() == plan.store_tree().to_json()
    text = plan.shard_table()
    assert "PER-DEVICE" in text
    assert f"{plan.predicted_aux_bytes_per_device:,}" in text


def test_unsharded_plan_json_and_width_checks():
    tables = {"tok_embed/table": (100000, 64)}
    plan = TP.plan_for_tables(tables, "0.25x", optimizer="cs_rmsprop")
    d = plan.to_json()
    assert "sketch_shards" not in d and "shard_layout" not in d
    assert TP.Plan.from_json(d).predicted_aux_bytes_per_device == \
        plan.predicted_aux_bytes
    width = next(l.width for l in plan.leaves if l.mode == TP.MODE_SKETCH)
    with pytest.raises(ValueError):
        plan.with_sharding(width * 3)


# ------------------------------------------------------------ ReplicaMesh
def test_replica_mesh_axes_join_their_lines_in_rank_order():
    mesh = ReplicaMesh((2, 3), timeout=MESH_TIMEOUT)

    def body(r):
        data, model = mesh.axis("data"), mesh.axis("model")
        x = torch.tensor([float(r)], dtype=torch.float32)
        return ((data.size, data.rank, model.size, model.rank),
                data.psum(x), model.psum(x), data.all_gather(x),
                model.pmean(x * 2))

    outs = mesh.run(body, [(r,) for r in range(6)])
    for r, (shape, dsum, msum, dgat, mmean) in enumerate(outs):
        d, s = divmod(r, 3)
        assert shape == (2, d, 3, s)
        assert float(dsum) == s + (3 + s)                # column s
        assert float(msum) == 3 * d + (3 * d + 1) + (3 * d + 2)
        assert dgat.flatten().tolist() == [float(s), float(3 + s)]
        assert float(mmean) == 2.0 * (3 * d + 1)


def test_replica_mesh_failure_reaches_every_replica():
    mesh = ReplicaMesh((2, 2), timeout=MESH_TIMEOUT)

    def body(r):
        if r == 3:
            raise RuntimeError("replica 3 failed")
        return mesh.axis("model").psum(torch.ones(1))

    with pytest.raises(RuntimeError, match="replica 3"):
        mesh.run(body, [(r,) for r in range(4)])
    # the mesh is usable again
    outs = mesh.run(lambda r: mesh.axis("data").psum(torch.ones(1)),
                    [(r,) for r in range(4)])
    assert all(float(o) == 2.0 for o in outs)
    with pytest.raises(RuntimeError, match="inside"):
        mesh.rank
    assert not any(t.name.startswith("replica-")
                   for t in threading.enumerate())


def test_shard_state_round_trips():
    _, _, opt = t_make(N, D, hparams=THP(**HP_KW), sketch_shards=SHARDS,
                       error_feedback=True, device="cpu")
    full = opt.init()
    for k in ("m", "v", "residual"):
        full[k].normal_()
    parts = [shard_state(full, SHARDS, s) for s in range(SHARDS)]
    for s, part in enumerate(parts):
        assert part["step"] is full["step"]
        for k in ("m", "v", "residual"):
            assert part[k].is_contiguous()
            assert tuple(part[k].shape) == (3, full[k].shape[1] // SHARDS, D)
    back = join_slabs(parts)
    for k in ("m", "v", "residual"):
        assert torch.equal(back[k], full[k])


# ------------------------------------------------------------ the steps
GRIDS = {"shard-only": (1, SHARDS), "2x2": (2, 2)}


def _sharded_run(grid, layout, *, track_m=True, feedback=False,
                 dyadic=True, b1=0.5, b2=0.5, steps=STEPS, updates=False):
    """The port's sharded step on ``ReplicaMesh(grid)``: after each step
    the replicas' tables (all equal to the bit, checked), the joined
    state and, with ``updates``, the first step's emitted update."""
    dp, sh = grid
    mesh = ReplicaMesh(grid, timeout=MESH_TIMEOUT)
    init_fn, step, opt = t_make(
        N, D, lr=LR, b1=b1, b2=b2, hparams=THP(**HP_KW),
        track_first_moment=track_m, sketch_shards=sh, shard_layout=layout,
        dp_axis=mesh.axis("data") if dp > 1 else None,
        shard_axis=mesh.axis("model"), error_feedback=feedback,
        device="cpu")
    table0 = _t(_table0())
    full = opt.init()
    tables = [table0.clone() for _ in range(dp * sh)]
    states = [shard_state(full, sh, r % sh) for r in range(dp * sh)]
    out, first = [], []
    k = B // dp
    for s in range(steps):
        ids, rows = _batch(100 + s, dyadic=dyadic)
        args = [(tables[r], states[r], _t(ids[(r // sh) * k:(r // sh + 1) * k]),
                 _t(rows[(r // sh) * k:(r // sh + 1) * k]))
                for r in range(dp * sh)]
        if updates and s == 0:
            # the emitted update of step 1, on copies of the start state
            first = mesh.run(lambda _tab, st, i, g: opt.update(
                {"ids": i, "rows": g}, {kk: v.clone() if isinstance(
                    v, torch.Tensor) else v for kk, v in st.items()})[0],
                args)
        outs = mesh.run(step, args)
        tables, states = [o[0] for o in outs], [o[1] for o in outs]
        for t in tables[1:]:
            assert torch.equal(t, tables[0])
        for d in range(dp):
            assert _states_equal(join_slabs(states[d * sh:(d + 1) * sh]),
                                 join_slabs(states[:sh]))
        out.append((tables[0].clone(), join_slabs(states[:sh])))
    return out, first


def _states_equal(a, b) -> bool:
    return all((a[k] is None and b[k] is None) or torch.equal(a[k], b[k])
               for k in ("m", "v", "residual"))


def _dp_run(dp, layout, *, track_m=True, feedback=False, dyadic=True,
            steps=STEPS):
    """The port's DP step at ``dp`` replicas on stores stamped with the
    sharded layout: the reference's pairing for the dyadic protocol."""
    sh = GRIDS["2x2"][1] if dp == 2 else SHARDS
    hp = THP(**HP_KW)
    m_st, v_st = t_stores(N, D, hparams=hp, track_first_moment=track_m,
                          sketch_shards=sh, shard_layout=layout)
    group = ReplicaGroup(dp, timeout=MESH_TIMEOUT)
    _, step, opt = t_make(N, D, lr=LR, b1=0.5, b2=0.5, hparams=hp,
                          stores=StoreTree(rules=((PATH, m_st, v_st),)),
                          dp_axis=group, error_feedback=feedback,
                          device="cpu")
    tables = [_t(_table0()) for _ in range(dp)]
    states = [opt.init() for _ in range(dp)]
    out = []
    k = B // dp
    for s in range(steps):
        ids, rows = _batch(100 + s, dyadic=dyadic)
        outs = group.run(step, [(tables[r], states[r],
                                 _t(ids[r * k:(r + 1) * k]),
                                 _t(rows[r * k:(r + 1) * k]))
                                for r in range(dp)])
        tables, states = [o[0] for o in outs], [o[1] for o in outs]
        out.append((tables[0].clone(), {kk: v.clone() if isinstance(
            v, torch.Tensor) else v for kk, v in states[0].items()}))
    return out


DYADIC = [("shard-only", "width", True, False),
          ("shard-only", "hash", False, False),
          ("2x2", "width", True, False), ("2x2", "width", True, True),
          ("2x2", "hash", True, True)]


@pytest.mark.parametrize("grid,layout,track_m,feedback", DYADIC)
def test_dyadic_sharded_step_is_the_dp_step(grid, layout, track_m,
                                            feedback):
    """β₁ = β₂ = 0.5 and integer rows: the sharded step equals the DP step
    at the same dp to the bit, every step."""
    dp, _ = GRIDS[grid]
    got, _ = _sharded_run(GRIDS[grid], layout, track_m=track_m,
                          feedback=feedback)
    want = _dp_run(dp, layout, track_m=track_m, feedback=feedback)
    for (t_sh, s_sh), (t_dp, s_dp) in zip(got, want):
        assert torch.equal(t_sh, t_dp)
        assert _states_equal(s_sh, s_dp)


def test_sharded_step_checks_its_axis_and_slab():
    mesh = ReplicaMesh((1, 2), timeout=MESH_TIMEOUT)
    _, step, opt = t_make(N, D, hparams=THP(**HP_KW), sketch_shards=SHARDS,
                          shard_axis=mesh.axis("model"), device="cpu")
    ids, rows = (_t(a) for a in _batch(0))
    with pytest.raises(ValueError, match="exactly that size"):
        step(_t(_table0()), opt.init(), ids, rows)
    _, step, opt = t_make(N, D, hparams=THP(**HP_KW), sketch_shards=2,
                          shard_axis=mesh.axis("model"), device="cpu")
    with pytest.raises(ValueError, match="slab"):
        step(_t(_table0()), opt.init(), ids, rows)
    with pytest.raises(ValueError, match="not sharded"):
        from repro_torch.core.transforms import scale_by_adam_rows_sharded
        m, v = t_stores(N, D, hparams=THP(**HP_KW))
        scale_by_adam_rows_sharded(m_store=m, v_store=v)


# ------------------------------------------------------------ the JAX steps
JAX_CASES = [("shard-only", "width", True, False),
             ("shard-only", "width", False, False),
             ("shard-only", "hash", True, False),
             ("shard-only", "hash", False, False),
             ("2x2", "width", True, False), ("2x2", "width", True, True),
             ("2x2", "hash", True, False), ("2x2", "hash", True, True)]


def _tag(grid, layout, track_m, feedback):
    return f"{grid}/{layout}/{int(track_m)}{int(feedback)}"


def _table0():
    rng = np.random.RandomState(0)
    return (rng.randn(N, D) / np.sqrt(D)).astype(np.float32)


def _jax_reference(path):
    """Every JAX sharded step result this module compares against, into
    one ``.npz``: per case the first step's emitted update (ids, rows) and
    the table and state after steps 1 and 3.  Runs in a subprocess under
    4 forced host devices."""
    from repro.core.optimizers import SketchHParams as JHP
    from repro.distributed import sharding as shd
    from repro.train.steps import make_sparse_embedding_step as j_make
    P = jax.sharding.PartitionSpec
    assert jax.device_count() == 4, jax.devices()
    out = {}
    for grid, layout, track_m, fb in JAX_CASES:
        tag = _tag(grid, layout, track_m, fb)
        dp, sh = GRIDS[grid]
        if dp > 1:
            mesh = shd.make_mesh_compat((dp, sh), ("data", "model"))
        else:
            mesh = shd.make_mesh_compat((sh,), ("model",))
        dp_axis = "data" if dp > 1 else None
        _, step, opt = j_make(N, D, lr=LR, hparams=JHP(**HP_KW),
                              track_first_moment=track_m, dp_axis=dp_axis,
                              mesh=mesh, error_feedback=fb,
                              sketch_shards=sh, shard_layout=layout)
        state = opt.init()
        sspecs = shd.sketch_state_specs(state, "model")
        dspec = P(dp_axis) if dp_axis is not None else P()

        def local(st, ids, rows):
            upd, _ = opt.update({"ids": ids, "rows": rows}, st)
            return upd["ids"], upd["rows"]

        first = jax.jit(shd.shard_map_unchecked(
            local, mesh=mesh, in_specs=(sspecs, dspec, dspec),
            out_specs=(P(), P())))
        step, table = jax.jit(step), jnp.asarray(_table0())
        for s in range(STEPS):
            ids, rows = _batch(100 + s, dyadic=False)
            if s == 0:
                uid, urow = first(state, jnp.asarray(ids), jnp.asarray(rows))
                out[f"{tag}/upd_ids"] = np.asarray(uid)
                out[f"{tag}/upd_rows"] = np.asarray(urow)
            table, state = step(table, state, jnp.asarray(ids),
                                jnp.asarray(rows))
            if s + 1 in (1, STEPS):
                out[f"{tag}/{s + 1}/table"] = np.asarray(table)
                for k in ("m", "v", "residual"):
                    if state.get(k) is not None:
                        out[f"{tag}/{s + 1}/{k}"] = np.asarray(state[k])
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_sharded") / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests")]))
    code = ("import sys, test_torch_sharded as t; "
            "t._jax_reference(sys.argv[1])")
    run = subprocess.run([sys.executable, "-c", code, str(path)], env=env,
                         capture_output=True, text=True,
                         timeout=REFERENCE_TIMEOUT)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
    with np.load(path) as z:
        return dict(z)


@pytest.mark.parametrize("grid,layout,track_m,feedback", JAX_CASES)
def test_sharded_step_matches_jax(jref, grid, layout, track_m, feedback):
    tag = _tag(grid, layout, track_m, feedback)
    runs, first = _sharded_run(GRIDS[grid], layout, track_m=track_m,
                               feedback=feedback, dyadic=False, b1=0.9,
                               b2=0.999, updates=True)
    for upd in first:
        np.testing.assert_array_equal(upd["ids"].numpy(),
                                      jref[f"{tag}/upd_ids"])
        np.testing.assert_allclose(upd["rows"].numpy(),
                                   jref[f"{tag}/upd_rows"], **TOL)
    for s in (1, STEPS):
        tol = TOL if s == 1 else TRAJ
        table, state = runs[s - 1]
        np.testing.assert_allclose(table.numpy(), jref[f"{tag}/{s}/table"],
                                   **tol)
        for k in ("m", "v", "residual"):
            assert (state[k] is None) == (f"{tag}/{s}/{k}" not in jref), k
            if state[k] is not None:
                np.testing.assert_allclose(state[k].numpy(),
                                           jref[f"{tag}/{s}/{k}"],
                                           err_msg=f"{tag}/{s}/{k}", **tol)
