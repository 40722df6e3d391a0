"""Parity of the port's addressing and sketch core with the JAX reference.

Integers (buckets, signs, seeds, widths) must match to the bit.  The f32
sketch ops use the same operations in the same order, so they match to
the bit on the CPU too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro.core import sketch as jcs
from repro.core import stores as jstores
from repro_torch.core import hashing as th
from repro_torch.core import sketch as tcs
from repro_torch.core import stores as tstores


def _ids(seed, k=257, hi=1 << 20):
    """Random ids with the dedup fill id -1, 0 and the int32 maximum."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, hi, k).astype(np.int32)
    ids[:3] = (-1, 0, np.iinfo(np.int32).max)
    return ids


FAMILIES = [
    dict(seed=7, depth=3, width=4096),
    dict(seed=123456789, depth=1, width=256),
    dict(seed=3, depth=5, width=1000),
    dict(seed=11, depth=3, width=512, identity=True),
    dict(seed=5, depth=3, width=4096, shards=4, layout="hash"),
    dict(seed=5, depth=3, width=4096, shards=4, layout="width"),
]


@pytest.mark.parametrize("fam_kw", FAMILIES,
                         ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_buckets_and_signs_bit_equal(fam_kw):
    ids = _ids(fam_kw["seed"])
    jf, tf = jh.HashFamily(**fam_kw), th.HashFamily(**fam_kw)
    tids = torch.from_numpy(ids)
    np.testing.assert_array_equal(np.asarray(jf.bucket(jnp.asarray(ids))),
                                  tf.bucket(tids).numpy())
    np.testing.assert_array_equal(np.asarray(jf.sign(jnp.asarray(ids))),
                                  tf.sign(tids).numpy())
    assert tf.bucket(tids).dtype == torch.int32
    if fam_kw.get("layout") == "hash" or fam_kw.get("identity"):
        np.testing.assert_array_equal(np.asarray(jf.owner(jnp.asarray(ids))),
                                      tf.owner(tids).numpy())


def test_mul32_wraps_like_uint32():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    c = rng.randint(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    want = x * c                                   # numpy uint32 wraps
    got = th._mul32(torch.from_numpy(x.astype(np.int64)),
                    torch.from_numpy(c.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("path,base", [("sparse_embedding", 0),
                                       ("params/embed", 3), ("", 12345)])
def test_leaf_seed_matches(path, base):
    assert tstores.leaf_seed(path, base) == jstores.leaf_seed(path, base)


@pytest.mark.parametrize("shape,kw", [
    ((151936, 896), {}),
    ((1024, 128), dict(compression=4.0, width_multiple=16)),
    ((100, 8), dict(depth=1)),
    ((64, 128), dict(identity=True)),
    ((4096, 64), dict(compression=16.0, width_multiple=64, depth=5)),
])
def test_for_param_widths_match(shape, kw):
    j = jcs.for_param(shape, **kw)
    t = tcs.for_param(shape, **kw)
    assert (t.depth, t.width, t.dim, t.identity) == \
        (j.depth, j.width, j.dim, j.identity)
    assert t.nbytes() == j.nbytes()


def test_low_precision_cells_raise():
    with pytest.raises(NotImplementedError, match="A7"):
        tcs.SketchSpec(depth=3, width=16, dim=4, dtype="bfloat16")


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("depth", [1, 3])
def test_query_update_bit_equal(signed, depth):
    """update (colliding ids accumulate in batch order) then query."""
    spec_kw = dict(depth=depth, width=32, dim=16, signed=signed, seed=9)
    js, ts = jcs.SketchSpec(**spec_kw), tcs.SketchSpec(**spec_kw)
    rng = np.random.RandomState(depth)
    S = rng.randn(depth, 32, 16).astype(np.float32)
    ids = rng.randint(0, 200, 48).astype(np.int32)
    delta = rng.randn(48, 16).astype(np.float32)
    j_est = jcs.query(js, jnp.asarray(S), jnp.asarray(ids))
    t_est = tcs.query(ts, torch.from_numpy(S.copy()), torch.from_numpy(ids))
    np.testing.assert_array_equal(np.asarray(j_est), t_est.numpy())
    jS, jq = jcs.update_and_query(js, jnp.asarray(S), jnp.asarray(ids),
                                  jnp.asarray(delta))
    tS, tq = tcs.update_and_query(ts, torch.from_numpy(S.copy()),
                                  torch.from_numpy(ids),
                                  torch.from_numpy(delta))
    np.testing.assert_array_equal(np.asarray(jS), tS.numpy())
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())


@pytest.mark.parametrize("beta,scale", [(0.9, 0.1), (0.999, 1.0 - 0.999),
                                        (1.0, 0.5), (0.9, 1.0)])
def test_ema_delta_forms_bit_equal(beta, scale):
    rng = np.random.RandomState(1)
    est = rng.randn(8, 16).astype(np.float32)
    x = rng.randn(8, 16).astype(np.float32)
    want = jcs.ema_delta(jnp.asarray(est), jnp.asarray(x), beta, scale)
    got = tcs.ema_delta(torch.from_numpy(est), torch.from_numpy(x), beta,
                        scale)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_store_bind_read_accumulate_match():
    """Bound stores derive the same spec; read/accumulate/decay agree."""
    shape = (512, 16)
    for jcls, tcls in ((jstores.CountSketchStore, tstores.CountSketchStore),
                       (jstores.CountMinStore, tstores.CountMinStore)):
        js = jcls(compression=4.0, width_multiple=16).bind(
            "tab", shape, jnp.float32)
        ts = tcls(compression=4.0, width_multiple=16).bind("tab", shape)
        assert ts.spec.shape == js.spec.shape and ts.spec.seed == js.spec.seed
        assert ts.bytes() == js.bytes()
        rng = np.random.RandomState(2)
        rows = rng.randint(0, 512, 20).astype(np.int32)
        delta = rng.randn(20, 16).astype(np.float32)
        jstate = js.accumulate(js.init(), jnp.asarray(delta),
                               jnp.asarray(rows), scale=0.5)
        tstate = ts.accumulate(ts.init("cpu"), torch.from_numpy(delta),
                               torch.from_numpy(rows), scale=0.5)
        jstate, tstate = js.decay(jstate, 0.3), ts.decay(tstate, 0.3)
        np.testing.assert_array_equal(np.asarray(jstate), tstate.numpy())
        np.testing.assert_array_equal(
            np.asarray(js.read(jstate, jnp.asarray(rows))),
            ts.read(tstate, torch.from_numpy(rows)).numpy())


def test_store_tree_resolves_rules_then_defaults():
    m = tstores.CountSketchStore(compression=4.0, width_multiple=16)
    v = tstores.CountMinStore(compression=4.0, width_multiple=16)
    tree = tstores.StoreTree(rules=(("emb", m, v),), default_v=v)
    rm, rv = tree.resolve("emb", (256, 8))
    assert rm.spec.signed and not rv.spec.signed and rm.shape == (256, 8)
    dm, dv = tree.resolve("other", (256, 8))
    assert dm is None and dv.spec.seed == tstores.leaf_seed("other", 0)
