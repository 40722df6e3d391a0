"""The ordered table add on the card, modelled on the CPU.

``apply_sparse_updates`` must add every occurrence of an id in item
order from the table's own value, ((t+u1)+u2), as the reference's
``table.at[ids].add(rows)`` does; ``t+(u1+u2)`` rounds differently.  On a
CUDA f32 table ``dedup.index_add_rows`` gathers the touched rows into a
(k, d) slab (padding slots copy the last live slot), adds each id's rows
into its slot with B5's run scatter at depth 1 over dedup's own sort,
and copies the slots back with ``index_copy_``.  ``_ordered_model`` plays
that schedule out on the CPU with the same helpers and a loop over the
runs, and must equal ``index_add_`` to the bit under heavy duplicates,
which the reference's scatter-add equals too.  Updates whose later
occurrences carry zeros (backends ``xla`` and ``tiled``, and
``dense_rows_adam``) give the same bits through one ``index_add_``
(``first_only=True``).  The plain routes' scatter (``ops._ordered_scatter``)
is ``cs_update``, the plain ``cs_update_ref`` on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import optimizers as TO
from repro_torch.core import sketch as tcs
from repro_torch.core.stores import DenseStore
from repro_torch.kernels import dedup as dd
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

N, K, D = 2_000, 4_000, 24


def _inputs(seed, k=K):
    rng = np.random.RandomState(seed)
    table = rng.randn(N, D).astype(np.float32)
    ids = ((rng.zipf(1.1, k) - 1) % N).astype(np.int32)
    # magnitudes over six decades: the order of the adds shows in the bits
    rows = (rng.randn(k, D) * 10.0 ** rng.randint(-3, 3, (k, 1))
            ).astype(np.float32)
    return table, ids, rows


def _ordered_model(table, ids, rows):
    """The CUDA schedule of ``index_add_rows`` with plain operations:
    the slab, one run (a slot's sorted positions) added item by item
    from the slot's value, the copy back."""
    k = ids.shape[0]
    order, seg, unique_ids, inv, n_unique = dd._segments(ids)
    slot, target = dd.live_slots(unique_ids, n_unique)
    slab = table[target]
    starts = torch.full((k + 1,), k, dtype=torch.int64)
    starts.scatter_reduce_(0, seg, torch.arange(k), reduce="amin")
    for u in range(int(n_unique)):
        for pos in order[starts[u]:starts[u + 1]].tolist():
            slab[u] = slab[u] + rows[pos]
    return table.index_copy_(0, target, slab[slot])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ordered_model_equals_index_add(seed):
    table, ids, rows = _inputs(seed)
    t, i, r = (torch.from_numpy(x) for x in (table, ids, rows))
    want = t.clone().index_add_(0, i.long(), r)
    got = _ordered_model(t.clone(), i, r)
    assert torch.equal(got, want)
    # the reference's scatter-add adds in the same order
    np.testing.assert_array_equal(
        np.asarray(jnp.asarray(table).at[jnp.asarray(ids)].add(
            jnp.asarray(rows))), want.numpy())
    # summing the duplicates first rounds differently: the test has teeth
    db = dd.dedup_rows(i, r)
    pre = t.clone().index_add_(0, db.unique_ids[:int(db.n_unique)].long(),
                               db.rows[:int(db.n_unique)])
    assert not torch.equal(pre, want)
    assert torch.equal(dd.index_add_rows(t.clone(), i, r), want)


def test_ordered_model_on_few_ids():
    """One id only, every slot after it padding, and no duplicates."""
    table, _, rows = _inputs(3, k=50)
    t, r = torch.from_numpy(table), torch.from_numpy(rows)
    for ids in (np.full(50, 7, np.int32), np.arange(50, dtype=np.int32)):
        i = torch.from_numpy(ids)
        assert torch.equal(_ordered_model(t.clone(), i, r),
                           t.clone().index_add_(0, i.long(), r))


@pytest.mark.parametrize("backend", ["xla", "tiled", "ref", "stream"])
def test_first_only_updates_need_no_order(backend):
    """``xla``/``tiled`` updates carry zeros at later occurrences: one
    ``index_add_`` gives the ordered add's bits.  Every backend's updates
    through the ordered add equal ``index_add_`` on the CPU."""
    table, ids, rows = _inputs(4)
    hp = TO.SketchHParams(compression=4.0, width_multiple=16,
                          backend=backend)
    opt = TO.sparse_rows_adam(1e-2, shape=(N, D), hparams=hp, device="cpu")
    state = opt.init()
    g = {"ids": torch.from_numpy(ids), "rows": torch.from_numpy(rows)}
    upd, state = opt.update(g, state)
    t = torch.from_numpy(table)
    ordered = TO.apply_sparse_updates(t.clone(), upd)
    assert torch.equal(ordered, t.clone().index_add_(0, g["ids"].long(),
                                                     upd["rows"]))
    first = TO.first_occurrence_only(hp, None, "cpu")
    assert first == (backend in ("xla", "tiled"))
    if first:
        assert torch.equal(TO.apply_sparse_updates(t.clone(), upd,
                                                   first_only=True), ordered)
        later = np.ones(len(ids), bool)
        later[np.unique(ids, return_index=True)[1]] = False
        assert not upd["rows"][torch.from_numpy(later)].any()


def test_dense_store_accumulates_1d_state_in_order():
    table, ids, rows = _inputs(5)
    store = DenseStore().bind("s", (N,), torch.float32)
    state = torch.from_numpy(table[:, 0].copy())
    i, r = torch.from_numpy(ids), torch.from_numpy(rows[:, 0].copy())
    want = state.clone().index_add_(0, i.long(), r * 0.5)
    got = store.accumulate(state.clone(), r, i, scale=0.5)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dense", [False, True])
def test_plain_route_scatter_is_the_plain_add(dense):
    spec = tcs.SketchSpec(depth=3, width=64, dim=D, signed=True, seed=2)
    table, ids, rows = _inputs(6, k=N)
    i = None if dense else torch.from_numpy(ids)
    x = torch.from_numpy(rows)
    b, s = ops._ema_addressing(spec, i, N, x.device)
    S = torch.from_numpy(np.random.RandomState(7).randn(*spec.shape)
                         .astype(np.float32))
    want = ref.cs_update_ref(S.clone(), b, s, x)
    got = ops._ordered_scatter(spec, i, x)(S.clone(), b, s, x)
    assert torch.equal(got, want)
