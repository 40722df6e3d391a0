"""Collectives over a data-parallel axis: the port's counterpart of
``jax.lax.psum``/``pmean``/``all_gather`` over a named mesh axis.

A ``dp_axis`` of the port is an object with ``size``, ``rank``,
``psum(t)``, ``pmean(t)`` and ``all_gather(t)``, called from inside one
replica's step body.  Two kinds exist:

  * ``ProcessGroupAxis(group)`` - one replica a process, over
    ``torch.distributed`` (gloo on the CPU, NCCL on a card).  The step
    bodies of a ``dp_axis`` factory take the string name of the
    reference's mesh axis to mean the default process group
    (``as_axis``).
  * ``ReplicaGroup(R)`` - R replicas in R threads of one process, the
    counterpart of the reference's ``vmap(axis_name=...)``.  A barrier
    joins the replicas at each collective; ``psum`` adds their tensors in
    rank order, so every replica computes the same bits, and each replica
    gets its own copy of a result, since the steps write their state in
    place.  This is how R > 1 replicas run on one card: NCCL refuses two
    ranks on one device.

    group = ReplicaGroup(4)
    outs = group.run(step_fn, [(table[r], state[r], ids[r], rows[r])
                               for r in range(4)])

Sharded sketches add a second axis.  ``ReplicaMesh((dp, shards))`` runs
``dp·shards`` replicas in threads, rank ``d·shards + s`` at coordinates
(d, s); ``mesh.axis("data")`` and ``mesh.axis("model")`` are the two
axes, each joining only the replicas that share the other coordinate.
Over ``torch.distributed``, ``process_group_mesh`` makes the same two
axes from ``new_group`` sub-groups.  Both meshes carry ``axis_names``,
``shape``, ``coords``, ``axis(name)`` and ``barrier()``, which is what
the placement rules (``distributed.sharding``) and a checkpoint saved
from a mesh need.

Every collective returns a new tensor and leaves its input as it was.
The threads of a ``ReplicaGroup`` launch on the default CUDA stream,
which they share, so the barrier also orders on the card what one
replica reads of another's tensor before that replica writes it again.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import torch

from repro_torch.kernels.ref import true_div


class ProcessGroupAxis:
    """A data-parallel axis over the processes of a ``torch.distributed``
    group (None: the default group), read when a collective runs, so the
    axis can be made before ``init_process_group``."""

    def __init__(self, group=None):
        self.group = group

    @property
    def size(self) -> int:
        return torch.distributed.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return torch.distributed.get_rank(self.group)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        out = t.clone()                 # all_reduce overwrites its input
        torch.distributed.all_reduce(out, group=self.group)
        return out

    def pmean(self, t: torch.Tensor) -> torch.Tensor:
        return true_div(self.psum(t), float(self.size))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every replica's ``t`` in rank order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        torch.distributed.all_gather(parts, t, group=self.group)
        return torch.stack(parts)


class ReplicaGroup:
    """``size`` replicas of one step body in ``size`` threads of this
    process (see the module docstring).  ``timeout``: seconds a replica
    waits at a collective for the others before the group breaks (None:
    no limit)."""

    def __init__(self, size: int, timeout: Optional[float] = None):
        if size < 1:
            raise ValueError(f"a replica group needs size >= 1, got {size}")
        self.size = int(size)
        self._barrier = threading.Barrier(self.size, timeout=timeout)
        self._slots: List[Any] = [None] * self.size
        self._local = threading.local()

    @property
    def rank(self) -> int:
        rank = getattr(self._local, "rank", None)
        if rank is None:
            raise RuntimeError("a ReplicaGroup's collectives run inside "
                               "ReplicaGroup.run, in a replica's thread")
        return rank

    def _collect(self, t: torch.Tensor, combine: Callable) -> torch.Tensor:
        """``combine`` of every replica's ``t`` in rank order, computed by
        each replica for itself.  The second wait keeps each input
        untouched until every replica has read it."""
        self._slots[self.rank] = t
        self._barrier.wait()
        out = combine(list(self._slots))
        self._barrier.wait()
        return out

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        def add_in_rank_order(parts):
            out = parts[0].clone()
            for p in parts[1:]:
                out.add_(p)
            return out
        return self._collect(t, add_in_rank_order)

    def pmean(self, t: torch.Tensor) -> torch.Tensor:
        return true_div(self.psum(t), float(self.size))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every replica's ``t`` in rank order."""
        return self._collect(t, torch.stack)

    def run(self, fn: Callable, args: Sequence[Sequence[Any]]) -> list:
        """``fn(*args[r])`` in replica r's thread, for every r; returns the
        results in rank order.  A replica that fails breaks the barrier,
        so the others stop at their next collective, and ``run`` raises
        the first failure (the others' ``BrokenBarrierError`` only when
        nothing else failed)."""
        if len(args) != self.size:
            raise ValueError(f"{len(args)} argument tuples for "
                             f"{self.size} replicas")
        results: List[Any] = [None] * self.size
        errors: List[Optional[BaseException]] = [None] * self.size

        def body(rank: int) -> None:
            self._local.rank = rank
            done = False
            try:
                results[rank] = fn(*args[rank])
                done = True
            except Exception as e:      # handed to the caller's thread
                errors[rank] = e
            finally:
                if not done:
                    self._barrier.abort()

        threads = [threading.Thread(target=body, args=(r,),
                                    name=f"replica-{r}")
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._slots = [None] * self.size
        failed = [e for e in errors if e is not None]
        if failed:
            self._barrier.reset()
            raise next((e for e in failed if not isinstance(
                e, threading.BrokenBarrierError)), failed[0])
        return results


class _MeshAxis:
    """One axis of a ``ReplicaMesh``, as a replica sees it: ``size``,
    ``rank`` (the replica's coordinate on this axis) and the collectives,
    which join the replicas on the replica's line of this axis."""

    def __init__(self, mesh: "ReplicaMesh", dim: int):
        self._mesh, self._dim = mesh, dim

    @property
    def size(self) -> int:
        return self._mesh.shape[self._dim]

    @property
    def rank(self) -> int:
        return self._mesh.coords[self._dim]

    def _line(self) -> ReplicaGroup:
        return self._mesh._lines[self._dim][self._mesh.coords[1 - self._dim]]

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return self._line().psum(t)

    def pmean(self, t: torch.Tensor) -> torch.Tensor:
        return self._line().pmean(t)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return self._line().all_gather(t)


class ReplicaMesh:
    """A (dp, shards) grid of replicas in ``dp·shards`` threads of this
    process, in row-major rank order.  Each line of an axis is a
    ``ReplicaGroup``: a collective of ``axis(name)`` adds in rank order
    along that axis, among the replicas that share the other coordinate.
    ``timeout``: seconds a replica waits at a collective (None: no
    limit)."""

    def __init__(self, shape: Sequence[int],
                 axis_names: Sequence[str] = ("data", "model"),
                 timeout: Optional[float] = None):
        shape = tuple(int(n) for n in shape)
        if len(shape) != 2 or min(shape) < 1 or len(axis_names) != 2:
            raise ValueError(f"a replica mesh is a 2-D grid with two axis "
                             f"names, got {shape} and {tuple(axis_names)}")
        self.shape, self.axis_names = shape, tuple(axis_names)
        self.size = shape[0] * shape[1]
        self._all = ReplicaGroup(self.size, timeout=timeout)
        # _lines[dim][c]: the replicas whose other coordinate is c
        self._lines = [[ReplicaGroup(shape[dim], timeout=timeout)
                        for _ in range(shape[1 - dim])] for dim in (0, 1)]
        self._axes = [_MeshAxis(self, 0), _MeshAxis(self, 1)]

    @property
    def rank(self) -> int:
        return self._all.rank

    @property
    def coords(self) -> tuple:
        return divmod(self.rank, self.shape[1])

    def axis(self, name: str) -> _MeshAxis:
        """The axis called ``name`` (one of ``axis_names``)."""
        return self._axes[self.axis_names.index(name)]

    def barrier(self) -> None:
        """Wait until every replica of the grid has reached this call."""
        self._all._barrier.wait()

    def run(self, fn: Callable, args: Sequence[Sequence[Any]]) -> list:
        """``fn(*args[r])`` in replica r's thread, r in rank order; returns
        the results in rank order (``ReplicaGroup.run``).  A failing
        replica breaks every line's barrier too, so no replica waits on a
        line for it."""
        lines = [g for groups in self._lines for g in groups]

        def body(*a):
            d, s = self.coords
            self._lines[0][s]._local.rank = d
            self._lines[1][d]._local.rank = s
            try:
                return fn(*a)
            except Exception:
                for g in lines:
                    g._barrier.abort()
                raise

        try:
            return self._all.run(body, args)
        finally:
            for g in lines:
                g._slots = [None] * g.size
                if g._barrier.broken:
                    g._barrier.reset()


class GroupMesh(NamedTuple):
    """The (data, model) axes of a grid over the default process group, as
    ``process_group_mesh`` returns them; it unpacks as the two axes."""

    data: ProcessGroupAxis
    model: ProcessGroupAxis

    @property
    def axis_names(self) -> tuple:
        return ("data", "model")

    @property
    def shape(self) -> tuple:
        return (self.data.size, self.model.size)

    @property
    def coords(self) -> tuple:
        return (self.data.rank, self.model.rank)

    def axis(self, name: str) -> ProcessGroupAxis:
        return getattr(self, name)

    def barrier(self) -> None:
        torch.distributed.barrier()


def process_group_mesh(shape: Sequence[int]) -> GroupMesh:
    """The two axes of a (dp, shards) grid over the default process group,
    rank ``d·shards + s`` at (d, s): ``(data, model)`` as
    ``ProcessGroupAxis`` objects over ``new_group`` sub-groups.  Every
    process must call it, in the same order, after
    ``init_process_group``: each builds every sub-group."""
    dp, shards = (int(n) for n in shape)
    if dp * shards != torch.distributed.get_world_size():
        raise ValueError(f"a {dp} x {shards} grid needs {dp * shards} "
                         f"processes, the world has "
                         f"{torch.distributed.get_world_size()}")
    d, s = divmod(torch.distributed.get_rank(), shards)
    data = model = None
    for c in range(shards):         # the data axis: one group a column
        g = torch.distributed.new_group([r * shards + c for r in range(dp)])
        if c == s:
            data = g
    for r in range(dp):             # the model axis: one group a row
        g = torch.distributed.new_group([r * shards + c
                                         for c in range(shards)])
        if r == d:
            model = g
    return GroupMesh(ProcessGroupAxis(data), ProcessGroupAxis(model))


def mesh_axis(mesh, dp_axis):
    """The axis of a collectives ``mesh`` (``ReplicaMesh``, ``GroupMesh``)
    that ``dp_axis`` names, as the reference's ``shard_map`` runs over
    the mesh axis of that name; None stays None."""
    if dp_axis is None:
        return None
    names = getattr(mesh, "axis_names", ())
    if not isinstance(dp_axis, str) or not callable(
            getattr(mesh, "axis", None)) or dp_axis not in names:
        raise ValueError(
            f"mesh= needs a collectives mesh (ReplicaMesh, GroupMesh) with "
            f"an axis named by dp_axis; got dp_axis={dp_axis!r} and a "
            f"{type(mesh).__name__} with axes {tuple(names)} (or pass the "
            f"axis object itself as dp_axis, without mesh=)")
    return mesh.axis(dp_axis)


def as_axis(dp_axis):
    """The collectives object of a ``dp_axis`` or ``shard_axis`` argument:
    None stays None, a string (the reference's mesh-axis name) is the
    default process group, and an axis object (a ``ReplicaGroup``, a
    ``ReplicaMesh`` axis, a ``ProcessGroupAxis``) is itself."""
    if dp_axis is None:
        return None
    if isinstance(dp_axis, str):
        return ProcessGroupAxis()
    for name in ("psum", "pmean", "all_gather"):
        if not callable(getattr(dp_axis, name, None)):
            raise TypeError(f"dp_axis must be None, a string or an axis "
                            f"with size, rank, psum, pmean and all_gather; "
                            f"{type(dp_axis).__name__} has no {name!r}")
    return dp_axis
