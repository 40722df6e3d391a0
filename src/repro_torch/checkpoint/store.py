"""Atomic, resumable checkpoints in the reference's on-disk format.

Counterpart of ``repro.checkpoint.store``.  A checkpoint either package
writes restores in the other:

    <dir>/step-<N>/   one ``leaf-%05d.npy`` per leaf, in flatten order,
                      and ``manifest.json``: ``step``, ``leaves`` (``path``,
                      ``file``, ``dtype``, ``shape``; ``file`` null for a
                      None leaf) and ``extra`` (e.g. ``plan`` and
                      ``store_tree``)
    <dir>/LATEST      the newest complete step

Leaf paths are the reference's strings: dict keys sorted and joined with
'/', list and tuple items by index, NamedTuple fields as ``.name`` (a
``Rank1Moment`` gives ``.../.r`` and ``.../.c``, a ``QuantState``
``.../.cells`` and ``.../.scales``), None a leaf with no file.

* **atomic**: written to ``tmp-<N>``, renamed to ``step-<N>``, then
  ``.LATEST.tmp`` renamed to ``LATEST``, then the oldest beyond ``keep``
  removed;
* **async**: ``save(async_=True)`` copies every leaf to host memory before
  it returns and writes on a thread.  The port's steps write tables and
  sketches in place, and a CPU tensor's ``.numpy()`` shares the buffer
  the next step writes, so the copy is what keeps that step out of the
  files;
* **bf16** leaves are written as raw 16-bit words in a 2-byte void
  ``.npy`` whose header is the reference's (``'<V2'``), so the file is
  byte-equal to the one ``np.save`` writes for an ``ml_dtypes`` array;
  the manifest says ``"bfloat16"`` and restore views the words as
  ``torch.bfloat16``;
* **fold**: ``fold_sketches`` halves every sketch leaf (Hokusai, paper
  §5), the state-side mirror of ``Plan.fold``;
* **placed**: ``shardings`` is a ``distributed.sharding.Placement`` (a
  spec tree, the mesh and this replica's coordinates).  ``save`` gathers
  each placed leaf over its axes first, so the files hold global leaves
  whatever the mesh; the replica at the mesh's origin alone writes and
  the others wait at the mesh's barrier.  ``restore`` loads each leaf as
  this replica's block of it, so a checkpoint restores onto another
  mesh.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

BF16 = "bfloat16"


def _is_named(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """(key string, child) pairs of a tree node in the reference's order,
    or None for a leaf (None included)."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_named(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs, the reference's ``_flatten`` strings."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out.extend(_flatten(child, f"{prefix}/{key}" if prefix else key))
    return out


def _rebuild(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if _is_named(like):
        return type(like)(*(_rebuild(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def _to_host(leaf) -> Optional[np.ndarray]:
    """A new host copy of one leaf (bf16 as its int16 words)."""
    if leaf is None:
        return None
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.array(leaf)


def _write_leaf(path: pathlib.Path, arr: np.ndarray, bf16: bool) -> None:
    if not bf16:
        np.save(path, arr)
        return
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": tuple(arr.shape)})
        f.write(arr.tobytes())


class _PlacedWrite:
    """What ``save(async_=True, shardings=)`` returns on every replica:
    ``join`` waits for the writer thread (the origin's; None elsewhere),
    then at the mesh's barrier, so no replica reads the checkpoint before
    it is complete.  Every replica must join."""

    def __init__(self, thread: Optional[threading.Thread], mesh):
        self.thread, self.mesh = thread, mesh

    def join(self, timeout: Optional[float] = None) -> None:
        if self.thread is not None:
            self.thread.join(timeout)
        self.mesh.barrier()


def _global_leaves(tree, shardings) -> List[Tuple[str, Any]]:
    """``tree``'s leaves, each placed one gathered into its global tensor
    (a collective every replica makes in the same order)."""
    from repro_torch.distributed.sharding import global_leaf
    out = []
    for (path, leaf), spec in zip(_flatten(tree),
                                  shardings.spec_leaves(tree)):
        if isinstance(leaf, torch.Tensor) and spec:
            leaf = global_leaf(leaf, spec, shardings.mesh)
        out.append((path, leaf))
    return out


def save(ckpt_dir, step: int, tree, *, async_: bool = False, keep: int = 3,
         extra: Optional[Dict[str, Any]] = None, shardings=None):
    """Write ``tree`` as step-<step>; returns the writer thread when
    ``async_``, after every leaf is copied to the host.  ``extra`` is
    JSON metadata for the manifest (``read_manifest``).

    ``shardings`` (a ``Placement`` of ``tree``): every replica of the
    mesh calls ``save`` with its blocks; the placed leaves are gathered
    into global ones, the replica at the mesh's origin writes them, and
    the others wait for it at the mesh's barrier.  With ``async_`` every
    replica gets a handle whose ``join`` does that wait."""
    if shardings is not None:
        flat = _global_leaves(tree, shardings)
        writer = None
        if shardings.is_writer():
            writer = save(ckpt_dir, step, _rebuild(
                tree, iter(leaf for _p, leaf in flat)), async_=async_,
                keep=keep, extra=extra)
        if async_:
            return _PlacedWrite(writer, shardings.mesh)
        shardings.mesh.barrier()
        return None
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    host = [(path, _to_host(leaf),
             isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16)
            for path, leaf in _flatten(tree)]

    def write():
        tmp = ckpt_dir / f"tmp-{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        manifest = {"step": step, "leaves": []}
        if extra is not None:
            manifest["extra"] = extra
        for i, (path, arr, bf16) in enumerate(host):
            entry = {"path": path, "file": None}
            if arr is not None:
                fname = f"leaf-{i:05d}.npy"
                _write_leaf(tmp / fname, arr, bf16)
                entry.update(file=fname, dtype=BF16 if bf16 else str(arr.dtype),
                             shape=list(arr.shape))
            manifest["leaves"].append(entry)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = ckpt_dir / f"step-{step}"
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        latest_tmp = ckpt_dir / ".LATEST.tmp"
        latest_tmp.write_text(str(step))
        os.rename(latest_tmp, ckpt_dir / "LATEST")
        _gc(ckpt_dir, keep)

    if async_:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def _gc(ckpt_dir: pathlib.Path, keep: int):
    steps = sorted(int(p.name.split("-", 1)[1])
                   for p in ckpt_dir.glob("step-*"))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(ckpt_dir / f"step-{s}", ignore_errors=True)


def latest_step(ckpt_dir) -> Optional[int]:
    f = pathlib.Path(ckpt_dir) / "LATEST"
    if not f.exists():
        return None
    step = int(f.read_text().strip())
    if not (pathlib.Path(ckpt_dir) / f"step-{step}").exists():
        return None
    return step


def _step_dir(ckpt_dir, step: Optional[int]) -> Tuple[int, pathlib.Path]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return step, ckpt_dir / f"step-{step}"


def read_manifest(ckpt_dir, step: Optional[int] = None) -> Dict[str, Any]:
    """The manifest of step-<step> (default: the latest), ``extra``
    included."""
    _, d = _step_dir(ckpt_dir, step)
    return json.loads((d / "manifest.json").read_text())


def _load_leaf(d: pathlib.Path, entry, path: str, device, block=None):
    arr = np.load(d / entry["file"])
    if path == "step" or path.endswith("/step"):
        # the host step counter, where the port keeps it
        return torch.tensor(int(arr), dtype=torch.int32)
    if entry.get("dtype") == BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if block is not None:
        t = block(t)
    return t.to(device)


def restore(ckpt_dir, tree_like, step: Optional[int] = None,
            device="cuda", shardings=None):
    """``(step, tree)``: ``tree_like``'s structure rebuilt from the
    checkpoint as NEW tensors on ``device`` (never written into
    ``tree_like``'s), leaves matched by path; a leaf the checkpoint lacks
    or saved as None comes back None, a ``step`` leaf as the host int32
    counter.  Shapes may differ from ``tree_like``'s (fold afterwards).
    ``shardings`` (a ``Placement`` of ``tree_like``): each placed leaf
    comes back as this replica's block of the saved global leaf."""
    from repro_torch.distributed.sharding import local_block
    step, d = _step_dir(ckpt_dir, step)
    manifest = json.loads((d / "manifest.json").read_text())
    by_path = {e["path"]: e for e in manifest["leaves"]}
    flat = _flatten(tree_like)
    specs = (shardings.spec_leaves(tree_like) if shardings is not None
             else [None] * len(flat))
    leaves = []
    for (path, _like), spec in zip(flat, specs):
        e = by_path.get(path)
        block = None
        if spec:
            def block(t, spec=spec):
                return local_block(t, spec, shardings.mesh,
                                   shardings.coords)
        leaves.append(None if e is None or e["file"] is None
                      else _load_leaf(d, e, path, device, block))
    return step, _rebuild(tree_like, iter(leaves))


def fold_sketches(state, is_sketch: Callable[[str, Any], bool]):
    """Hokusai fold of every sketch leaf: ``S[:, :w/2] + S[:, w/2:]``, as
    new tensors; ``is_sketch(path, leaf)`` decides."""
    out = []
    for path, leaf in _flatten(state):
        if leaf is not None and is_sketch(path, leaf):
            w = leaf.shape[1]
            if w % 2:
                raise ValueError(f"fold needs an even width at {path}")
            leaf = leaf[:, : w // 2] + leaf[:, w // 2:]
        out.append(leaf)
    return _rebuild(state, iter(out))


def default_is_sketch(path: str, leaf) -> bool:
    """Sketch leaves by name: rank 3, a small leading depth, under a
    sketched table (embedding, softmax, class head); not the stacked
    layer moments, which are rank 3 too."""
    return (hasattr(leaf, "ndim") and leaf.ndim == 3 and leaf.shape[0] <= 8
            and any(t in f"/{path}/" for t in
                    ("/tok_embed/", "/lm_head/", "/class_head/",
                     "/embed_out/", "/softmax/")))


def is_sketch_from_store_tree(store_tree) -> Callable[[str, Any], bool]:
    """The exact fold predicate of a rule-based ``StoreTree``: a leaf
    folds iff its moment path (``.../m/<param path>`` or ``.../v/<param
    path>``) is one the tree keeps in a count-sketch or count-min."""
    for name, d in (("default_m", store_tree.default_m),
                    ("default_v", store_tree.default_v)):
        if d is not None and d.kind in ("sketch", "countmin"):
            raise ValueError(
                f"cannot derive a fold predicate from a StoreTree whose "
                f"{name} is sketch-backed ({d.kind!r}): defaults apply to "
                f"unenumerated paths — use exact-path rules (e.g. "
                f"Plan.store_tree()) for foldable trees")
    sketchy = set()
    for p, m, v in store_tree.rules:
        if m is not None and m.kind in ("sketch", "countmin"):
            sketchy.add(f"m/{p}")
        if v is not None and v.kind in ("sketch", "countmin"):
            sketchy.add(f"v/{p}")

    def pred(path: str, leaf) -> bool:
        return any(path == s or path.endswith(f"/{s}") for s in sketchy)

    return pred


def fold_predicate_from_manifest(manifest: Dict[str, Any]
                                 ) -> Callable[[str, Any], bool]:
    """The exact ``is_sketch_from_store_tree`` predicate when the
    manifest's ``extra`` carries a ``store_tree`` (every planned run
    records one), else the ``default_is_sketch`` name rule."""
    extra = manifest.get("extra") or {}
    if extra.get("store_tree") is not None:
        from repro_torch.core.stores import StoreTree
        return is_sketch_from_store_tree(
            StoreTree.from_json(extra["store_tree"]))
    return default_is_sketch
