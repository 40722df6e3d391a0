"""The comparison that decides ``correct`` for a training cell.

The program's first three steps run in set-up, through the window's own
call, and the plain reference follows them from the same starting values
and batches.  Eight numbers compare them; a cell's limits file
(``bench/limits/<cell>.json``) gives a limit to those it holds, and
``correct`` needs each of them within its limit:

* ``loss_gap``: the largest relative gap between the two losses of a
  step, over the three steps;
* ``loss1_gap``: the same of the first step alone, whose loss no update
  has touched yet;
* ``state_gap``: over the first-moment tensors after step 1, (1-b1)
  times the first gradient as the optimizer got it (dense, or its
  Count-Sketch), the worst gap between the program's norm and the
  reference's, over the reference's norm of that tensor or of the median
  tensor, whichever is larger;
* ``change_gap``: the same over each parameter's change across the three
  steps, leaving out the parameters whose first gradient in the
  reference is under a thousandth of the median parameter's (a leaf
  that no loss reaches moves under Adam by round-off alone).

The same worst gaps, taken over one group of leaves (the median that
floors the scale is the group's own):

* ``state_layers_gap``: the first moment after step 1 over the leaves
  that dense Adam keeps, the model's layers;
* ``moment2_layers_gap``: the second moment after step 1, (1-b2) times
  the first gradient squared, over the same leaves: the square reads a
  coarser rounding of the gradient as a bias of its norm, where the
  first moment's norm cancels it to first order;
* ``state_tables_gap``: the first moment after step 1 over the sketched
  tables, their Count-Sketches;
* ``change_layers_gap``: each layer leaf's change across the steps,
  leaving out the same negligible leaves as ``change_gap``.

And the layers' second moment once more, with the program's norms first
divided by their median ratio to the reference's, so that a factor
common to every layer leaf drops out, such as the clip's scale, which
the global norm over every leaf, the tables' too, sets for all layers
alike.  What is left is how the gradient spreads over the leaves, which
a coarser precision or a lost part of the batch changes leaf by leaf:

* ``moment2_layers_shape_gap``.

A group with no leaf reads None.  A gap that is not a number fails.  A
tensor the program lacks, or a group it leaves at zero, reads 1.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Optional, Sequence, Tuple

NUMBERS = ("loss_gap", "loss1_gap", "state_gap", "change_gap",
           "state_layers_gap", "moment2_layers_gap", "state_tables_gap",
           "change_layers_gap", "moment2_layers_shape_gap")
NEGLIGIBLE_GRAD = 1e-3


def _rel(p: float, r: float, scale: float) -> float:
    if scale == 0.0:
        return 0.0 if p == r else math.inf
    return abs(p - r) / scale


def _most(gaps) -> float:
    """The largest gap; a gap that is not a number is the result, wherever
    it stands."""
    gaps = list(gaps)
    return math.nan if any(map(math.isnan, gaps)) else max(gaps, default=0.0)


def _worst(prog: Dict[str, float], ref: Dict[str, float],
           keys, look: Dict[str, float] = None,
           shape: bool = False) -> Optional[float]:
    """The worst gap over ``keys``; with ``shape``, the program's norms
    are first divided by their median ratio to the reference's."""
    if not keys:
        return None
    if any(k not in prog for k in keys):
        return 1.0
    common = 1.0
    if shape:
        ratios = [prog[k] / ref[k] for k in keys if ref[k] > 0]
        if any(map(math.isnan, ratios)):
            return math.nan
        common = statistics.median(ratios) if ratios else 0.0
        if common == 0.0:
            return 1.0
    groups: Dict[str, list] = {}
    for k in keys:
        groups.setdefault(k.split("/", 1)[0], []).append(ref[k])
    med = {g: statistics.median(v) for g, v in groups.items()}
    out = {}
    for k in keys:
        scale = max(ref[k], med[k.split("/", 1)[0]])
        out[k] = _rel(prog[k] / common, ref[k], scale)
    if look is not None:
        look.update(out)
    return _most(out.values())


def gaps(prog: dict, ref: dict, look: Dict[str, float] = None,
         sketched: Sequence[str] = ()) -> Dict[str, Optional[float]]:
    """The numbers; ``sketched`` names the leaves whose moments live in
    sketches.  ``look``, when given, receives every tensor's gap
    (``m/...`` after step 1, ``v/...`` of the layers, ``p/...``
    changes)."""
    losses = [_rel(p, r, abs(r)) for p, r in zip(prog["loss"], ref["loss"])]
    if len(prog["loss"]) != len(ref["loss"]):
        losses.append(math.inf)
    s_p, s_r = prog["state1"], ref["state1"]

    def state(moment, tables=None):
        return [k for k in sorted(s_r) if k.startswith(moment + "/") and (
            tables is None or (k.split("/", 1)[1] in sketched) == tables)]

    g = ref["grad1"]
    floor = NEGLIGIBLE_GRAD * statistics.median(g.values()) if g else 0.0
    moved = [k for k in sorted(ref["change"]) if g.get(k, 1.0) >= floor]
    c_p = {"p/" + k: v for k, v in prog["change"].items()}
    c_r = {"p/" + k: ref["change"][k] for k in moved}
    layers = ["p/" + k for k in moved if k not in sketched]
    return {"loss_gap": _most(losses), "loss1_gap": losses[0],
            "state_gap": _worst(s_p, s_r, state("m"), look),
            "change_gap": _worst(c_p, c_r, list(c_r), look),
            "state_layers_gap": _worst(s_p, s_r, state("m", False)),
            "moment2_layers_gap": _worst(s_p, s_r, state("v", False), look),
            "state_tables_gap": _worst(s_p, s_r, state("m", True)),
            "change_layers_gap": _worst(c_p, c_r, layers),
            "moment2_layers_shape_gap": _worst(s_p, s_r, state("v", False),
                                               shape=True)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, dict]]:
    """``(correct, {number: {"value", "limit"}})``: every number with
    its limit (None where the cell holds it to none); correct when the
    cell holds at least one and each held number is within its limit."""
    table = {k: {"value": numbers[k], "limit": limits.get(k)}
             for k in NUMBERS}
    held = [k for k in NUMBERS if limits.get(k) is not None]
    ok = bool(held) and all(
        numbers[k] is not None and math.isfinite(numbers[k])
        and numbers[k] <= limits[k] for k in held)
    return ok, table
