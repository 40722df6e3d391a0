"""The ``lm_train_hybrid_moe`` kind: ``lm_train``'s whole LM training
steps, for the ``hybrid_moe`` family (GraniteMoeHybrid) whose model
FLOPs the frozen ``harness.arith`` does not count.

``counts`` takes the FLOPs from ``harness.arith_hybrid_moe`` and adds
``expert_rows``, the assignments that the held experts computed in the
traced steps (their forward and remat's recompute), from the program's
device counter ``models.moe.expert_rows``.  The runner names the traced
steps only after they ran, so ``step`` keeps a device copy of that
counter before each of the last ``KEPT`` steps (no host sync), and
``counts`` subtracts the one taken before the first traced step.
"""
from __future__ import annotations

from typing import List

from harness import arith_hybrid_moe
from harness.kinds import lm_train
from reference.hashing import sketch_width

KEPT = 8


class Cell(lm_train.Cell):

    def __init__(self, spec, seed: int, device, **kw):
        super().__init__(spec, seed, device, **kw)
        self._before = {}

    def _rows(self):
        from repro_torch.models import moe
        return moe.expert_rows(self.device)

    def step(self, i: int):
        self._before[i] = self._rows().clone()
        self._before.pop(i - KEPT, None)
        return super().step(i)

    def counts(self, steps: List[int]) -> dict:
        """Model FLOPs a step, B3's calls a step (one a moment of each
        sketched table) and the traced steps' expert rows."""
        a = self.arch
        calls = []
        for path in self.spec.config["sketched"]:
            n, d = self.shapes[path]
            width = sketch_width(n, a.get("sketch_compression", 5.0),
                                 a.get("sketch_depth", 3))
            for signed in (True, False):
                calls.append({"n": n, "d": d,
                              "depth": a.get("sketch_depth", 3),
                              "width": width, "signed": signed})
        out = {"flops_per_step": arith_hybrid_moe.lm_flops_per_token(
                   a, self.s) * self.work_per_step, "b3_calls": calls}
        if steps and steps[0] in self._before:
            out["expert_rows"] = int(self._rows() - self._before[steps[0]])
            out["expert_flops_per_row"] = \
                arith_hybrid_moe.expert_flops_per_row(a)
        return out
