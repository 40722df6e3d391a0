"""The ``sparse_rows`` kind: CS-Adam on one vocabulary table fed
``(ids, rows)`` gradients, the paper's own setting.

The launcher's ``sparse_embedding`` workload (``launch/train.py``)
without its probe: each step draws one pool batch of ``batch × seq_len``
zipf ids, forms ``rows = table[ids] - target[ids]`` and the loss
``mean(rows²)``, and hands ``(ids, rows)`` to the ``step_fn`` of
``train.steps.make_sparse_embedding_step`` (the dedup sum, the sketches'
hashing, B1 and the apply on a card), inside the span
``bench.sparse_update``.  The table and the target, (vocab, d_model)
float32, are drawn by the benchmark from the seed.
"""
from __future__ import annotations

from typing import List

import torch

from harness import weights, zipf
from reference import train as ref_train
from reference.hashing import Hash, leaf_seed, sketch_width

SPAN = "bench.sparse_update"


class Cell:
    unit = "rows"
    sketched = ("table",)

    def __init__(self, spec, seed: int, device, cells: str = "float32"):
        self.spec, self.seed, self.device = spec, int(seed), device
        self.n = int(spec.config["arch"]["vocab_size"])
        self.d = int(spec.config["arch"]["d_model"])
        t = spec.traffic
        self.k = int(t["batch"]) * int(t["seq_len"])
        self.lr = float(t["lr"])
        self.sk = t["sketch"]
        self.cells = cells
        self.work_per_step = self.k

    def _leaf(self, name: str) -> torch.Tensor:
        """The table or the target: normal draws over sqrt(d)."""
        return weights.make({"*": ["normal", self.d ** -0.5]}, name,
                            (self.n, self.d), self.seed, self.device)

    def build(self) -> None:
        from repro_torch.core.optimizers import SketchHParams
        from repro_torch.train.steps import make_sparse_embedding_step
        t = self.spec.traffic
        stream = zipf.stream(t, self.n, self.seed)
        self.host_pool = [stream.batch(i)["tokens"].reshape(-1)
                          for i in range(int(t["pool"]))]
        self.pool = [torch.from_numpy(x).to(self.device)
                     for x in self.host_pool]
        self.table = self._leaf("table")
        self.target = self._leaf("target")
        hp = SketchHParams(compression=float(self.sk["compression"]),
                           depth=int(self.sk["depth"]),
                           width_multiple=int(self.sk["width_multiple"]),
                           seed=int(self.sk["seed"]), dtype=self.cells)
        _init, self.step_fn, opt = make_sparse_embedding_step(
            self.n, self.d, lr=self.lr, hparams=hp, path=self.sk["path"],
            device=self.device)
        self.state = opt.init()

    def step(self, i: int) -> torch.Tensor:
        ids = self.pool[i % len(self.pool)]
        rows = self.table[ids] - self.target[ids]
        loss = torch.mean(torch.square(rows))
        with torch.profiler.record_function(SPAN):
            self.table, self.state = self.step_fn(self.table, self.state,
                                                  ids, rows)
        return loss

    def check_steps(self, n: int = 3) -> dict:
        losses, state1 = [], {}
        for i in range(n):
            losses.append(self.step(i))
            if i == 0:
                state1 = {f"{m}/table": ref_train.norm(self.state[m])
                          for m in ("m", "v") if self.state[m] is not None}
        change = {"table": ref_train.norm(self.table - self._leaf("table"))}
        return {"loss": [float(x) for x in losses], "state1": state1,
                "change": change}

    def state_bytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in self.state.values()
                   if isinstance(x, torch.Tensor) and x.device != torch.device("cpu"))

    def counts(self, steps: List[int]) -> dict:
        """The unique ids and touched sketch rows of the batches of
        ``steps``, by the frozen hash."""
        sk = self.sk
        width = sketch_width(self.n, float(sk["compression"]),
                             int(sk["depth"]), int(sk["width_multiple"]))
        h = Hash(leaf_seed(sk["path"], int(sk["seed"])), int(sk["depth"]),
                 width)
        rows = torch.arange(h.depth, device=self.device)[:, None] * width
        out = []
        for i in steps:
            uids = torch.unique(self.pool[i % len(self.pool)].long())
            touched = int(torch.unique(h.bucket(uids) + rows).numel())
            out.append({"k": self.k, "k_u": int(uids.numel()),
                        "rows_m": touched, "rows_v": touched})
        return {"d": self.d, "depth": h.depth, "batches": out}

    def free(self) -> None:
        for name in ("pool", "table", "target", "state", "step_fn"):
            self.__dict__.pop(name, None)

    def reference(self, steps: int = 3, half: bool = False) -> dict:
        batches = [torch.from_numpy(x).to(self.device)
                   for x in self.host_pool[:steps]]
        if half:
            batches = [b[: b.numel() // 2] for b in batches]
        sk = self.sk
        return ref_train.sparse_steps(
            self._leaf("table"), self._leaf("target"), batches, lr=self.lr,
            path=sk["path"], compression=float(sk["compression"]),
            depth=int(sk["depth"]), width_multiple=int(sk["width_multiple"]),
            seed=int(sk["seed"]), initial=lambda _p: self._leaf("table"))
