"""The ``lm_train`` kind: whole LM training steps.

``train.steps.make_train_step(cfg, optimizer=..., lr=...,
kernel_backend=...)``'s ``step_fn`` at the launcher's defaults (grad clip
1.0, remat on): with ``cs_adam`` and the backend ``auto`` the vocabulary
tables' moments live in sketches updated by B3, every other leaf takes
dense Adam.  Each step takes one pool batch of ``batch × seq_len`` zipf
tokens.  The weights are drawn by the benchmark from the seed, leaf by
leaf, by the configuration's ``init`` rules; the plain reference is the
module that the configuration's ``reference`` names.
"""
from __future__ import annotations

import dataclasses
import importlib
import sys
import time
from typing import List

import torch

from harness import arith, weights, zipf
from reference import train as ref_train
from reference.hashing import sketch_width


def arch_config(config: dict):
    """The port's ``ArchConfig`` of a configuration file's ``arch``."""
    from repro_torch.models.config import ArchConfig
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: v for k, v in config["arch"].items()
                         if k in fields})


class Cell:
    unit = "tokens"

    def __init__(self, spec, seed: int, device):
        self.spec, self.seed, self.device = spec, int(seed), device
        self.arch = dict(spec.config["arch"])
        self.sketched = tuple(spec.config["sketched"])
        t = spec.traffic
        self.b, self.s = int(t["batch"]), int(t["seq_len"])
        self.work_per_step = self.b * self.s
        self.rules = spec.config["init"]

    def build(self) -> None:
        from repro_torch.train.steps import make_train_step
        t = self.spec.traffic
        marks = [time.perf_counter()]
        cfg = arch_config(self.spec.config)
        self.ts = make_train_step(
            cfg, optimizer=t["optimizer"], lr=float(t["lr"]),
            grad_clip=float(t["grad_clip"]), remat=bool(t["remat"]),
            kernel_backend=t["kernel_backend"], device=self.device)
        self.shapes = {p: tuple(x.shape) for p, x in
                       weights.flatten(self.ts.params_shape()).items()}
        marks.append(time.perf_counter())
        self.params = weights.unflatten(weights.make_all(
            self.rules, self.shapes, self.seed, self.device))
        marks.append(time.perf_counter())
        self.opt_state = self.ts.optimizer.init(self.params)
        marks.append(time.perf_counter())
        stream = zipf.stream(t, self.arch["vocab_size"], self.seed)
        self.host_pool = [stream.batch(i) for i in range(int(t["pool"]))]
        self.pool = [{k: torch.from_numpy(v).to(self.device)
                      for k, v in b.items()} for b in self.host_pool]
        marks.append(time.perf_counter())
        print("[bench] build: " + ", ".join(
            f"{n} {b - a:.3f} s" for n, a, b in zip(
                ("step and shapes", "weights", "optimizer state", "pool"),
                marks, marks[1:])), file=sys.stderr)

    def step(self, i: int) -> torch.Tensor:
        self.params, self.opt_state, metrics = self.ts.step_fn(
            self.params, self.opt_state, self.pool[i % len(self.pool)])
        return metrics["loss"]

    def _state_tensors(self):
        out = {}
        for m in ("m", "v"):
            for p, x in weights.flatten(self.opt_state[m]).items():
                out[f"{m}/{p}"] = x
        return out

    def check_steps(self, n: int = 3) -> dict:
        losses, state1 = [], {}
        for i in range(n):
            losses.append(self.step(i))
            if i == 0:
                state1 = {k: ref_train.norm(x)
                          for k, x in self._state_tensors().items()}
        change = {p: ref_train.norm(x - weights.make(
                      self.rules, p, x.shape, self.seed, self.device))
                  for p, x in weights.flatten(self.params).items()}
        return {"loss": [float(x) for x in losses], "state1": state1,
                "change": change}

    def state_bytes(self) -> int:
        return sum(x.numel() * x.element_size()
                   for x in self._state_tensors().values())

    def counts(self, steps: List[int]) -> dict:
        """Model FLOPs a step and B3's calls a step (one a moment of each
        sketched table)."""
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
        return {"flops_per_step": arith.lm_flops_per_token(a, self.s)
                * self.work_per_step, "b3_calls": calls}

    def free(self) -> None:
        for name in ("pool", "params", "opt_state", "ts"):
            self.__dict__.pop(name, None)

    def reference(self, steps: int = 3, half: bool = False,
                  precision: str = "f32") -> dict:
        model = importlib.import_module(
            "reference." + self.spec.config["reference"])
        t = self.spec.traffic
        batches = []
        for hb in self.host_pool[:steps]:
            tok, lab = (torch.from_numpy(hb[k]).to(self.device)
                        for k in ("tokens", "labels"))
            if half:
                tok, lab = tok[: self.b // 2], lab[: self.b // 2]
            batches.append((tok, lab))
        params = weights.make_all(self.rules, self.shapes, self.seed,
                                  self.device)
        return ref_train.lm_steps(
            model, self.arch, params, batches, lr=float(t["lr"]),
            grad_clip=float(t["grad_clip"]),
            sketched=self.spec.config["sketched"],
            compression=self.arch.get("sketch_compression", 5.0),
            depth=self.arch.get("sketch_depth", 3),
            initial=lambda p: weights.make(self.rules, p, self.shapes[p],
                                           self.seed, self.device),
            precision=precision)
