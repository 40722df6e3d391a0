"""The token stream of every cell: a frozen copy of ``ZipfLM``.

Copied from ``src/repro_torch/data/pipeline.py`` at commit 5fd53a1
(itself a copy of the JAX package's numpy code), so that later changes
to the port cannot move the traffic.  Tokens follow a Zipf(alpha)
marginal over the vocabulary; with probability ``bigram_p`` the next
token is ``perm[prev]`` for a hidden permutation; the hot set re-rolls
every ``drift_every`` steps.  ``batch(step)`` is a pure function of
``(cfg, step)``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class ZipfLMConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    alpha: float = 1.1
    bigram_p: float = 0.5
    drift_every: int = 500
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


class ZipfLM:
    """Stateless stream: ``batch(step)`` is deterministic in (cfg, step)."""

    def __init__(self, cfg: ZipfLMConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.alpha)
        self._cdf = np.cumsum(p / p.sum())

    def _perm(self, epoch: int) -> np.ndarray:
        rng = np.random.RandomState(
            (self.cfg.seed * 1_000_003 + epoch * 7919) % (2**31 - 1))
        return rng.permutation(self.cfg.vocab_size)

    def _zipf_sample(self, rng: np.random.RandomState, shape,
                     perm: np.ndarray) -> np.ndarray:
        u = rng.random_sample(shape)
        ranks = np.searchsorted(self._cdf, u)
        return perm[np.minimum(ranks, self.cfg.vocab_size - 1)]

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        epoch = step // cfg.drift_every
        perm = self._perm(epoch)                      # rank -> token id
        bigram = self._perm(epoch + 10_000)           # token -> next token
        rng = np.random.RandomState(
            (cfg.seed * 2_000_003 + step * 104_729 + cfg.host_id * 31)
            % (2**31 - 1))
        b, s = cfg.host_batch, cfg.seq_len
        toks = np.empty((b, s + 1), dtype=np.int64)
        toks[:, 0] = self._zipf_sample(rng, (b,), perm)
        fresh = self._zipf_sample(rng, (b, s), perm)
        use_bigram = rng.random_sample((b, s)) < cfg.bigram_p
        for t in range(s):
            nxt = np.where(use_bigram[:, t], bigram[toks[:, t]], fresh[:, t])
            toks[:, t + 1] = nxt
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def stream(traffic: dict, vocab: int, seed: int) -> ZipfLM:
    """The stream a traffic mix's parameters describe, over ``vocab``."""
    return ZipfLM(ZipfLMConfig(
        vocab_size=int(vocab), seq_len=int(traffic["seq_len"]),
        global_batch=int(traffic["batch"]),
        alpha=float(traffic.get("alpha", 1.1)),
        bigram_p=float(traffic.get("bigram_p", 0.5)),
        drift_every=int(traffic.get("drift_every", 500)), seed=int(seed)))
