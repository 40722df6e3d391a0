"""Deterministic synthetic data: zipf-distributed token and
extreme-classification streams, in numpy.

Counterpart of ``repro.data.pipeline``, a copy of its numpy code, so the
port gives the same integers for the same ``(cfg, step)`` without
importing the JAX package.

  * ``ZipfLM``: tokens follow a Zipf(alpha) marginal over the vocabulary;
    a hidden permutation bigram makes the stream learnable (with prob
    ``bigram_p`` the next token is ``perm[prev]``); the hot-token set
    drifts every ``drift_every`` steps;
  * ``ExtremeStream``: ``nnz`` zipf features per example, the label a
    hash of the most frequent (minimum-rank) feature
    (``class_of_features``), and ``n_negatives`` shared candidate classes
    drawn from the same head-heavy marginal;
  * batches are a pure function of ``(seed, step, host)``: the streams
    are stateless and resumable.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class ZipfLMConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    alpha: float = 1.1            # zipf exponent (word frequencies ≈ 1.0-1.2)
    bigram_p: float = 0.5         # learnable-structure probability
    drift_every: int = 500        # steps between hot-set re-rolls
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

    def batches(self, start_step: int = 0):
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


def classification_batch(step: int, *, n_features: int, n_classes: int,
                         batch: int, nnz: int = 30, alpha: float = 1.1,
                         seed: int = 0):
    """Extreme-classification stream (paper §7.3 protocol): ``nnz`` sparse
    zipf features per example; the class is a hash of the feature set (so
    it is learnable and ~zipf over classes)."""
    rng = np.random.RandomState((seed * 99_991 + step * 7) % (2**31 - 1))
    ranks = np.arange(1, n_features + 1, dtype=np.float64) ** (-alpha)
    cdf = np.cumsum(ranks / ranks.sum())
    u = rng.random_sample((batch, nnz))
    feats = np.minimum(np.searchsorted(cdf, u), n_features - 1)
    # deterministic learnable mapping: the class is a hash of the
    # minimum-rank (most frequent) feature in the example — learnable by
    # an embedding-sum model, and head-heavy over classes because the min
    # of nnz zipf draws concentrates on the first ranks (the paper's
    # query->product shape; the class-frequency shape is pinned in
    # tests/test_extreme.py)
    cls = class_of_features(feats, n_classes)
    return {"features": feats.astype(np.int32),
            "labels": cls.astype(np.int32)}


def class_of_features(feats: np.ndarray, n_classes: int) -> np.ndarray:
    """The stream's label rule: hash of the per-example minimum-rank
    (= most frequent, ids are rank-ordered) feature."""
    return ((np.min(feats, axis=-1).astype(np.int64) * 2_654_435_761)
            % n_classes).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class ExtremeConfig:
    """The extreme-classification stream (paper §7.3 at table scale):
    ``nnz`` zipf features per example, labels via ``class_of_features``,
    plus ``n_negatives`` shared sampled-softmax candidate classes drawn
    from the same head-heavy label marginal — so candidate ids collide
    heavily with the batch labels and each other, exercising the dedup
    pre-pass exactly as production traffic would."""

    n_features: int
    n_classes: int
    batch: int
    nnz: int = 16
    n_negatives: int = 1024
    alpha: float = 1.05
    seed: int = 0


class ExtremeStream:
    """Stateless stream: ``batch(step)`` is deterministic in (cfg, step).

    Returns ``features`` (B, nnz) int32 zipf feature ids, ``labels`` (B,)
    int32 class ids, ``negatives`` (n_negatives,) int32 class ids.  Class
    ids live in [0, n_classes); MACH consumers map them through a
    meta-class hash on the host (``core.hashing.mach_class_hash``)."""

    def __init__(self, cfg: ExtremeConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.n_features + 1, dtype=np.float64)
        p = ranks ** (-cfg.alpha)
        self._cdf = np.cumsum(p / p.sum())

    def _zipf_feats(self, rng: np.random.RandomState, shape) -> np.ndarray:
        u = rng.random_sample(shape)
        return np.minimum(np.searchsorted(self._cdf, u),
                          self.cfg.n_features - 1)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.RandomState(
            (cfg.seed * 99_991 + step * 7) % (2**31 - 1))
        feats = self._zipf_feats(rng, (cfg.batch, cfg.nnz))
        labels = class_of_features(feats, cfg.n_classes)
        # negatives ride a decorrelated stream but the SAME marginal as
        # the labels (hash of a min-of-nnz zipf draw), so the candidate
        # set is head-heavy and duplicate-rich
        nrng = np.random.RandomState(
            (cfg.seed * 77_783 + step * 13 + 7) % (2**31 - 1))
        nfeats = self._zipf_feats(nrng, (cfg.n_negatives, cfg.nnz))
        negs = class_of_features(nfeats, cfg.n_classes)
        return {"features": feats.astype(np.int32),
                "labels": labels.astype(np.int32),
                "negatives": negs.astype(np.int32)}

    def batches(self, start_step: int = 0):
        step = start_step
        while True:
            yield self.batch(step)
            step += 1
