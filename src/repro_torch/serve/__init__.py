"""Serving: model prefill/decode steps, and the online-adaptation
subsystem (batching, double-buffered state, serving loop, traffic
replay) with its adapt steps.

Counterpart of ``repro.serve``; model serving covers every family:
``gqa``, ``moe``, ``rwkv6``, ``hybrid``, ``encdec`` and ``vlm``."""
from repro_torch.serve.batcher import (AdaptRequest, Batcher,  # noqa: F401
                                       BatcherConfig, CoalescedBatch,
                                       coalesce, dedup_coalesce)
from repro_torch.serve.buffer import DoubleBufferedStore, Snapshot  # noqa: F401
from repro_torch.serve.server import (AdaptServer, Completion,  # noqa: F401
                                      RequestShed, ServerConfig, replay)
from repro_torch.serve.steps import (ServeStep, cache_factory,  # noqa: F401
                                     make_dense_adapt_step,
                                     make_online_adapt_step, make_serve_step,
                                     timed_adapt)
from repro_torch.serve.traffic import (TraceConfig, make_trace,  # noqa: F401
                                       trace_stats)
