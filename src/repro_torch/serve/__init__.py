"""Serving: the online-adaptation subsystem (batching, double-buffered
state, serving loop, traffic replay) and its adapt steps.

Counterpart of ``repro.serve`` without the model-serving steps
(``make_serve_step``, ``cache_factory``, ``ServeStep``), which need the
model families and wait for ROADMAP A14."""
from repro_torch.serve.batcher import (AdaptRequest, Batcher,  # noqa: F401
                                       BatcherConfig, CoalescedBatch,
                                       coalesce, dedup_coalesce)
from repro_torch.serve.buffer import DoubleBufferedStore, Snapshot  # noqa: F401
from repro_torch.serve.server import (AdaptServer, Completion,  # noqa: F401
                                      RequestShed, ServerConfig, replay)
from repro_torch.serve.steps import (make_dense_adapt_step,  # noqa: F401
                                     make_online_adapt_step, timed_adapt)
from repro_torch.serve.traffic import (TraceConfig, make_trace,  # noqa: F401
                                       trace_stats)
