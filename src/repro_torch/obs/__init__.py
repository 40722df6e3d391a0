"""Telemetry: named profiler spans (``profiling.scope``).  Metrics,
probes and the host-side phase timers wait for ROADMAP A11."""
