"""The benchmark harness of the PyTorch and CUDA port (``repro_torch``).

``bench/run.py`` is the one entry point.  Everything that belongs to one
configuration, traffic mix, per-layer metric or cell sits in a file of
its own, found by the name that ``BENCHMARK.json`` gives it
(``harness.manifest``).  The yardsticks (traffic generation, the FLOP
and byte arithmetic, the table of peaks, the trace reduction and the
comparison that decides ``correct``) live here, not in the program.
"""
