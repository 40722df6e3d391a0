"""Drivers of the traffic mixes' kinds: ``sparse_rows`` and ``lm_train``.

A kind's ``Cell(spec, seed, device, cells=...)`` builds the program and
its inputs (``build``), runs its first three steps and reads them
(``check_steps``), then serves the window's steps (``step(i)`` returns
the step's loss on the device).  After the window ``counts`` gives what
the per-layer readers need, ``free`` lets go of the program's state and
``reference`` runs the plain reference over the same first steps.
"""
