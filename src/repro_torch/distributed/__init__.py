"""Distributed pieces of the port: the data-parallel collectives
(``collectives``: ``ReplicaGroup``, ``ProcessGroupAxis``), the sketched
gradient reduction (``sketched_reduce``) and the trainer's
``StragglerMonitor`` (``elastic``).  Sharded sketches wait for ROADMAP
A13b; placement on a mesh and elastic restore for A13c."""
from repro_torch.distributed.collectives import (  # noqa: F401
    ProcessGroupAxis, ReplicaGroup, as_axis)
from repro_torch.distributed.sketched_reduce import (  # noqa: F401
    DpAdamResult, dense_reduce_bytes, dp_adam_rows, global_unique_ids,
    init_feedback, local_sketch, reduce_gradient_sketch, reduce_moments,
    sketched_reduce_bytes, traffic_ratio)
