"""Distributed pieces of the port: the collectives (``collectives``:
``ReplicaGroup``, ``ReplicaMesh``, ``ProcessGroupAxis``,
``process_group_mesh``), the sketched gradient reduction and the sharded
step (``sketched_reduce``), a sharded state's slabs (``slabs``), the
placement rules and a replica's blocks (``sharding``), and the elastic
control plane (``elastic``: ``StragglerMonitor``, ``plan_resize``,
``elastic_restore``, ``recovery_loop``)."""
from repro_torch.distributed.collectives import (  # noqa: F401
    GroupMesh, ProcessGroupAxis, ReplicaGroup, ReplicaMesh, as_axis,
    mesh_axis, process_group_mesh)
from repro_torch.distributed.elastic import (  # noqa: F401
    ElasticPlan, RecoveryOutcome, StragglerMonitor, elastic_restore,
    largest_pow2_leq, plan_resize, recovery_loop)
from repro_torch.distributed.sketched_reduce import (  # noqa: F401
    DpAdamResult, dense_reduce_bytes, dp_adam_rows, global_unique_ids,
    init_feedback, local_sketch, reduce_gradient_sketch, reduce_moments,
    routing_bytes, sharded_adam_rows, sharded_query, sharded_reduce_bytes,
    sketched_reduce_bytes, traffic_ratio)
from repro_torch.distributed.slabs import (  # noqa: F401
    join_slabs, shard_state)
