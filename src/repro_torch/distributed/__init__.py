"""Reader-partitioned shards stacked on one card, durable checkpoints and
crash recovery (of sessions and of training states), int8 gradient
compression (``compression``) and the logical-axis sharding rules as host
logic over mesh shapes (``sharding``) — the port of the JAX package's
``repro.distributed``."""
from repro_torch.distributed.checkpoint import (
    CheckpointManager,
    restore_session,
    snapshot_session,
)
from repro_torch.distributed.eagr_shard import (
    ShardedDynamic,
    ShardedOverlay,
    align_shard_plans,
    host_loop_read,
    host_loop_write,
    partition_overlay,
    shard_read_batch,
    shard_write_batch,
)
from repro_torch.distributed.fault import (
    FaultTolerantRunner,
    RunReport,
    SessionRecoveryDriver,
    StragglerDetector,
)
from repro_torch.distributed.stacked import StackedShardedEngine

__all__ = [
    "CheckpointManager",
    "FaultTolerantRunner",
    "RunReport",
    "SessionRecoveryDriver",
    "ShardedDynamic",
    "ShardedOverlay",
    "StackedShardedEngine",
    "StragglerDetector",
    "align_shard_plans",
    "host_loop_read",
    "host_loop_write",
    "partition_overlay",
    "restore_session",
    "shard_read_batch",
    "shard_write_batch",
    "snapshot_session",
]
