"""Reader-partitioned shards stacked on one card, durable checkpoints and
crash recovery — the port of the JAX package's ``repro.distributed``
(without its gradient compression and mesh sharding rules, which serve the
training path: ROADMAP.md item 13)."""
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
