"""Production mesh shapes: the JAX package's ``repro.launch.mesh`` as
``MeshShape``s (axis names and sizes, no devices), which the sharding rules
and the dry run's per-device bytes read."""
from __future__ import annotations

from repro_torch.distributed.sharding import MeshShape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """Single pod: (16, 16) = 256 chips, axes (data, model).
    Multi-pod: (2, 16, 16) = 512 chips, axes (pod, data, model); the pod axis
    composes with data for all data-parallel collectives."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh() -> MeshShape:
    """1-device mesh with the production axis names."""
    return MeshShape(("data", "model"), (1, 1))


SHARD_AXIS = "shard"


def make_shard_mesh(n_shards: int) -> MeshShape | None:
    """1-D mesh of ``n_shards`` ranks along the EAGr shard axis, or None
    unless ``torch.distributed`` is initialised with at least ``n_shards``
    ranks (the JAX package's rule: fewer devices than shards gives None,
    and the stacked engine keeps its one-card path)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() < n_shards:
        return None
    return MeshShape((SHARD_AXIS,), (n_shards,))
