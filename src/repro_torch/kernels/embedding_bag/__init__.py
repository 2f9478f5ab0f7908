from repro_torch.kernels.embedding_bag.ops import (
    LAUNCHES,
    embedding_bag,
    embedding_bag_backward,
    reset_launches,
)
from repro_torch.kernels.embedding_bag.ref import (
    bags_of,
    embedding_bag_backward_ref,
    embedding_bag_ref,
)

__all__ = ["LAUNCHES", "bags_of", "embedding_bag", "embedding_bag_backward",
           "embedding_bag_backward_ref", "embedding_bag_ref",
           "reset_launches"]
