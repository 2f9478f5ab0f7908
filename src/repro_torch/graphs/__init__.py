from repro_torch.graphs.csr import CSRGraph
from repro_torch.graphs.generators import (
    rmat_graph,
    erdos_graph,
    cora_like_graph,
    small_example_graph,
)
from repro_torch.graphs.sampler import NeighborSampler, SampledBlock

__all__ = [
    "CSRGraph",
    "rmat_graph",
    "erdos_graph",
    "cora_like_graph",
    "small_example_graph",
    "NeighborSampler",
    "SampledBlock",
]
