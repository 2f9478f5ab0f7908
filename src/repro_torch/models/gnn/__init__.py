from repro_torch.models.gnn.common import GraphBatch, segment_softmax  # noqa: F401
