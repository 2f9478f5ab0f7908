"""gatedgcn [arXiv:2003.00982]: 16 layers, d_hidden=70, gated aggregator
(``CFG``), scaled to each assigned shape's feature/class counts; the smoke
cell cuts it to 3 layers of d 24 and the graph by
``gnn_common.smoke_dims``."""
import dataclasses

from repro_torch.configs import gnn_common
from repro_torch.configs.gnn_common import FAMILY, SHAPE_DEFS  # noqa: F401
from repro_torch.models.gnn import gatedgcn as m

CFG = m.GatedGCNConfig(name="gatedgcn", n_layers=16, d_hidden=70)


def config(d: dict, graph_task: bool) -> m.GatedGCNConfig:
    return dataclasses.replace(CFG, d_in=d["d_feat"], n_classes=d["classes"],
                               task="graph" if graph_task else "node")


def smoke_config(d: dict, graph_task: bool) -> m.GatedGCNConfig:
    return dataclasses.replace(config(d, graph_task), n_layers=3,
                               d_hidden=24)


def build_smoke(shape: str, device=None) -> dict:
    return gnn_common.build_graph_cell(shape, smoke_config, m.param_specs,
                                       m.loss_fn, smoke=True, device=device)


def build_train(shape: str = "minibatch_lg", *, device=None,
                seed: int = 0) -> dict:
    return gnn_common.build_graph_cell(shape, config, m.param_specs,
                                       m.loss_fn, smoke=False, device=device,
                                       seed=seed)


ARCH = gnn_common.make_graph_arch("gatedgcn", config, smoke_config,
                                  m.param_specs, m.loss_fn)
