"""gat-cora [arXiv:1710.10903]: 2 layers, 8 hidden per head, 8 heads, attn
aggregator — the paper-exact Cora config (``CFG``: 1,433 features, 7
classes), scaled to each assigned shape's feature/class counts. The smoke
cell keeps the config and cuts the graph (``gnn_common.smoke_dims``)."""
import dataclasses

from repro_torch.configs import gnn_common
from repro_torch.configs.gnn_common import FAMILY, SHAPE_DEFS  # noqa: F401
from repro_torch.models.gnn import gat

CFG = gat.GATConfig(name="gat-cora", n_layers=2, d_hidden=8, n_heads=8,
                    d_in=1433, n_classes=7)


def config(d: dict, graph_task: bool) -> gat.GATConfig:
    return dataclasses.replace(CFG, d_in=d["d_feat"], n_classes=d["classes"],
                               task="graph" if graph_task else "node")


def build_smoke(shape: str, device=None) -> dict:
    return gnn_common.build_graph_cell(shape, config, gat.param_specs,
                                       gat.loss_fn, smoke=True, device=device)


def build_train(shape: str = "minibatch_lg", *, device=None,
                seed: int = 0) -> dict:
    return gnn_common.build_graph_cell(shape, config, gat.param_specs,
                                       gat.loss_fn, smoke=False,
                                       device=device, seed=seed)


ARCH = gnn_common.make_graph_arch("gat-cora", config, config, gat.param_specs,
                                  gat.loss_fn)
