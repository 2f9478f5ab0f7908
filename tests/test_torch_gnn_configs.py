"""The four GNN archs' config modules in the port: every arch's reduced
cell builds and takes one finite step on every assigned shape; the JAX
package's parameter trees (GatedGCN's and GraphCast's layer-stacked leaves
among them) carry over verbatim; the published and smoke configs, the
shapes and the parameter layouts equal the JAX package's; random batches
keep its structure; the full-size builders pad and mask as its cells do;
and the training launcher replays bit-equal after an injected failure."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import gat_cora as J_GAT  # noqa: E402
from repro.configs import gatedgcn as J_GG  # noqa: E402
from repro.configs import gnn_common as J_COMMON  # noqa: E402
from repro.configs import graphcast as J_GC  # noqa: E402
from repro.configs import nequip as J_NQ  # noqa: E402
from repro.models.gnn import graphcast as J_GCM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch, gnn_common  # noqa: E402
from repro_torch.configs import graphcast as T_GC  # noqa: E402
from repro_torch.configs import nequip as T_NQ  # noqa: E402
from repro_torch.kernels.segment_agg import ops  # noqa: E402
from repro_torch.models.gnn import graphcast as T_GCM  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402

ARCHS = ("gat-cora", "gatedgcn", "graphcast", "nequip")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fields(cfg) -> dict:
    """A config's fields, dtypes by name."""
    return {f.name: (str(getattr(cfg, f.name)).split(".")[-1].replace(
        "'>", "") if f.name == "compute_dtype" else getattr(cfg, f.name))
        for f in dataclasses.fields(cfg) if f.name != "scan_unroll"}


@pytest.mark.parametrize("shape", gnn_common.GNN_SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cell_takes_a_finite_step(arch, shape):
    mod = get_arch(arch)
    assert mod.FAMILY == "gnn" and mod.SHAPE_DEFS[shape]["kind"] == "train"
    c = mod.build_smoke(shape, device="cpu")
    ops.reset_launches()
    params, opt_state, m = c["step"](c["params"], c["opt_state"], c["batch"],
                                     c["lr"])
    assert ops.LAUNCHES["sum_gnn"] == ops.LAUNCHES["max_gnn"] == 0  # CPU
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(params))
    assert int(opt_state.count) == 1


def jax_smoke_specs(arch):
    """The JAX package's parameter specs of the arch's molecule smoke
    cell."""
    from repro.models.gnn import gat, gatedgcn, graphcast, nequip
    dims = J_COMMON.SHAPE_DEFS["molecule"] | dict(n=64, e=256, d_feat=16,
                                                   graphs=4)
    return {"gat-cora": lambda: gat.param_specs(J_GAT._mk(dims, True)),
            "gatedgcn": lambda: gatedgcn.param_specs(
                J_GG._mk_smoke(dims, True)),
            "graphcast": lambda: graphcast.param_specs(J_GC.SMOKE_CFG),
            "nequip": lambda: nequip.param_specs(J_NQ.SMOKE_CFG)}[arch]()


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_parameter_trees_carry_over_verbatim(arch):
    """A parameter tree in the JAX package's layout (its specs, numbers
    drawn with numpy as ``jax.tree.map(np.asarray, params)`` hands them
    over) goes through ``params_from_reference`` leaf for leaf."""
    rng = np.random.default_rng(0)
    jp = jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(np.float32),
        jax_smoke_specs(arch), is_leaf=lambda x: hasattr(x, "init_scale"))
    tp = convert.params_from_reference(jp, device="cpu")
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    want = jax.tree.leaves(jp)
    got = tree_leaves(tp)
    assert len(got) == len(want)
    for p, a, b in zip(paths, got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, p
        assert np.array_equal(a.numpy(), b), p
    # the port's own specs give the same tree
    ours = get_arch(arch).build_smoke("molecule", device="cpu")["params"]
    assert [tuple(x.shape) for x in tree_leaves(ours)] == \
        [x.shape for x in want]
    if arch in ("gatedgcn", "graphcast"):       # layer-stacked (L, ...)
        stacked = tp["layers"] if arch == "gatedgcn" else tp["proc"]["edge"]
        assert all(x.shape[0] == (3 if arch == "gatedgcn" else 2)
                   for x in tree_leaves(stacked))


def test_configs_and_shapes_agree_with_jax():
    for shape, d in gnn_common.SHAPE_DEFS.items():
        assert {k: v for k, v in d.items() if k != "kind"} == \
            J_COMMON.SHAPE_DEFS[shape]
        dims = gnn_common.smoke_dims(shape)
        graph_task = shape == "molecule"
        assert fields(get_arch("gat-cora").config(dims, graph_task)) == \
            fields(J_GAT._mk(dims, graph_task))
        assert fields(get_arch("gatedgcn").config(dims, graph_task)) == \
            fields(J_GG._mk(dims, graph_task))
        assert fields(get_arch("gatedgcn").smoke_config(dims, graph_task)) \
            == fields(J_GG._mk_smoke(dims, graph_task))
    for ours, theirs in ((T_GC.CFG, J_GC.CFG),
                         (T_GC.SMOKE_CFG, J_GC.SMOKE_CFG),
                         (T_NQ.CFG, J_NQ.CFG),
                         (T_NQ.CFG_BF16, J_NQ.CFG_BF16),
                         (T_NQ.SMOKE_CFG, J_NQ.SMOKE_CFG)):
        assert fields(ours) == fields(theirs)
    assert T_NQ._SHARDMAP_SHAPES == J_NQ._SHARDMAP_SHAPES
    assert gnn_common.pad512(2449029) == J_COMMON.pad512(2449029) == 2449408
    for r in range(7):
        assert T_GCM.mesh_sizes(r) == J_GCM.mesh_sizes(r)
    assert (T_GC.CFG.n_mesh, T_GC.CFG.n_mesh_edges) == (40962, 327660)


def test_random_graph_batch_structure():
    rng = np.random.default_rng(0)
    b = gnn_common.random_graph_batch(rng, 120, 256, 5, 3, graphs=4,
                                      geometric=True, graph_task=True,
                                      device="cpu")
    src, dst, gid = b.edge_src.numpy(), b.edge_dst.numpy(), \
        b.graph_ids.numpy()
    assert (gid[src] == gid[dst]).all()          # edges inside their graph
    assert (gid == np.repeat(np.arange(4), 30)).all()
    assert b.labels.shape == (4,) and b.n_graphs == 4
    assert b.positions.shape == (120, 3) and int(b.species.max()) < 10
    assert bool(b.edge_mask.all()) and bool(b.node_mask.all())


def test_full_size_builders_pad_and_mask():
    """full_graph_sm at its full size: the graph padded to multiples of
    512, the padded nodes and edges masked out; GraphCast's grid padded,
    masked out of the loss, every edge end over the real grid."""
    c = get_arch("gat-cora").build_train("full_graph_sm", device="cpu")
    b = c["batch"]
    assert b.x.shape == (3072, 1433) and b.edge_src.shape == (10752,)
    assert int(b.node_mask.sum()) == int(b.label_mask.sum()) == 2708
    assert int(b.edge_mask.sum()) == 10556
    assert int(b.edge_dst[b.edge_mask].max()) < 2708
    cfg = dataclasses.replace(T_GC.CFG, n_layers=1, d_hidden=8,
                              mesh_refinement=2, n_vars=3)
    g = T_GC.build_train("full_graph_sm", cfg=cfg, device="cpu")
    gb = g["batch"]
    assert gb.grid_x.shape == (3072, 3) and int(gb.grid_mask.sum()) == 2708
    assert gb.g2m_src.shape == (12288,) and gb.mesh_src.shape == (1536,)
    assert int(gb.g2m_src.max()) < 2708 and int(gb.m2g_dst.max()) < 2708
    assert int(gb.mesh_dst.max()) < cfg.n_mesh
    _, _, m = g["step"](g["params"], g["opt_state"], gb, g["lr"])
    assert np.isfinite(float(m["loss"]))
    n = get_arch("nequip").build_train("molecule", device="cpu")
    assert n["cfg"] is T_NQ.CFG and n["batch"]["positions"].shape == (3840, 3)
    assert n["batch"]["energy_targets"].shape == (128,)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_replays_bit_equal(arch, tmp_path):
    """The training launcher on the arch's reduced cell: a failure
    injected at step 3 (checkpoints every 2 steps) ends bit-equal to the
    uninterrupted run; each redrawn batch gets its plans at first use."""
    from repro_torch.launch import train as launcher

    states = []
    for fail_at in (None, 3):
        state, report, shape = launcher.train(
            arch, steps=6, lr=1e-3, ckpt_dir=str(tmp_path / f"{fail_at}"),
            ckpt_every=2, fail_at=fail_at, device="cpu")
        assert shape == "full_graph_sm" and report.steps_run >= 6
        assert report.restarts == (fail_at is not None)
        assert np.isfinite(report.losses).all()
        states.append(tree_leaves(state))
    assert all(torch.equal(a, b) for a, b in zip(*states))
