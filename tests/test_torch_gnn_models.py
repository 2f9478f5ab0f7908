"""The port's GAT, GatedGCN and GraphCast against the JAX package's on the
CPU, at each arch's smoke config on the JAX package's own smoke cells
(``build_smoke``: its parameters, carried over by
``convert.params_from_reference``, and its batch): the forward, the loss
and every gradient leaf, then one AdamW train step; GAT and GatedGCN also
on a batch with masked edges and nodes and rows with no edge.

Tolerances (fp32): forward and loss rtol 1e-5 / atol 1e-6 of the largest
magnitude; gradients rtol 1e-4 plus 1e-4 of the leaf's largest magnitude
(random-init fp32 gradients of either package sit that far from fp64,
tests/test_torch_train_lm.py); after one step every parameter at the same
bar."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import gat_cora as JGAT  # noqa: E402
from repro.configs import gatedgcn as JGG  # noqa: E402
from repro.configs import get_arch as jget  # noqa: E402
from repro.configs import gnn_common as JGC  # noqa: E402
from repro.configs.graphcast import SMOKE_CFG as JGC_SMOKE  # noqa: E402
from repro.models.gnn import common as JC  # noqa: E402
from repro.models.gnn import gat as JA  # noqa: E402
from repro.models.gnn import gatedgcn as JD  # noqa: E402
from repro.models.gnn import graphcast as JF  # noqa: E402
from repro.train.optimizer import get_optimizer as j_opt  # noqa: E402
from repro.train.trainer import make_train_step as j_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels.segment_agg import ops  # noqa: E402
from repro_torch.models.gnn import common as TC  # noqa: E402
from repro_torch.models.gnn import gat as TA  # noqa: E402
from repro_torch.models.gnn import gatedgcn as TD  # noqa: E402
from repro_torch.models.gnn import graphcast as TF  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train.trainer import make_train_step, value_and_grad  # noqa: E402

DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, which only
    contend with the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(jcfg, cls):
    """The port's config with the JAX config's fields (dtypes mapped)."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(jcfg, f.name)
        kw[f.name] = DTYPES.get(v, v) if f.name == "compute_dtype" else v
    return cls(**kw)


def port_batch(jb, cls):
    """The port's batch dataclass from the JAX package's, leaf for leaf."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(jb, f.name)
        kw[f.name] = v if v is None or isinstance(v, int) else \
            torch.as_tensor(np.array(v))
    return cls(**kw)


def smoke_dims(shape):
    d = dict(JGC.SHAPE_DEFS[shape])
    d.update(n=min(d["n"], 64), e=min(d["e"], 256),
             d_feat=min(d["d_feat"], 24), graphs=min(d["graphs"], 4))
    return d


def masked(jb, seed):
    """``jb`` with ~30% of its edges and ~20% of its nodes masked, and every
    edge into its last 8 nodes moved to node 0."""
    rng = np.random.default_rng(seed)
    n, e = jb.x.shape[0], jb.edge_src.shape[0]
    dst = np.asarray(jb.edge_dst).copy()
    dst[dst >= n - 8] = 0
    return dataclasses.replace(
        jb, edge_dst=jnp.asarray(dst),
        edge_mask=jnp.asarray(rng.random(e) < 0.7),
        node_mask=jnp.asarray(rng.random(n) < 0.8),
        label_mask=jnp.asarray(rng.random(jb.labels.shape[0]) < 0.8))


def assert_leaves(got, want, rtol=1e-4, scale=1e-4):
    """Each leaf within rtol plus ``scale`` of its largest magnitude."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = a.detach().float().numpy()
        b = np.asarray(jnp.asarray(b, jnp.float32))
        assert a.shape == b.shape
        np.testing.assert_allclose(
            a, b, rtol=rtol, atol=scale * max(float(np.abs(b).max()), 1e-30))


def cases():
    """(arch, shape) -> (JAX loss module, port loss module, JAX config,
    port config class, port batch class)."""
    out = {}
    for shape in ("full_graph_sm", "molecule"):
        d, graph_task = smoke_dims(shape), shape == "molecule"
        out[("gat-cora", shape)] = (JA, TA, JGAT._mk(d, graph_task),
                                    TA.GATConfig, TC.GraphBatch)
        out[("gatedgcn", shape)] = (JD, TD, JGG._mk_smoke(d, graph_task),
                                    TD.GatedGCNConfig, TC.GraphBatch)
    out[("graphcast", "full_graph_sm")] = (JF, TF, JGC_SMOKE,
                                           TF.GraphCastConfig,
                                           TF.GraphCastBatch)
    return out


CASES = cases()


@functools.lru_cache(maxsize=None)
def jax_smoke(arch, shape):
    """The JAX package's smoke cell's parameters and batch."""
    jp, _, jb, _ = jget(arch).build_smoke(shape).args
    return jp, jb


def setup(arch, shape, mask_seed=None):
    jm, tm, jcfg, cfg_cls, batch_cls = CASES[(arch, shape)]
    jp, jb = jax_smoke(arch, shape)
    if mask_seed is not None:
        jb = masked(jb, mask_seed)
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp),
                                       device="cpu")
    return jm, tm, jcfg, port_cfg(jcfg, cfg_cls), jp, jb, tp, \
        port_batch(jb, batch_cls)


@pytest.mark.parametrize("arch,shape,mask_seed", [
    ("gat-cora", "full_graph_sm", None), ("gat-cora", "molecule", None),
    ("gat-cora", "full_graph_sm", 5), ("gat-cora", "molecule", 6),
    ("gatedgcn", "full_graph_sm", None), ("gatedgcn", "molecule", None),
    ("gatedgcn", "full_graph_sm", 7), ("gatedgcn", "molecule", 8),
    ("graphcast", "full_graph_sm", None)])
def test_forward_loss_and_gradients_match_jax(arch, shape, mask_seed):
    jm, tm, jcfg, cfg, jp, jb, tp, tb = setup(arch, shape, mask_seed)
    want = np.asarray(jax.jit(functools.partial(jm.forward, cfg=jcfg))(
        jp, jb))
    with torch.no_grad():
        got = tm.forward(tp, tb, cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        functools.partial(jm.loss_fn, cfg=jcfg), has_aux=True))(jp, jb)
    ops.reset_launches()
    tl, tmet, tg = value_and_grad(
        lambda p, b: tm.loss_fn(p, b, cfg), tp, tb)
    assert ops.LAUNCHES["sum_gnn"] == ops.LAUNCHES["max_gnn"] == 0  # CPU
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert set(tmet) == set(jmet)
    assert_leaves(tg, jax.tree.leaves(jg))


@pytest.mark.parametrize("arch,shape", [
    ("gat-cora", "molecule"), ("gatedgcn", "full_graph_sm"),
    ("graphcast", "full_graph_sm")])
def test_adamw_step_matches_jax(arch, shape):
    jm, tm, jcfg, cfg, jp, jb, tp, tb = setup(arch, shape)
    jstep = jax.jit(j_step(functools.partial(jm.loss_fn, cfg=jcfg),
                           j_opt("adamw")))
    jp1, js1, jmet = jstep(jp, j_opt("adamw").init(jp), jb, jnp.float32(1e-3))
    opt = TO.get_optimizer("adamw")
    step = make_train_step(functools.partial(tm.loss_fn, cfg=cfg), opt)
    tp1, ts1, tmet = step(tp, opt.init(tp), tb, 1e-3)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
    assert_leaves(TO.tree_leaves(tp1), jax.tree.leaves(jp1))
    assert_leaves(TO.tree_leaves(ts1.mu), jax.tree.leaves(js1.mu))


@pytest.mark.parametrize("module", [TF, TD])
def test_remat_changes_no_gradient(module, monkeypatch):
    """The layer loops recompute each layer in the backward: the gradients
    equal the ones taken without checkpointing, bit for bit."""
    arch = "graphcast" if module is TF else "gatedgcn"
    jm, tm, jcfg, cfg, jp, jb, tp, tb = setup(arch, "full_graph_sm")
    _, _, g1 = value_and_grad(lambda p, b: tm.loss_fn(p, b, cfg), tp, tb)
    monkeypatch.setattr(module, "checkpoint", lambda fn, *a, **k: fn(*a))
    _, _, g2 = value_and_grad(lambda p, b: tm.loss_fn(p, b, cfg), tp, tb)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_graph_readout_on_a_batch_without_graph_ids():
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(10, 4)).astype(np.float32)
    nmask = rng.random(10) < 0.6
    kw = dict(edge_src=np.zeros(2, np.int32), edge_dst=np.zeros(2, np.int32),
              edge_mask=np.ones(2, bool), node_mask=nmask,
              labels=np.zeros(10, np.int32), label_mask=np.ones(10, bool))
    jb = JC.GraphBatch(x=jnp.asarray(vals),
                       **{k: jnp.asarray(v) for k, v in kw.items()})
    tb = TC.GraphBatch(x=torch.tensor(vals),
                       **{k: torch.tensor(v) for k, v in kw.items()})
    np.testing.assert_allclose(
        TC.graph_readout(torch.tensor(vals), tb).numpy(),
        np.asarray(JC.graph_readout(jnp.asarray(vals), jb)), rtol=1e-6,
        atol=1e-6)
