"""The GNN substrate of the port against the JAX package's on the CPU: the
aggregations (``agg_sum``, ``agg_mean``, ``segment_softmax``,
``graph_readout``) with masked edges and nodes, rows with no edge and F in
{1, 8, 64}, and their first and second derivatives (``jax.grad`` and
``jax.jvp`` of it against ``torch.autograd.grad`` with ``create_graph``);
the graph entry's ``EdgePlan`` through the fused dense entry's plain
version; plans built once per tensor; ``layer_norm``; the intertwiners of
every path of l_max 2 (up to their sign, which the port fixes in an
order-free way); the neighbor sampler's blocks.

Tolerances (fp32): values and derivatives rtol 1e-5, atol 1e-6 (the two
packages add a row's values in other orders); intertwiners 1e-10 up to
sign (both are fp64 null vectors of the same constraints, of unit norm); the
sampler's blocks equal, array for array."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.graphs.generators import rmat_graph as j_rmat  # noqa: E402
from repro.graphs.sampler import NeighborSampler as JSampler  # noqa: E402
from repro.models import common as JM  # noqa: E402
from repro.models.gnn import common as JC  # noqa: E402
from repro.models.gnn import equivariant as JE  # noqa: E402
from repro_torch.graphs import NeighborSampler, rmat_graph  # noqa: E402
from repro_torch.kernels.segment_agg import ops, ref  # noqa: E402
from repro_torch.models import common as TM  # noqa: E402
from repro_torch.models.gnn import common as TC  # noqa: E402
from repro_torch.models.gnn import equivariant as TE  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops gain nothing from intra-op threads, which only contend
    with the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def graph(F: int, masked: bool, seed: int = 0, n: int = 40, e: int = 160):
    """Edges into the first 30 of n rows (rows 30.. have none), values
    (E, F), node values (N, F), 3 graphs of ids; with ``masked`` about 30%
    of the edges and 20% of the nodes masked out."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, 30, e).astype(np.int32)
    emask = rng.random(e) < 0.7 if masked else np.ones(e, bool)
    nmask = rng.random(n) < 0.8 if masked else np.ones(n, bool)
    gid = np.sort(rng.integers(0, 3, n)).astype(np.int32)
    vals = rng.normal(size=(e, F)).astype(np.float32)
    nodes = rng.normal(size=(n, F)).astype(np.float32)
    return dict(src=src, dst=dst, emask=emask, nmask=nmask, gid=gid,
                vals=vals, nodes=nodes, n=n)


def batches(g):
    """The same graph as the JAX package's and the port's ``GraphBatch``."""
    n, e = g["n"], g["src"].shape[0]
    kw = dict(edge_src=g["src"], edge_dst=g["dst"], edge_mask=g["emask"],
              node_mask=g["nmask"], labels=np.zeros(3, np.int32),
              label_mask=np.ones(3, bool), graph_ids=g["gid"])
    jb = JC.GraphBatch(x=jnp.asarray(g["nodes"]), n_graphs=3,
                       **{k: jnp.asarray(v) for k, v in kw.items()})
    tb = TC.GraphBatch(x=torch.tensor(g["nodes"]), n_graphs=3,
                       **{k: torch.tensor(v) for k, v in kw.items()})
    assert e == tb.edge_src.shape[0]
    return jb, tb


def ops_of(g, jb, tb):
    """name -> (JAX function, port function, input) of each aggregation;
    the input is the edge values, or the node values for the readout."""
    n = g["n"]
    jd, jm = jnp.asarray(g["dst"]), jnp.asarray(g["emask"])
    td, tm = torch.tensor(g["dst"]), torch.tensor(g["emask"])
    return {
        "agg_sum": (lambda x: JC.agg_sum(x, jd, n, jm),
                    lambda x: TC.agg_sum(x, td, n, tm), g["vals"]),
        "agg_mean": (lambda x: JC.agg_mean(x, jd, n, jm),
                     lambda x: TC.agg_mean(x, td, n, tm), g["vals"]),
        "segment_softmax": (lambda x: JC.segment_softmax(x, jd, n, jm),
                            lambda x: TC.segment_softmax(x, td, n, tm),
                            g["vals"]),
        "graph_readout": (lambda x: JC.graph_readout(x, jb),
                          lambda x: TC.graph_readout(x, tb), g["nodes"]),
        "gather": (lambda x: x[jnp.asarray(g["src"])],
                   lambda x: TC.gather(x, torch.tensor(g["src"])),
                   g["nodes"]),
    }


@pytest.mark.parametrize("F", [1, 8, 64])
@pytest.mark.parametrize("masked", [False, True])
def test_aggregations_match_jax(F, masked):
    g = graph(F, masked, seed=F)
    jb, tb = batches(g)
    for name, (jf, tf, x) in ops_of(g, jb, tb).items():
        want = np.asarray(jf(jnp.asarray(x)))
        got = tf(torch.tensor(x)).numpy()
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
    # rows with no live edge read 0 in both
    s = TC.agg_sum(torch.tensor(g["vals"]), torch.tensor(g["dst"]), g["n"],
                   torch.tensor(g["emask"]))
    assert (s[30:] == 0).all()


@pytest.mark.parametrize("name", ["agg_sum", "agg_mean", "segment_softmax",
                                  "graph_readout", "gather"])
def test_first_and_second_derivatives_match_jax(name):
    """f(x) = sum(W * tanh(op(x))): the gradient, and the Hessian times a
    vector v (the derivative of <grad f, v>), against JAX's."""
    g = graph(8, True, seed=3)
    jb, tb = batches(g)
    jf, tf, x = ops_of(g, jb, tb)[name]
    rng = np.random.default_rng(4)
    out_shape = np.asarray(jf(jnp.asarray(x))).shape
    W = rng.normal(size=out_shape).astype(np.float32)
    v = rng.normal(size=x.shape).astype(np.float32)

    def jscalar(z):
        return jnp.sum(jnp.asarray(W) * jnp.tanh(jf(z)))

    jgrad = jax.grad(jscalar)
    jg = np.asarray(jgrad(jnp.asarray(x)))
    jhv = np.asarray(jax.jvp(jgrad, (jnp.asarray(x),),
                             (jnp.asarray(v),))[1])

    tx = torch.tensor(x, requires_grad=True)
    f = (torch.tensor(W) * torch.tanh(tf(tx))).sum()
    (tg,) = torch.autograd.grad(f, tx, create_graph=True)
    (thv,) = torch.autograd.grad((tg * torch.tensor(v)).sum(), tx)
    np.testing.assert_allclose(tg.detach().numpy(), jg, **TOL)
    np.testing.assert_allclose(thv.numpy(), jhv, **TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_edge_plan_through_the_fused_entry(op, masked):
    """The plan's tables through the stacked dense entry's plain version
    at S = 1 (what the kernel runs on the card), rows masked by the plan's
    hit set, equal the graph entry's plain version; the layout keeps
    make_plan's invariants."""
    g = graph(5, masked, seed=7, n=300, e=2000)
    idx, mask = torch.tensor(g["dst"]), torch.tensor(g["emask"])
    x = torch.tensor(g["vals"])
    p = ops.make_edge_plan(idx, 300, mask if masked else None)
    fused = ref.segment_agg_level_stacked_ref(x[None], p.seg, p.src, p.sign,
                                              300, op)[0]
    fused = torch.where(p.hit[:, None], fused, 0.0)
    want = ref.segment_agg_graph_ref(x, idx, p.live, 300, op)
    torch.testing.assert_close(fused, want, **TOL)
    assert torch.equal(ops.segment_agg_graph(x, p, op), want)
    seg, src, sign = p.seg[0].numpy(), p.src[0].numpy(), p.sign[0].numpy()
    live = seg >= 0
    assert live.sum() == p.n_live == int(g["emask"].sum() if masked else 2000)
    assert (seg[live] == g["dst"][src[live]]).all()
    assert (sign[live] == 1).all() and (sign[~live] == 0).all()
    assert (src[~live] == 0).all() and seg.size % ops.E_BLK == 0
    blocks = seg.reshape(-1, ops.E_BLK)
    tob = p.tob[0].numpy()
    for b, t in enumerate(tob):      # no block straddles its row tile
        rows = blocks[b][blocks[b] >= 0]
        assert ((rows // ops.R_BLK) == t).all()
    assert p.every_row == bool(p.hit.all())
    assert not p.every_row      # rows 30.. have no edge
    assert ops.LAUNCHES["sum_gnn"] == ops.LAUNCHES["max_gnn"] == 0


def test_edge_plans_are_built_once_per_tensor():
    g = graph(2, True, seed=9)
    idx, mask = torch.tensor(g["dst"]), torch.tensor(g["emask"])
    p = ops.edge_plan(idx, 40, mask)
    assert ops.edge_plan(idx, 40, mask) is p
    assert ops.edge_plan(idx, 40) is not p
    ones = torch.ones_like(mask)
    assert ops.edge_plan(idx, 40, ones) is ops.edge_plan(idx, 40)
    idx[0] = 31                       # an edit in place makes a new plan
    q = ops.edge_plan(idx, 40, mask)
    assert q is not p and q.index[0] == 31
    # rows outside [0, n_rows) are left out, as jax.ops.segment_sum drops
    # them; their gathers read 0
    out = ops.make_edge_plan(torch.tensor([0, 40, -1, 2]), 40)
    assert out.live.tolist() == [True, False, False, True]
    v = torch.ones(4, 1)
    assert ops.graph_sum(v, out)[[0, 2, 39]].flatten().tolist() == [1, 1, 0]
    np.testing.assert_array_equal(
        np.asarray(jax.ops.segment_sum(jnp.ones((4, 1)),
                                       jnp.asarray([0, 40, -1, 2]), 40)),
        ops.graph_sum(v, out).numpy())
    assert ops.graph_gather(torch.arange(40.0)[:, None], out).flatten() \
        .tolist() == [0, 0, 0, 2]
    n0 = len(ops._EDGE_PLANS)
    del idx, mask, ones, p, q
    assert len(ops._EDGE_PLANS) < n0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(7, 33)).astype(np.float32) * 3 + 1
    gam = rng.normal(size=33).astype(np.float32)
    bet = rng.normal(size=33).astype(np.float32)
    want = JM.layer_norm(jnp.asarray(x, dtype), jnp.asarray(gam),
                         jnp.asarray(bet))
    got = TM.layer_norm(torch.tensor(x).to(getattr(torch, dtype)),
                        torch.tensor(gam), torch.tensor(bet))
    assert str(got.dtype).endswith(str(want.dtype))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-5 if dtype == "float32" else 0,
                               atol=1e-5 if dtype == "float32" else 0)


PATHS = TE.tp_paths((0, 1, 2), (0, 1, 2), (0, 1, 2))


@pytest.mark.parametrize("path", PATHS)
def test_intertwiners_match_jax_up_to_sign(path):
    """Every path of l_max 2 equals the JAX package's up to sign, and the
    port's first entry that is not structurally zero is positive. (The
    JAX package makes its largest entry positive; where entries tie in
    magnitude, as in 1 x 1 -> 1, fp64 noise of the rotations picks among
    them, so its sign changes with the call order. The NequIP tests hand
    the port's intertwiners to both packages.)"""
    assert len(PATHS) == 15 and PATHS == JE.tp_paths((0, 1, 2), (0, 1, 2),
                                                     (0, 1, 2))
    got = TE.intertwiner(*path)
    want = JE.intertwiner(*path)
    sign = np.sign(np.vdot(got, want))
    np.testing.assert_allclose(got, sign * want, rtol=0, atol=1e-10)
    flat = got.ravel()
    assert flat[np.abs(flat) > 1e-6][0] > 0


def test_intertwiners_do_not_depend_on_call_order(monkeypatch):
    """All 15 again, asked for in reverse order from another generator
    state, equal the first ones to fp64 rounding, signs included."""
    first = {p: TE.intertwiner(*p) for p in PATHS}
    monkeypatch.setattr(TE, "_rng", np.random.default_rng(99))
    TE.intertwiner.cache_clear()
    try:
        for p in reversed(PATHS):
            np.testing.assert_allclose(TE.intertwiner(*p), first[p], rtol=0,
                                       atol=1e-10, err_msg=str(p))
    finally:
        TE.intertwiner.cache_clear()


@pytest.mark.parametrize("case", [
    dict(nodes=500, edges=4000, gseed=2, fanouts=(5, 3),
         seeds=[1, 2, 3, 4], sseed=0),
    dict(nodes=300, edges=3000, gseed=3, fanouts=(7,),
         seeds=list(range(16)), sseed=1),
])
def test_sampler_blocks_equal_jax(case):
    """tests/test_substrate.py's sampler cases: the same blocks, array for
    array, from the same graph and seed."""
    got = NeighborSampler(
        rmat_graph(case["nodes"], case["edges"], seed=case["gseed"])
        .reverse(), case["fanouts"], seed=case["sseed"]).sample(
            np.asarray(case["seeds"]))
    want = JSampler(
        j_rmat(case["nodes"], case["edges"], seed=case["gseed"]).reverse(),
        case["fanouts"], seed=case["sseed"]).sample(
            np.asarray(case["seeds"]))
    assert len(got) == len(want) == len(case["fanouts"])
    for a, b in zip(got, want):
        for f in ("src_nodes", "dst_nodes", "edge_src", "edge_dst",
                  "edge_mask", "src_mask"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert NeighborSampler.padded_layer_sizes(4, (5, 3)) == \
        JSampler.padded_layer_sizes(4, (5, 3))
