"""The port's frontier-sparse path against the JAX package's
(``backend="xla"`` on the CPU) and against its own dense path: the frontier
indices and their expansions array for array, the superset oracle
(``verify``), sparse writes and reads bit-equal to dense inside the port for
every aggregate x tuple/time window, the same answers as the reference's
sparse engine, and the segment kernel's fused active entry (its plain
version: gather, sign, reduce and row mask) bit-equal on the rows it covers
to the dense level over the gathered values with the inactive blocks set to
the identity."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import dataflow as RD  # noqa: E402
from repro.core import engine as RE  # noqa: E402
from repro.core import frontier as RF  # noqa: E402
from repro.core.aggregates import make_aggregate as r_agg  # noqa: E402
from repro.core.bipartite import build_bipartite as r_bip  # noqa: E402
from repro.core.dynamic import DynamicOverlay as RDyn  # noqa: E402
from repro.core.vnm import construct_vnm as r_vnm  # noqa: E402
from repro.core.window import WindowSpec as RSpec  # noqa: E402
from repro.graphs.generators import rmat_graph as r_rmat  # noqa: E402
from repro_torch.core import dataflow as TD  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import frontier as TF  # noqa: E402
from repro_torch.core.aggregates import make_aggregate as t_agg  # noqa: E402
from repro_torch.core.bipartite import build_bipartite as t_bip  # noqa: E402
from repro_torch.core.dynamic import DynamicOverlay as TDyn  # noqa: E402
from repro_torch.core.plan_patch import PlanHost  # noqa: E402
from repro_torch.core.vnm import construct_vnm as t_vnm  # noqa: E402
from repro_torch.core.window import WindowSpec as TSpec  # noqa: E402
from repro_torch.graphs.generators import rmat_graph as t_rmat  # noqa: E402
from repro_torch.kernels.segment_agg import ops as T  # noqa: E402
from repro_torch.kernels.segment_agg.ref import (  # noqa: E402
    NEG,
    segment_agg_active_ref,
    segment_agg_level_ref,
)


def _bases(seed=3, n=150, e=900):
    """Both packages' unpruned overlay exports of one RMAT graph."""
    out = []
    for rmat, bip, vnm, dyn in ((r_rmat, r_bip, r_vnm, RDyn),
                                (t_rmat, t_bip, t_vnm, TDyn)):
        bp = bip(rmat(n, e, seed=seed))
        ov, _ = vnm(bp, variant="vnm_a", max_iterations=3, seed=0)
        out.append(dyn.from_overlay(ov, bp.reader_input_sets())
                   .to_overlay(prune=False))
    return out


@pytest.fixture(scope="module")
def bases():
    return _bases()


def _decisions(basis, all_push):
    if all_push:
        return np.full(basis.n_nodes, RD.PUSH, np.int64)
    n = max((o for o in basis.origin if o >= 0), default=0) + 1
    wf = np.ones(n)
    return RD.decide_mincut(basis, wf, wf.copy(),
                            RD.cost_model_for("sum", window=4), window=4)[0]


def _port(basis, *, agg="sum", spec=None, all_push=False, **kw):
    return TE.EagrEngine(basis, _decisions(basis, all_push),
                         t_agg(agg, **kw), spec or TSpec("tuple", 4),
                         headroom=2.0, device="cpu")


def _ref(basis, *, agg="sum", spec=None, all_push=False, **kw):
    return RE.EagrEngine(basis, _decisions(basis, all_push), r_agg(agg, **kw),
                         spec or RSpec("tuple", 4), headroom=2.0,
                         backend="xla")


def _state(eng):
    s = eng.state
    return [t.numpy() for t in (s.windows.values, s.windows.stamps,
                                s.windows.head, s.windows.count, s.pao,
                                s.now)]


# ------------------------------------------------------------ the indices
@pytest.mark.parametrize("exact", [False, True])
def test_frontier_index_equals_reference(bases, exact):
    br, bt = bases
    pr = _ref(br, all_push=True).plan
    pt = _port(bt, all_push=True).plan
    fr = RF.FrontierIndex.build(pr, exact=exact)
    ft = TF.FrontierIndex.build(pt, exact=exact)
    for f in ("n_levels", "n_blocks", "n_base_rows", "row_of_node"):
        assert getattr(fr, f) == getattr(ft, f), f
    for f in ("w_indptr", "w_lvl", "w_lo", "w_hi"):
        np.testing.assert_array_equal(getattr(fr, f), getattr(ft, f),
                                      err_msg=f)
    rng = np.random.default_rng(1)
    for k in (1, 3, 17, 40):
        rows = np.unique(rng.choice(ft.n_base_rows, k))
        for density in (None, 0.25):
            a, b = fr.expand(rows, density=density), \
                ft.expand(rows, density=density)
            assert (a is None) == (b is None)
            if a is not None:
                assert len(a) == len(b)
                for x, y in zip(a, b):
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)


def test_reader_frontier_index_equals_reference(bases):
    br, bt = bases
    pr, pt = _ref(br).plan, _port(bt).plan
    fr, ft = RF.ReaderFrontierIndex.build(pr), TF.ReaderFrontierIndex.build(pt)
    assert (fr.n_levels, fr.n_chunks, fr.n_blocks, fr.dense_only) == \
        (ft.n_levels, ft.n_chunks, ft.n_blocks, ft.dense_only)
    for f in ("dem_keys", "pull_keys"):
        a, b = getattr(fr, f), getattr(ft, f)
        assert a.keys() == b.keys()
        for v in a:
            np.testing.assert_array_equal(a[v], b[v])
    nodes = np.flatnonzero(pt.routes.reader_node >= 0)
    rng = np.random.default_rng(2)
    for k in (1, 5, 24):
        q = pt.routes.reader_node[np.unique(rng.choice(nodes, k))]
        a, b = fr.expand(np.unique(q)), ft.expand(np.unique(q))
        assert (a is None) == (b is None)
        if a is not None:
            for x, y in zip(a[0] + a[1], b[0] + b[1]):
                np.testing.assert_array_equal(x, y)


def test_frontier_blocks_cover_closures(bases):
    """Both flavors are supersets of their closure walk (``verify``), and
    the source-exact flavor never exceeds the span flavor."""
    eng = _port(bases[1], all_push=True)
    plan = eng.plan
    plan.host = PlanHost.from_plan(plan, eng.overlay)
    fi = TF.FrontierIndex.build(plan)
    fi.verify(plan, plan.host)
    fx = TF.FrontierIndex.build(plan, exact=True)
    fx.verify(plan, plan.host)
    for node, row in fx.row_of_node.items():
        spans = fi.blocks_of(fi.row_of_node[node])
        for l, blks in fx.blocks_of(row).items():
            assert blks <= spans.get(l, set())


def test_frontier_density_fallback_and_gates(bases, monkeypatch):
    eng = _port(bases[1], all_push=True)
    fi = TF.FrontierIndex.build(eng.plan)
    rows = np.arange(fi.n_base_rows)
    assert fi.expand(rows, density=0.0) is None
    act = fi.expand(rows[:2], density=None)
    assert act is not None and len(act) == eng.plan.meta.n_levels
    for lvl in act:
        real = lvl[lvl < fi.n_blocks]
        assert lvl.dtype == np.int32 and (np.diff(real) > 0).all()
        assert (lvl[len(real):] == fi.n_blocks).all()
    assert fi.expand(np.array([fi.n_base_rows + 99]), density=None) is None
    assert [TF.bucket_active(k) for k in (0, 1, 7, 8, 9, 64, 65)] == \
        [0, 8, 8, 8, 16, 64, 128]
    writers = np.flatnonzero(eng.plan.routes.writer_row >= 0)
    monkeypatch.setenv("EAGR_SPARSE_WRITE", "auto")
    monkeypatch.setenv("EAGR_SPARSE_ROWFRAC", "0.05")
    rows, mask = eng.plan.routes.writer_rows(
        np.resize(writers, max(64, len(writers))))
    assert eng.frontier_active(rows, mask) is None
    monkeypatch.setenv("EAGR_SPARSE_WRITE", "0")
    rows, mask = eng.plan.routes.writer_rows(writers[:4])
    assert eng.frontier_active(rows, mask) is None
    assert TF.frontier_summary([-1, 8, 16, 8]) == dict(
        steps=4, dense_steps=1, sparse_steps=3, p50_blocks=8, p99_blocks=16)


# --------------------------------------------------- sparse == dense, port
CASES = [
    ("sum", {}, False, TSpec("tuple", 4), 1),
    ("sum", {}, False, TSpec("time", 4, capacity=8), 1),
    ("sum", {"value_dim": 3}, False, TSpec("tuple", 4, value_dim=3), 3),
    ("count", {}, False, TSpec("tuple", 4), 1),
    ("count", {}, False, TSpec("time", 4, capacity=8), 1),
    ("avg", {}, False, TSpec("tuple", 4), 1),
    ("avg", {}, False, TSpec("time", 4, capacity=8), 1),
    ("max", {}, True, TSpec("tuple", 4), 1),
    ("max", {}, True, TSpec("time", 4, capacity=8), 1),
    ("min", {}, True, TSpec("tuple", 4), 1),
    ("min", {"value_dim": 2}, True, TSpec("time", 4, capacity=8,
                                          value_dim=2), 2),
    ("topk", {"k": 2, "domain": 8}, False, TSpec("tuple", 4), 1),
    ("topk", {"k": 2, "domain": 8}, False, TSpec("time", 4, capacity=8), 1),
]


def _stream(eng, n_batches=6, arrival=16, value_dim=1, seed=7, domain=8):
    writers = np.flatnonzero(eng.plan.routes.writer_row >= 0)
    rng = np.random.default_rng(seed)
    shape = (arrival,) if value_dim == 1 else (arrival, value_dim)
    return [(rng.choice(writers, arrival).astype(np.int64),
             rng.integers(0, domain, shape).astype(np.float32))
            for _ in range(n_batches)]


@pytest.mark.parametrize("agg,kw,all_push,spec,vdim", CASES,
                         ids=[f"{c[0]}-{c[3].kind}-{c[4]}" for c in CASES])
def test_sparse_bit_equal_to_dense(bases, monkeypatch, agg, kw, all_push,
                                   spec, vdim):
    """Writes and reads: the forced-sparse port equals the dense port bit
    for bit (state after every batch, answers of the sparse read)."""
    dense = _port(bases[1], agg=agg, spec=spec, all_push=all_push, **kw)
    sparse = _port(bases[1], agg=agg, spec=spec, all_push=all_push, **kw)
    readers = np.flatnonzero(dense.plan.routes.reader_node >= 0)[:24]
    for ids, vals in _stream(dense, value_dim=vdim):
        monkeypatch.setenv("EAGR_SPARSE_WRITE", "0")
        dense.write_batch(ids, vals)
        want = dense.read_batch(readers)
        monkeypatch.setenv("EAGR_SPARSE_WRITE", "1")
        sparse.write_batch(ids, vals)
        for x, y in zip(_state(dense), _state(sparse)):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(sparse.read_batch(readers), want)
    assert any(k >= 0 for k in sparse.frontier_log)
    assert all(k == -1 for k in dense.frontier_log)


@pytest.mark.parametrize("agg,kw,all_push,spec", [
    ("sum", {}, False, "tuple"), ("count", {}, False, "time"),
    ("max", {}, True, "tuple"), ("min", {}, True, "time"),
    ("avg", {}, False, "tuple")])
def test_sparse_answers_match_reference(bases, monkeypatch, agg, kw,
                                        all_push, spec):
    """Both packages forced sparse on one stream: max, min and count
    exactly, sums within 1e-4; the same active tuples on every step."""
    monkeypatch.setenv("EAGR_SPARSE_WRITE", "1")
    rs = RSpec("tuple", 4) if spec == "tuple" else RSpec("time", 4,
                                                         capacity=8)
    ts = TSpec("tuple", 4) if spec == "tuple" else TSpec("time", 4,
                                                         capacity=8)
    ref = _ref(bases[0], agg=agg, spec=rs, all_push=all_push, **kw)
    port = _port(bases[1], agg=agg, spec=ts, all_push=all_push, **kw)
    readers = np.flatnonzero(port.plan.routes.reader_node >= 0)[:32]
    for ids, vals in _stream(port):
        ref.write_batch(ids, vals)
        port.write_batch(ids, vals)
        want = np.asarray(ref.read_batch(readers))
        got = port.read_batch(readers)
        if agg in ("sum", "avg"):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_array_equal(got, want)
    assert ref.frontier_log == port.frontier_log


# ------------------------------------------------------ the active entry
@pytest.mark.parametrize("F", [1, 2, 3, 40])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_active_ref_bit_equal_to_level_with_identity(op, F):
    """On every row an active block routes to, the fused active plain
    version (gather, sign, reduce) equals the dense plain version over the
    level's gathered values with every inactive block's values set to the
    op's identity, and its row mask is exactly those rows — also with pad
    entries (== n_blocks), slots shuffled inside each tile's run, and a
    NaN at the source row padding slots point to (never reduced)."""
    rng = np.random.default_rng(F)
    n_rows, n_val = 700, 400
    plan = T.make_plan(rng.integers(0, n_rows, 9000), n_rows)
    nb = plan.tile_of_block.size
    seg = plan.seg_padded.copy()
    for t in np.unique(plan.tile_of_block):  # unsorted inside a tile's run
        b = np.flatnonzero(plan.tile_of_block == t)
        lo, hi = b[0] * T.E_BLK, (b[-1] + 1) * T.E_BLK
        seg[lo:hi] = seg[lo + rng.permutation(hi - lo)]
    live = seg >= 0
    src = np.where(live, rng.integers(1, n_val, seg.size), 0).astype(np.int32)
    sign = np.where(live, rng.choice([-1.0, 1.0], seg.size),
                    0.0).astype(np.float32)
    val = rng.normal(size=(n_val, F)).astype(np.float32)
    val[0] = np.nan  # the padding slots' source
    act = np.sort(rng.choice(nb, 9, replace=False))
    a = np.full(16, nb, np.int32)
    a[: act.size] = act
    x = val[src] * (sign[:, None] if op == "sum" else 1.0)
    x = -x if op == "min" else x
    ident = np.float32(0.0 if op == "sum" else NEG)
    xb = x.reshape(nb, T.E_BLK, F)
    xf = np.where(seg.reshape(nb, T.E_BLK, 1) >= 0, ident, np.nan)
    xf = np.broadcast_to(xf, xb.shape).copy().astype(np.float32)
    xf[act] = xb[act]
    seg_t = torch.as_tensor(seg)
    args = [torch.as_tensor(v) for v in (val, seg, src, sign,
                                         plan.tile_of_block,
                                         plan.first_of_tile, a)]
    got, hit = T.segment_agg_active(*args, n_rows=n_rows,
                                    n_row_tiles=plan.n_row_tiles, op=op)
    want = segment_agg_level_ref(torch.as_tensor(xf.reshape(-1, F)), seg_t,
                                 n_rows, "sum" if op == "sum" else "max")
    want = -want if op == "min" else want
    cov = np.zeros(n_rows + 1, bool)
    s_act = seg.reshape(nb, T.E_BLK)[act].ravel()
    cov[np.where(s_act >= 0, s_act, n_rows)] = True
    cov = torch.as_tensor(cov[:n_rows])
    assert int(cov.sum()) > 0
    assert torch.equal(hit, cov)
    assert torch.equal(got[cov], want[cov])
    got_r, hit_r = segment_agg_active_ref(*args[:4], args[6], n_rows, op)
    assert torch.equal(got_r, got) and torch.equal(hit_r, hit)


def test_active_entry_checks_its_arguments():
    plan = T.make_plan(np.arange(300) % 200, 200)
    E = plan.seg_padded.size
    tabs = [torch.as_tensor(plan.seg_padded), torch.zeros(E, dtype=torch.int32),
            torch.zeros(E), torch.as_tensor(plan.tile_of_block),
            torch.as_tensor(plan.first_of_tile)]
    val = torch.zeros((10, 1))
    act = torch.zeros(1, dtype=torch.int32)
    kw = dict(n_rows=200, n_row_tiles=plan.n_row_tiles)
    with pytest.raises(TypeError, match="active"):
        T.segment_agg_active(val, *tabs, act.long(), **kw)
    with pytest.raises(ValueError, match="shape mismatch"):
        T.segment_agg_active(val, tabs[0][:-1], *tabs[1:], act, **kw)
    with pytest.raises(TypeError, match="sign"):
        T.segment_agg_active(val, *tabs[:2], tabs[2].double(), *tabs[3:],
                             act, **kw)
    with pytest.raises(ValueError, match="unknown op"):
        T.segment_agg_active(val, *tabs, act, op="mean", **kw)


def test_sparse_parity_across_churn(monkeypatch):
    """Patch the plan, then write and read through both paths: the
    incrementally maintained index (exact per-writer overrides from the
    host graph walk, checked by the superset oracle under
    EAGR_PATCH_PARITY) keeps the sparse port bit-equal to the dense port."""
    from repro_torch import EagrSession, Query

    monkeypatch.setenv("EAGR_PATCH_PARITY", "1")

    def run(mode):
        monkeypatch.setenv("EAGR_SPARSE_WRITE", mode)
        sess = EagrSession(t_rmat(120, 700, seed=5), device="cpu")
        h = sess.register(Query(agg="sum", window=TSpec("tuple", 4)))
        m = sess.register(Query(agg="max", window=TSpec("tuple", 4)))
        rng = np.random.default_rng(11)
        writers = np.array(sorted(sess.writers))
        readers = np.array(sorted(sess.readers))
        reads = []
        for step in range(10):
            ids = rng.choice(writers, size=32).astype(np.int64)
            sess.update(ids, rng.integers(0, 8, 32).astype(np.float32))
            if step % 3 == 0:
                r = int(readers[step % len(readers)])
                nbrs = sess.neighborhood(r)
                if step % 2 and nbrs:
                    sess.delete_edge(min(nbrs), r)
                else:
                    w = int(writers[(step * 7) % len(writers)])
                    if w not in nbrs and w != r:
                        sess.add_edge(w, r)
                sess.flush()
            q = rng.choice(readers, 8, replace=False)
            reads.append((sess.read(h, q), sess.read(m, q)))
        return reads, [g.engine for g in sess._groups.values()]

    reads_d, engs_d = run("0")
    reads_s, engs_s = run("1")
    for (a, b), (c, d) in zip(reads_d, reads_s):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    for ed, es in zip(engs_d, engs_s):
        for x, y in zip(_state(ed), _state(es)):
            np.testing.assert_array_equal(x, y)
        assert es.plan.patches_applied > 0
        assert all(k >= 0 for k in es.frontier_log)
    assert any(es.plan.frontier is not None and es.plan.frontier.overrides
               for es in engs_s)


def test_reader_spans_cover_slots_churn_left_unsorted(bases):
    """Churn claims free slots anywhere in a tile's range, so a pull
    destination's slots stop being contiguous. Each reader's pull blocks
    must still cover every slot of every destination it demands (the
    superset the sparse read's exactness rests on). The port takes a
    destination's span as the min and max block over all its slots; the
    JAX package takes its first and last slot in slot order, which
    under-covers such a layout (its sparse read then leaves its dense
    read: ROADMAP.md §3)."""
    import jax.numpy as jnp

    br, bt = bases
    pr, pt = _ref(br).plan, _port(bt).plan
    rng = np.random.default_rng(9)
    seg = pt.arrays.pull.seg.numpy().copy()
    tob = pt.arrays.pull.tile_of_block.numpy()
    E = T.E_BLK
    for l in range(pt.depth):  # shuffle each tile's run, as churn leaves it
        for t in np.unique(tob[l]):
            b = np.flatnonzero(tob[l] == t)
            lo, hi = b[0] * E, (b[-1] + 1) * E
            seg[l, lo:hi] = seg[l, lo + rng.permutation(hi - lo)]
    pt.arrays = pt.arrays._replace(pull=pt.arrays.pull._replace(
        seg=torch.as_tensor(seg)))
    pr.arrays = pr.arrays._replace(pull=pr.arrays.pull._replace(
        seg=jnp.asarray(seg)))
    ft, fr = TF.ReaderFrontierIndex.build(pt), RF.ReaderFrontierIndex.build(pr)
    nb = ft.n_blocks
    need: dict[int, set[int]] = {}   # pull destination -> level*nb + block
    for l in range(pt.depth):
        for s in np.flatnonzero(seg[l] >= 0):
            need.setdefault(int(seg[l, s]), set()).add(l * nb + s // E)
    child: dict[int, set[int]] = {}  # demand pairs: destination -> sources
    dd, ds = pt.arrays.demand_dst.numpy(), pt.arrays.demand_src.numpy()
    for l in range(pt.depth):
        for a, b in zip(dd[l], ds[l]):
            if a < pt.meta.n_nodes:
                child.setdefault(int(a), set()).add(int(b))
    missing = {"port": 0, "reference": 0}
    for v in ft.pull_keys:
        down, stack = {v}, [v]
        while stack:
            for c in child.get(stack.pop(), ()):
                if c not in down:
                    down.add(c)
                    stack.append(c)
        for name, idx in (("port", ft), ("reference", fr)):
            have = set(idx.pull_keys.get(v, np.zeros(0, np.int64)).tolist())
            missing[name] += sum(not need[d] <= have for d in down
                                 if d in need)
    assert missing["port"] == 0
    assert missing["reference"] > 0


# ------------------------------------------- the reader index's CSR storage
def _dict_expand(idx, nodes, density=0.25):
    """The reader expansion as the JAX package computes it: a dict lookup
    per reader node over ``dem_keys``/``pull_keys``, then the same packing
    (with its own sticky widths)."""
    dk, pk = idx.dem_keys, idx.pull_keys
    d = [dk[int(v)] for v in nodes if int(v) in dk]
    p = [pk[int(v)] for v in nodes if int(v) in pk]
    dem_keys = np.unique(np.concatenate(d)) if d else np.zeros(0, np.int64)
    pull_keys = np.unique(np.concatenate(p)) if p else np.zeros(0, np.int64)
    floors = getattr(idx, "_test_floors", None)
    if floors is None:
        floors = idx._test_floors = (np.zeros(idx.n_levels, np.int64),
                                     np.zeros(idx.n_levels, np.int64))
    dem = TF._pack_active(dem_keys, idx.n_levels, idx.n_chunks, density,
                          floors=floors[0])
    pull = TF._pack_active(pull_keys, idx.n_levels, idx.n_blocks, density,
                           floors=floors[1])
    return None if dem is None or pull is None else (dem, pull)


@pytest.mark.parametrize("churned", [False, True])
def test_reader_csr_expand_equals_dict_expand(bases, churned):
    """``ReaderFrontierIndex.expand`` (one CSR gather per side) is array-equal
    to the per-reader dict expansion, batch after batch (sticky widths
    included), on a fresh plan and on a plan patched by churn."""
    if churned:
        from repro_torch import EagrSession, Query

        sess = EagrSession(t_rmat(150, 900, seed=3), device="cpu")
        h = sess.register(Query(agg="sum", window=TSpec("tuple", 4)))
        rng = np.random.default_rng(4)
        for _ in range(12):
            r = int(rng.choice(sess.readers))
            nb = sess.neighborhood(r)
            if rng.random() < 0.4 and nb:
                sess.delete_edge(min(nb), r)
            else:
                sess.add_edge(int(rng.choice(sess.writers)), r)
        sess.add_node(700, [sess.writers[0]], [sess.readers[1]])
        assert sess.flush().journal_nodes > 0
        plan = h.group.engine.plan
        assert plan.patches_applied > 0
    else:
        plan = _port(bases[1]).plan
    csr, ref = TF.ReaderFrontierIndex.build(plan), \
        TF.ReaderFrontierIndex.build(plan)
    assert not csr.dense_only and csr.pull_keys
    for v, keys in csr.pull_keys.items():
        assert keys.dtype == np.int64 and (np.diff(keys) > 0).all()
        assert csr.row_of_node[v] >= 0
    nodes = plan.routes.reader_node[plan.routes.reader_node >= 0]
    rng = np.random.default_rng(5)
    for k in (1, 4, 16, 64, len(nodes)):
        q = np.unique(rng.choice(nodes, k))
        for density in (0.25, None):
            a, b = csr.expand(q, density=density), \
                _dict_expand(ref, q, density=density)
            assert (a is None) == (b is None)
            if a is not None:
                for x, y in zip(a[0] + a[1], b[0] + b[1]):
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)


def test_step_costs_rule():
    """Auto's rule on the card: a sparse step wins only when its expansion
    plus host dispatch, and its device time at the batch's active blocks,
    are both below ``SPARSE_MARGIN`` times the dense step's cost (the larger
    of its host and device times); the same inputs give the same choice."""
    c = TE.StepCosts(per_row=1e-6, dense_host=2e-3, dense_dev=5e-3,
                     sparse_host=1e-3, sparse_dev=3e-3, blocks=100)
    assert c.dense == 5e-3 and TE.SPARSE_MARGIN == 0.8
    # 0.8 x 5 ms = 4 ms: the expansion and sparse dispatch must fit below
    assert c.worth_expanding(2900) and not c.worth_expanding(3100)
    assert c.sparse_wins(1000, 130) and not c.sparse_wins(1000, 140)
    assert not c.sparse_wins(3100, 1)
    host_bound = TE.StepCosts(1e-6, 2.5e-3, 3e-4, 3.5e-3, 4e-4, 600)
    assert not host_bound.worth_expanding(1)
    assert all(c.sparse_wins(1000, 100) for _ in range(3))


def test_stage_returns_equal_tensors():
    arrs = [(np.arange(5), np.int32), (np.array([True, False]), bool),
            (np.ones((3, 2)), np.float32), (np.zeros(0), np.int32)]
    out = TE.stage(arrs, torch.device("cpu"))
    for (a, dt), t in zip(arrs, out):
        assert t.numpy().dtype == np.dtype(dt)
        np.testing.assert_array_equal(t.numpy(), np.asarray(a, dt))


def test_auto_on_card_follows_measured_costs(bases, monkeypatch):
    """``auto``'s choice on the card, driven on the CPU with the timings
    given: the first batch times the plan's steps once (dense and sparse
    taking turns), later batches reuse the costs; a host-bound dense step
    keeps writes and reads dense, a device-bound one sends them sparse;
    the two caps still apply where set."""
    import types

    monkeypatch.setenv("EAGR_SPARSE_WRITE", "auto")
    eng = _port(bases[1], all_push=False)
    eng.device = types.SimpleNamespace(type="cuda")   # take the card's path
    calls = []

    def timed(dense, sparse):
        def fake(device, *runs):
            calls.append(len(runs))
            return [dense, sparse][: len(runs)]
        return fake

    writers = np.flatnonzero(eng.plan.routes.writer_row >= 0)
    rows, mask = eng.plan.routes.writer_rows(writers[:8])
    nodes = eng.plan.routes.reader_node[eng.plan.routes.reader_node >= 0][:8]
    # host-bound dense step (3 ms of dispatch): sparse dispatch 4 ms loses
    monkeypatch.setattr(TE, "_timed", timed((3e-3, 5e-4), (4e-3, 1e-4)))
    assert eng.frontier_active(rows, mask) is None
    assert eng._reader_active(nodes) is None
    assert calls == [2, 2] and eng.plan.write_costs.dense == 3e-3
    assert eng.frontier_active(rows, mask) is None and calls == [2, 2]
    # a device-bound dense step (50 ms on the card): sparse wins
    eng.plan.write_costs = eng.plan.read_costs = None
    monkeypatch.setattr(TE, "_timed", timed((1e-3, 5e-2), (1e-3, 1e-3)))
    act = eng.frontier_active(rows, mask)
    assert act is not None and len(act) == eng.plan.meta.n_levels
    assert eng._reader_active(nodes) is not None
    monkeypatch.setenv("EAGR_SPARSE_ROWFRAC", "0.0")
    assert eng.frontier_active(rows, mask) is None
    assert eng._reader_active(nodes) is None
    monkeypatch.delenv("EAGR_SPARSE_ROWFRAC")
    monkeypatch.setenv("EAGR_SPARSE_WRITE", "0")
    assert eng.frontier_active(rows, mask) is None
