"""bf16 edge values (``EAGR_SEGAGG_BF16=1``) in the port, against the JAX
package's bf16 mode on the CPU and against the port's own invariants.

Each slot's signed edge value is rounded to bfloat16 (to nearest even) and
then reduced in fp32. Checked here:

- each plain bf16 version (the fused active entry, the stacked dense and
  stacked active entries) against a numpy oracle that rounds on the bits,
  and against the JAX package's ``_level_reduce`` / ``_level_reduce_active``
  with ``PlanMeta.bf16``;
- the bf16 engine against the JAX package's: with ``backend="pallas"``
  (interpret mode, the TPU kernel's semantics) max, min and count bit-equal
  and sums within rtol = atol = 1e-2 (one bf16 ulp is 2^-8 relative, and
  the fp32 order of a sum can flip a later rounding between the packages);
  with ``backend="xla"`` the same bar, except that the JAX package's XLA
  path and its own kernel disagree on a max/min row whose every source
  holds the identity: XLA reduces the rounded identity, -3.0040553e38,
  while the kernel (and the port) start the row at -3e38 and keep it;
- sparse bf16 == dense bf16 and the stack (S = 2) == the host loop, bit
  for bit; the mode is not silently fp32;
- a JAX bf16 plan through ``convert.plan_from_reference``, and bf16
  checkpoints in both directions, the flag surviving save and restore.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import dataflow as RD  # noqa: E402
from repro.core import engine as RE  # noqa: E402
from repro.core.aggregates import make_aggregate as r_agg  # noqa: E402
from repro.core.bipartite import build_bipartite as r_bip  # noqa: E402
from repro.core.dynamic import DynamicOverlay as RDyn  # noqa: E402
from repro.core.vnm import construct_vnm as r_vnm  # noqa: E402
from repro.core.window import WindowSpec as RSpec  # noqa: E402
from repro.graphs.generators import rmat_graph as r_rmat  # noqa: E402
from repro.session import EagrSession as RSession  # noqa: E402
from repro.session import Query as RQuery  # noqa: E402
from repro_torch import EagrSession, Query, WindowSpec, convert  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core.aggregates import make_aggregate as t_agg  # noqa: E402
from repro_torch.core.bipartite import build_bipartite as t_bip  # noqa: E402
from repro_torch.core.dynamic import DynamicOverlay as TDyn  # noqa: E402
from repro_torch.core.vnm import construct_vnm as t_vnm  # noqa: E402
from repro_torch.distributed import eagr_shard as TS  # noqa: E402
from repro_torch.distributed.stacked import StackedShardedEngine  # noqa: E402
from repro_torch.graphs.generators import rmat_graph as t_rmat  # noqa: E402
from repro_torch.kernels.segment_agg import ops as SA  # noqa: E402
from repro_torch.kernels.segment_agg.ref import NEG  # noqa: E402

RTOL = ATOL = 1e-2   # sums against the JAX package (see the module doc)


def _round_bf16(x) -> np.ndarray:
    """The numpy oracle's rounding: fp32 to bfloat16, to nearest even, on
    the bits (finite inputs; a carry into the exponent rounds up)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


NEG_BF16 = float(_round_bf16(np.float32(NEG)))


@pytest.fixture
def bf16(monkeypatch):
    monkeypatch.setenv("EAGR_SEGAGG_BF16", "1")


# ---------------------------------------------------------- plain versions
def _level(rng, S=2, n_rows=600, L=2):
    """S aligned shards' leveled tables with ragged edge counts and a hub
    row, sources below 500 and signs of +-1 on live slots."""
    plans = []
    for _ in range(S):
        segs = []
        for _ in range(L):
            E = int(rng.integers(300, 2500))
            seg = rng.integers(0, n_rows, E)
            seg[: E // 4] = seg[0]
            segs.append(seg)
        plans.append(segs)
    nb = max(SA.make_leveled_plan(p, n_rows).tile_of_block.shape[1]
             for p in plans)
    lps = [SA.make_leveled_plan(p, n_rows, pad_levels=L, pad_blocks=nb)
           for p in plans]
    t = lambda f: torch.as_tensor(np.stack([getattr(p, f) for p in lps]))
    seg = t("seg")
    live = seg.numpy() >= 0
    src = np.where(live, rng.integers(0, 500, live.shape), 0)
    sign = np.where(live, rng.choice([-1.0, 1.0], live.shape), 0.0)
    return (seg, torch.as_tensor(src.astype(np.int32)),
            torch.as_tensor(sign.astype(np.float32)), t("tile_of_block"),
            t("first_of_tile"), lps[0].n_row_tiles, nb)


def _oracle(val, seg, src, sign, blocks, n_rows, op):
    """One shard's level over ``blocks`` in numpy: slot values gathered,
    signed (sum), rounded on the bits, negated (min), reduced per row in
    fp64 (sum) or exactly (max, min). Returns (out, hit, abs_sum)."""
    F = val.shape[1]
    slots = (np.asarray(blocks)[:, None] * SA.E_BLK
             + np.arange(SA.E_BLK)).reshape(-1)
    slots = slots[seg[slots] >= 0]
    x = val[src[slots]].astype(np.float32)
    if op == "sum":
        x = x * sign[slots][:, None]
    x = _round_bf16(x)
    rows = seg[slots]
    out = np.zeros((n_rows, F)) if op == "sum" else np.full((n_rows, F), -np.inf)
    mag = np.zeros((n_rows, F))
    if op == "sum":
        np.add.at(out, rows, x.astype(np.float64))
        np.add.at(mag, rows, np.abs(x).astype(np.float64))
    else:
        np.maximum.at(out, rows, -x if op == "min" else x)
        out = -out if op == "min" else out
    hit = np.zeros(n_rows, bool)
    hit[rows] = True
    return out, hit, mag


def _hold(got, want, hit, mag, op, n):
    """max/min exact on the rows the level routes to; sums within
    n * 2^-24 * sum|x| of the fp64 sum of the rounded values."""
    got = got.numpy()[hit]
    if op == "sum":
        bound = n * 2.0 ** -24 * mag[hit] + 1e-30
        assert (np.abs(got - want[hit]) <= bound).all()
    else:
        np.testing.assert_array_equal(got, want[hit].astype(np.float32))


@pytest.mark.parametrize("F", [1, 3])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_plain_bf16_entries_match_numpy_oracle(op, F):
    """The three fused plain versions with ``bf16=True`` against the numpy
    oracle, every level, dense and over ragged active lists; the rounding
    is visible (fp32 gives another answer) and the CPU counts no launch."""
    rng = np.random.default_rng(40 + F)
    seg, src, sign, tob, fot, nrt, nb = _level(rng)
    S, n_rows = seg.shape[0], 600
    kw = dict(n_rows=n_rows, n_row_tiles=nrt, op=op)
    SA.reset_launches()
    for l in range(seg.shape[1]):
        val = torch.as_tensor(rng.normal(size=(S, 500, F)) * 3,
                              dtype=torch.float32)
        tabs = (seg[:, l], src[:, l], sign[:, l], tob[:, l], fot[:, l])
        dense = SA.segment_agg_level_stacked(val, *tabs, bf16=True, **kw)
        fp32 = SA.segment_agg_level_stacked(val, *tabs, **kw)
        acts = [np.sort(rng.choice(nb, int(rng.integers(1, nb)),
                                   replace=False)) for _ in range(S)]
        K = max(len(a) for a in acts)
        act = torch.as_tensor(np.stack([
            np.pad(a, (0, K - len(a)), constant_values=nb) for a in acts])
            .astype(np.int32))
        sparse, shit = SA.segment_agg_active_stacked(val, *tabs, act,
                                                     bf16=True, **kw)
        for s in range(S):
            np_tabs = [t[s].numpy() for t in tabs[:3]]
            want, hit, mag = _oracle(val[s].numpy(), *np_tabs,
                                     np.arange(nb), n_rows, op)
            _hold(dense[s], want, hit, mag, op, nb * SA.E_BLK)
            assert not torch.equal(dense[s][torch.as_tensor(hit)],
                                   fp32[s][torch.as_tensor(hit)])
            want, hit, mag = _oracle(val[s].numpy(), *np_tabs, acts[s],
                                     n_rows, op)
            np.testing.assert_array_equal(shit[s].numpy(), hit)
            _hold(sparse[s], want, hit, mag, op, nb * SA.E_BLK)
            one, one_hit = SA.segment_agg_active(
                val[s], *(t[s] for t in tabs), act[s], bf16=True, **kw)
            assert torch.equal(one, sparse[s])
            assert torch.equal(one_hit, shit[s])
    assert sum(SA.LAUNCHES.values()) == 0


@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_plain_bf16_matches_jax_level_reduce(op):
    """The plain bf16 versions against the JAX package's XLA level
    functions with ``PlanMeta.bf16``: integers exact for every op, max and
    min exact on normal values, sums within rtol/atol 1e-5 of its fp32
    order."""
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    seg, src, sign, tob, fot, nrt, nb = _level(rng, S=1)
    n_rows, L = 600, seg.shape[1]
    meta = RE.PlanMeta(n_nodes=n_rows, n_writers=1, n_levels=L,
                       unroll_levels=0, n_row_tiles=nrt, backend="xla",
                       interpret=False, bf16=True)
    tables = RE.LevelTables(*(jnp.asarray(t[0].numpy()) for t in (
        seg, src, sign, tob, fot)), touched=jnp.ones((L, n_rows), bool))
    act = np.sort(rng.choice(nb, nb // 2, replace=False)).astype(np.int32)
    for integer in (True, False):
        val = (rng.integers(-300, 301, (500, 2)) if integer
               else rng.normal(size=(500, 2)) * 5).astype(np.float32)
        for l in range(L):
            tabs = (seg[:, l], src[:, l], sign[:, l], tob[:, l], fot[:, l])
            kw = dict(n_rows=n_rows, n_row_tiles=nrt, op=op, bf16=True)
            got = SA.segment_agg_level_stacked(
                torch.as_tensor(val)[None], *tabs, **kw)[0].numpy()
            want = np.asarray(RE._level_reduce(meta, tables, l,
                                               jnp.asarray(val), op))
            live = (seg[0, l].numpy() >= 0)
            rows = np.zeros(n_rows, bool)
            rows[seg[0, l].numpy()[live]] = True
            g = RE._gather_active(meta, tables, l, jnp.asarray(act))
            want_a = np.asarray(RE._level_reduce_active(
                meta, *g, jnp.asarray(val), op))
            hit_a = np.asarray(RE._row_active(meta, g[0]))
            got_a, got_hit = SA.segment_agg_active(
                torch.as_tensor(val), *(t[0] for t in tabs),
                torch.as_tensor(act), **kw)
            np.testing.assert_array_equal(got_hit.numpy(), hit_a)
            for a, b in ((got[rows], want[rows]),
                         (got_a.numpy()[hit_a], want_a[hit_a])):
                if integer or op != "sum":
                    np.testing.assert_array_equal(a, b)
                else:
                    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- the engine
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


def _decisions(basis, all_push=False):
    if all_push:
        return np.full(basis.n_nodes, RD.PUSH, np.int64)
    n = max((o for o in basis.origin if o >= 0), default=0) + 1
    wf = np.ones(n)
    return RD.decide_mincut(basis, wf, wf.copy(),
                            RD.cost_model_for("sum", window=4), window=4)[0]


def _spec(pkg, kind, vdim=1):
    S = RSpec if pkg == "r" else WindowSpec
    return (S("tuple", 4, value_dim=vdim) if kind == "tuple"
            else S("time", 4, capacity=8, value_dim=vdim))


def _port(basis, agg, kind="tuple", all_push=False, **kw):
    return TE.EagrEngine(basis, _decisions(basis, all_push),
                         t_agg(agg, **kw), _spec("t", kind), headroom=2.0,
                         device="cpu")


def _stream(writers, n_batches=5, arrival=16, seed=7, domain=8):
    """Values off the bf16 grid (k + 0.3), so the rounding shows."""
    rng = np.random.default_rng(seed)
    return [(rng.choice(writers, arrival).astype(np.int64),
             (rng.integers(0, domain, arrival) + 0.3).astype(np.float32))
            for _ in range(n_batches)]


def _assert_answers(got, want, agg, backend):
    """The bar against the JAX package (see the module doc): max, min and
    count exact, except XLA's rounded identity on a row that holds the
    identity in the port; every other aggregate within RTOL/ATOL."""
    got, want = np.asarray(got), np.asarray(want)
    if agg in ("max", "min", "count"):
        if backend == "xla" and agg != "count":
            ident = NEG if agg == "max" else -NEG
            moved = (got == ident) & (want == np.float32(
                NEG_BF16 if agg == "max" else -NEG_BF16))
            want = np.where(moved, got, want)
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


CASES = [("sum", "tuple", "pallas"), ("count", "time", "pallas"),
         ("max", "tuple", "pallas"), ("min", "time", "pallas"),
         ("sum", "time", "xla"), ("count", "tuple", "xla"),
         ("max", "time", "xla"), ("min", "tuple", "xla"),
         ("avg", "tuple", "xla")]


@pytest.mark.parametrize("agg,kind,backend", CASES,
                         ids=["-".join(c) for c in CASES])
def test_engine_bf16_matches_reference(bases, bf16, monkeypatch, agg, kind,
                                       backend):
    """Dense writes and reads of both packages in bf16 mode on one stream,
    min-cut decisions (push and pull levels): every answer held to the
    bar, and the rounding visible against the port's fp32 engine."""
    br, bt = bases
    ref = RE.EagrEngine(br, _decisions(br), r_agg(agg), _spec("r", kind),
                        headroom=2.0, backend=backend)
    port = _port(bt, agg, kind)
    assert ref.plan.meta.bf16 and port.plan.meta.bf16
    readers = np.flatnonzero(port.plan.routes.reader_node >= 0)[:48]
    writers = np.flatnonzero(port.plan.routes.writer_row >= 0)
    for ids, vals in _stream(writers):
        ref.write_batch(ids, vals)
        port.write_batch(ids, vals)
        _assert_answers(port.read_batch(readers), ref.read_batch(readers),
                        agg, backend)
    if agg != "count":
        monkeypatch.setenv("EAGR_SEGAGG_BF16", "0")
        fp32 = _port(bt, agg, kind)
        for ids, vals in _stream(writers):
            fp32.write_batch(ids, vals)
        assert not np.array_equal(fp32.read_batch(readers),
                                  port.read_batch(readers))


def _state(eng):
    s = eng.state
    return [*s.windows, s.pao, s.now]


@pytest.mark.parametrize("agg,kind,all_push", [
    ("sum", "tuple", False), ("count", "time", False),
    ("max", "tuple", True), ("min", "time", True),
    ("topk", "tuple", False)])
def test_sparse_bf16_bit_equal_to_dense_bf16(bases, bf16, monkeypatch, agg,
                                             kind, all_push):
    """Forced-sparse bf16 writes and reads equal the dense bf16 ones bit
    for bit (state after every batch, answers of the sparse read)."""
    kw = {"k": 2, "domain": 8} if agg == "topk" else {}
    dense = _port(bases[1], agg, kind, all_push, **kw)
    sparse = _port(bases[1], agg, kind, all_push, **kw)
    readers = np.flatnonzero(dense.plan.routes.reader_node >= 0)[:24]
    writers = np.flatnonzero(dense.plan.routes.writer_row >= 0)
    for ids, vals in _stream(writers, n_batches=6):
        if agg == "topk":
            vals = np.floor(vals)
        monkeypatch.setenv("EAGR_SPARSE_WRITE", "0")
        dense.write_batch(ids, vals)
        want = dense.read_batch(readers)
        monkeypatch.setenv("EAGR_SPARSE_WRITE", "1")
        sparse.write_batch(ids, vals)
        for x, y in zip(_state(dense), _state(sparse)):
            assert torch.equal(x, y)
        np.testing.assert_array_equal(sparse.read_batch(readers), want)
    assert any(k >= 0 for k in sparse.frontier_log)


# -------------------------------------------------------- stacked shards
@pytest.fixture(scope="module")
def world():
    bp = t_bip(t_rmat(400, 2400, seed=5))
    ov, _ = t_vnm(bp, variant="vnm_a", max_iterations=3, seed=0)
    return bp, TDyn.from_overlay(ov, bp.reader_input_sets()) \
        .to_overlay(prune=False)


@pytest.mark.parametrize("agg,kind", [("sum", "tuple"), ("count", "time"),
                                      ("max", "time"), ("min", "tuple")])
def test_stacked_bf16_bit_equal_to_host_loop(world, bf16, agg, kind):
    """A 2-shard stack in bf16 mode equals the per-shard host loop of
    single bf16 engines bit for bit, state and answers, sparse steps
    included."""
    bp, basis = world
    sh = TS.partition_overlay(basis, _decisions(basis, agg in ("max", "min")),
                              2, seed=1, device="cpu", headroom=2.0)
    assert all(p.meta.bf16 for p in sh.shard_plans)
    stacked = StackedShardedEngine(sh, t_agg(agg), _spec("t", kind),
                                   base_capacity=500)
    assert stacked.meta.bf16
    engines = []
    for s, p in enumerate(sh.shard_plans):
        plan = TE.plan_from_snapshot(*TE.plan_snapshot(p), device="cpu")
        assert plan.meta.bf16
        engines.append(TE.EagrEngine(sh.shards[s], plan.decision, t_agg(agg),
                                     _spec("t", kind), plan=plan,
                                     device="cpu"))
    rng = np.random.default_rng(10)
    for i in range(5):
        ids = rng.choice(bp.writers, 8 if i % 2 else 64)
        vals = (rng.standard_normal(len(ids)) * 3).astype(np.float32)
        stacked.write_batch(ids, vals, batch_size=64)
        TS.host_loop_write(sh, engines, ids, vals)
    st = stacked.state
    np.testing.assert_array_equal(
        st.pao.numpy(), np.stack([e.state.pao.numpy() for e in engines]))
    readers = rng.choice(sorted(sh.reader_shard), 40)
    np.testing.assert_array_equal(
        stacked.read_batch(readers, batch_size=40),
        TS.host_loop_read(sh, engines, readers))


def test_stack_refuses_mixed_bf16_shards(world, monkeypatch):
    """Shard plans that disagree on the flag do not stack."""
    _, basis = world
    sh = TS.partition_overlay(basis, _decisions(basis), 2, seed=1,
                              device="cpu", headroom=2.0)
    p = sh.shard_plans[1]
    p.meta = TE.dataclasses.replace(p.meta, bf16=True)
    with pytest.raises(ValueError, match="aligned"):
        StackedShardedEngine(sh, t_agg("sum"), _spec("t", "tuple"),
                             base_capacity=500)


# ------------------------------------------- plans and checkpoints cross
def test_reference_bf16_plan_converts(bases, bf16):
    """A plan the JAX package compiled in bf16 mode converts with its flag
    and runs the same answers as the JAX engine it came from."""
    br, bt = bases
    ref = RE.EagrEngine(br, _decisions(br), r_agg("max"), _spec("r", "tuple"),
                        headroom=2.0, backend="pallas")
    arrays, objs = RE.plan_snapshot(ref.plan)
    assert objs["meta"]["bf16"] is True
    plan = convert.plan_from_reference(arrays, objs, device="cpu")
    assert plan.meta.bf16 is True
    port = TE.EagrEngine(bt, plan.decision, t_agg("max"), _spec("t", "tuple"),
                         plan=plan, device="cpu")
    readers = np.flatnonzero(plan.routes.reader_node >= 0)[:48]
    for ids, vals in _stream(np.flatnonzero(plan.routes.writer_row >= 0)):
        ref.write_batch(ids, vals)
        port.write_batch(ids, vals)
    _assert_answers(port.read_batch(readers), ref.read_batch(readers), "max",
                    "pallas")


def _queries(pkg):
    Q, S = (RQuery, RSpec) if pkg == "r" else (Query, WindowSpec)
    return [Q(agg="sum", window=S("tuple", 4)),
            Q(agg="max", window=S("time", 3.0, capacity=8))]


def _updates(writers, rounds=4, seed=3):
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        yield (rng.choice(writers, 24),
               (rng.normal(size=24) * 4).astype(np.float32))


def _flags(sess):
    """The bf16 flags of every plan the session runs."""
    out = []
    for g in sess._groups.values():
        sh = getattr(g, "sharded", None)
        plans = sh.shard_plans if sh is not None else [g.engine.plan]
        out += [p.meta.bf16 for p in plans]
    return out


@pytest.mark.parametrize("shards", [None, 2], ids=["single", "sharded"])
def test_reference_bf16_checkpoint_restores_in_port(tmp_path, bf16, shards):
    """A checkpoint the JAX package saved in bf16 mode restores in the port
    in bf16 mode (same layout: plans taken verbatim), with the JAX
    session's answers."""
    ref = RSession(r_rmat(300, 1800, seed=7), shards=shards, backend="xla")
    hs = [ref.register(q) for q in _queries("r")]
    for ids, vals in _updates(np.asarray(ref.writers)):
        ref.update(ids, vals)
    ref.save(str(tmp_path), blocking=True)
    port = EagrSession.restore(str(tmp_path), device="cpu")
    assert _flags(port) and all(_flags(port))
    q = np.random.default_rng(2).choice(np.asarray(port.readers), 32)
    for h, t, agg in zip(hs, port.queries, ("sum", "max")):
        _assert_answers(port.read(t, q), ref.read(h, q), agg, "xla")


@pytest.mark.parametrize("shards", [None, 2], ids=["single", "sharded"])
def test_port_bf16_checkpoint_restores_in_reference(tmp_path, bf16, shards):
    """A port session in bf16 mode saves its flag; the JAX package restores
    it in bf16 mode with the port's answers, and so does the port itself,
    bit for bit."""
    port = EagrSession(t_rmat(300, 1800, seed=7), shards=shards,
                       device="cpu")
    ts = [port.register(q) for q in _queries("t")]
    assert _flags(port) and all(_flags(port))
    for ids, vals in _updates(np.asarray(port.writers)):
        port.update(ids, vals)
    port.save(str(tmp_path), blocking=True)
    q = np.random.default_rng(2).choice(np.asarray(port.readers), 32)
    back = EagrSession.restore(str(tmp_path), device="cpu")
    assert all(_flags(back))
    for a, b in zip(port.queries, back.queries):
        np.testing.assert_array_equal(back.read(b, q), port.read(a, q))
    ref = RSession.restore(str(tmp_path))
    for g in ref._groups.values():
        sh = getattr(g, "sharded", None)
        plans = sh.shard_plans if sh is not None else [g.engine.plan]
        assert all(p.meta.bf16 for p in plans)
    for h, t, agg in zip(ref.queries, ts, ("sum", "max")):
        _assert_answers(port.read(t, q), ref.read(h, q), agg, "xla")


@pytest.mark.parametrize("shards", [None, 2], ids=["single", "sharded"])
def test_session_bf16_differs_from_fp32_within_bar(monkeypatch, shards):
    """The same stream through a bf16 and an fp32 session: answers differ
    in at least one reader (the mode is not silently fp32), sums within
    the reference's rtol 0.05 / atol 0.5 of fp32 and max within one bf16
    ulp."""
    out = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("EAGR_SEGAGG_BF16", flag)
        sess = EagrSession(t_rmat(300, 1800, seed=7), shards=shards,
                           device="cpu")
        hs = [sess.register(q) for q in _queries("t")]
        assert all(f == (flag == "1") for f in _flags(sess))
        for ids, vals in _updates(np.asarray(sess.writers)):
            sess.update(ids, vals)
        q = np.asarray(sess.readers)
        out[flag] = [np.asarray(sess.read(h, q)) for h in hs]
    (s16, m16), (s32, m32) = out["1"], out["0"]
    assert not np.array_equal(s16, s32)
    np.testing.assert_allclose(s16, s32, rtol=0.05, atol=0.5)
    # one bf16 ulp at |m|: 2^(e - 8) for |m| = f * 2^e, f in [0.5, 1)
    ulp = np.ldexp(1.0, np.frexp(np.abs(m32))[1] - 8)
    assert (np.abs(m16.astype(np.float64) - m32) <= ulp).all()
