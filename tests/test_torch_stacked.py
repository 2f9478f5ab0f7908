"""The port's stacked shard engine (``repro_torch.distributed.stacked``): bit
for bit equal to the per-shard host loop of single engines for every
combine and window kind, the same answers as the JAX package's
``StackedShardedEngine`` (``backend="xla"`` on the CPU), sparse equal to
dense, slice patches in place and the growth fallback, out-of-range ids
dropped and unknown readers raising, stacked alerts firing the JAX
package's sets, the ingest ring equal to the synchronous path, and a
sharded ``EagrSession`` against the JAX package's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import dataflow as RD  # noqa: E402
from repro.core.aggregates import make_aggregate as r_agg  # noqa: E402
from repro.core.bipartite import build_bipartite as r_bip  # noqa: E402
from repro.core.dynamic import DynamicOverlay as RDyn  # noqa: E402
from repro.core.vnm import construct_vnm as r_vnm  # noqa: E402
from repro.core.window import WindowSpec as RSpec  # noqa: E402
from repro.distributed import eagr_shard as RS  # noqa: E402
from repro.distributed.stacked import StackedShardedEngine as RStacked  # noqa: E402
from repro.graphs.generators import rmat_graph as r_rmat  # noqa: E402
from repro.session import EagrSession as RSession  # noqa: E402
from repro.session import Query as RQuery  # noqa: E402
from repro.streams.alerts import AlertSet as RAlertSet  # noqa: E402
from repro.streams.alerts import AlertSpec as RAlertSpec  # noqa: E402
from repro_torch import EagrSession, Query, WindowSpec  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core.aggregates import make_aggregate as t_agg  # noqa: E402
from repro_torch.core.bipartite import build_bipartite as t_bip  # noqa: E402
from repro_torch.core.dynamic import DynamicOverlay as TDyn  # noqa: E402
from repro_torch.core.vnm import construct_vnm as t_vnm  # noqa: E402
from repro_torch.distributed import eagr_shard as TS  # noqa: E402
from repro_torch.distributed.stacked import StackedShardedEngine  # noqa: E402
from repro_torch.graphs.generators import rmat_graph as t_rmat  # noqa: E402
from repro_torch.kernels.segment_agg import ops as SA  # noqa: E402
from repro_torch.streams import IngestPipeline  # noqa: E402
from repro_torch.streams.alerts import AlertSet, AlertSpec  # noqa: E402

N_SHARDS = 3


def _world(n=400, e=2400, seed=5):
    out = []
    for rmat, bip, vnm, dyn in ((r_rmat, r_bip, r_vnm, RDyn),
                                (t_rmat, t_bip, t_vnm, TDyn)):
        bp = bip(rmat(n, e, seed=seed))
        ov, _ = vnm(bp, variant="vnm_a", max_iterations=3, seed=0)
        out.append((bp, dyn.from_overlay(ov, bp.reader_input_sets())
                    .to_overlay(prune=False)))
    (bpr, br), (bpt, bt) = out
    return bpr, br, bpt, bt


@pytest.fixture(scope="module")
def world():
    return _world()


def _decisions(basis, all_push=False):
    if all_push:
        return np.full(basis.n_nodes, RD.PUSH, np.int64)
    wf = np.ones(max(o for o in basis.origin if o >= 0) + 1)
    return RD.decide_mincut(basis, wf, wf.copy(),
                            RD.cost_model_for("sum", window=4), window=4)[0]


def _spec(kind, pkg):
    S = RSpec if pkg == "r" else WindowSpec
    return S("tuple", 4) if kind == "tuple" else S("time", 3.0, capacity=8)


def _port_shards(world, agg="sum", kind="tuple", seed=1, all_push=False,
                 headroom=2.0):
    _, _, _, bt = world
    sh = TS.partition_overlay(bt, _decisions(bt, all_push), N_SHARDS,
                              seed=seed, device="cpu", headroom=headroom)
    return sh, StackedShardedEngine(sh, t_agg(agg), _spec(kind, "t"),
                                    base_capacity=500)


def _host_engines(sh, agg, kind):
    """Per-shard single engines over copies of the aligned plans."""
    engines = []
    for s, p in enumerate(sh.shard_plans):
        arrays, objs = TE.plan_snapshot(p)
        plan = TE.plan_from_snapshot(arrays, objs, device="cpu")
        engines.append(TE.EagrEngine(sh.shards[s], plan.decision, t_agg(agg),
                                     _spec(kind, "t"), plan=plan,
                                     device="cpu"))
    return engines


def _batches(bp, n_batches, B=64, seed=10, integral=False):
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        ids = rng.choice(bp.writers, B)
        vals = rng.integers(-4, 5, B).astype(np.float32) if integral \
            else rng.standard_normal(B).astype(np.float32)
        yield ids, vals


def _stacked_state(eng):
    st = eng.state
    return [t.numpy().copy() for t in (*st.windows, st.pao, st.now)]


def _host_state(engines):
    out = []
    for i in range(4):
        out.append(np.stack([e.state.windows[i].numpy() for e in engines]))
    out.append(np.stack([e.state.pao.numpy() for e in engines]))
    out.append(np.stack([e.state.now.numpy() for e in engines]))
    return out


# ---------------------------------------------------- stacked == host loop
@pytest.mark.parametrize("agg", ["sum", "count", "max", "min"])
@pytest.mark.parametrize("kind", ["tuple", "time"])
def test_stacked_bit_equal_to_host_loop(world, agg, kind):
    bp = world[2]
    sh, stacked = _port_shards(world, agg, kind)
    engines = _host_engines(sh, agg, kind)
    SA.reset_launches()
    for ids, vals in _batches(bp, 5):
        stacked.write_batch(ids, vals, batch_size=64)
        TS.host_loop_write(sh, engines, ids, vals)
    for a, b in zip(_stacked_state(stacked), _host_state(engines)):
        np.testing.assert_array_equal(a, b)
    readers = np.random.default_rng(3).choice(sorted(sh.reader_shard), 40)
    np.testing.assert_array_equal(
        stacked.read_batch(readers, batch_size=40),
        TS.host_loop_read(sh, engines, readers))
    # the CPU runs the plain versions: no kernel launch is counted
    assert sum(SA.LAUNCHES.values()) == 0


@pytest.mark.parametrize("agg", ["sum", "max"])
def test_stacked_answers_equal_reference(world, agg):
    bpr, br, bpt, bt = world
    dec = _decisions(br)
    sr = RS.partition_overlay(br, dec, N_SHARDS, seed=1, backend="xla",
                              headroom=2.0)
    ref = RStacked(sr, r_agg(agg), RSpec("tuple", 4), base_capacity=500)
    sh, port = _port_shards(world, agg)
    np.testing.assert_array_equal(np.asarray(ref.writer_map),
                                  port.writer_map.numpy())
    np.testing.assert_array_equal(np.asarray(ref.reader_map),
                                  port.reader_map.numpy())
    np.testing.assert_array_equal(ref._reader_known, port._reader_known)
    for ids, vals in _batches(bpt, 5, integral=agg == "max"):
        ref.write_batch(ids, vals, batch_size=64)
        port.write_batch(ids, vals, batch_size=64)
    readers = np.random.default_rng(4).choice(sorted(sh.reader_shard), 48)
    want = np.asarray(ref.read_batch(readers, batch_size=48))
    got = port.read_batch(readers, batch_size=48)
    if agg == "max":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("agg", ["sum", "max"])
def test_stacked_sparse_equals_dense(world, agg, monkeypatch):
    bp = world[2]
    states = []
    for mode in ("0", "1"):
        monkeypatch.setenv("EAGR_SPARSE_WRITE", mode)
        sh, eng = _port_shards(world, agg, all_push=True)
        for ids, vals in _batches(bp, 4, B=16):
            if mode == "1":
                assert eng._frontier_active(ids) is not None
            eng.write_batch(ids, vals, batch_size=16)
        states.append(_stacked_state(eng))
    for a, b in zip(*states):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ churn
def _churn(sd, bp, rng, readers):
    for _ in range(4):
        sd.add_edge(int(rng.choice(bp.writers)), int(rng.choice(readers)))
    v = int(rng.choice(readers))
    sd.delete_edge(min(bp.reader_input_sets()[v]), v)


def test_slice_patch_in_place_and_equal_to_host_loop(world):
    """In-capacity churn writes into the stacked tables' storage (the
    ``data_ptr`` of every table and owner map is unchanged), the shard
    plans stay views of the stack, and the stack keeps equal to host-loop
    engines patched through the same deltas."""
    bp = world[2]
    sh, stacked = _port_shards(world, "sum", headroom=4.0)
    sh_h, _ = _port_shards(world, "sum", headroom=4.0)
    engines = _host_engines(sh_h, "sum", "tuple")
    sd = TS.ShardedDynamic(sh, stacked)
    sd_h = TS.ShardedDynamic(sh_h, engines)
    ptrs = {k: v.data_ptr() for k, v in TE._plan_array_leaves(stacked.arrays)}
    ptrs["wmap"] = stacked.writer_map.data_ptr()
    ptrs["rmap"] = stacked.reader_map.data_ptr()
    readers = sorted(sh.reader_shard)
    batches = _batches(bp, 9)
    for burst in range(3):
        ids, vals = next(batches)
        stacked.write_batch(ids, vals, batch_size=64)
        TS.host_loop_write(sh_h, engines, ids, vals)
        _churn(sd, bp, np.random.default_rng(burst), readers)
        _churn(sd_h, bp, np.random.default_rng(burst), readers)
        res = sd.apply()
        sd_h.apply()
        assert any(r is not None for r in res)
        assert not any(r is not None and r.recompiled for r in res)
    now = {k: v.data_ptr() for k, v in TE._plan_array_leaves(stacked.arrays)}
    now["wmap"] = stacked.writer_map.data_ptr()
    now["rmap"] = stacked.reader_map.data_ptr()
    assert now == ptrs
    for s, p in enumerate(sh.shard_plans):
        assert p.arrays.push.seg.data_ptr() == \
            stacked.arrays.push.seg[s].data_ptr()
    for ids, vals in [next(batches) for _ in range(3)]:
        stacked.write_batch(ids, vals, batch_size=64)
        TS.host_loop_write(sh_h, engines, ids, vals)
    q = np.random.default_rng(9).choice(sorted(sh.reader_shard), 40)
    np.testing.assert_array_equal(stacked.read_batch(q, batch_size=40),
                                  TS.host_loop_read(sh_h, engines, q))


def test_growth_fallback_restacks(world):
    """A patch past the padded shape recompiles its shard, realigns every
    shard to the grown shape and restacks; answers stay those of a fresh
    single engine over the same churned graph's shards."""
    bpr, br, bp, bt = world
    sh, stacked = _port_shards(world, "max", headroom=1.0)
    shape0 = TE.plan_dims(sh.shard_plans[0])
    sd = TS.ShardedDynamic(sh, stacked)
    for ids, vals in _batches(bp, 2, integral=True):
        stacked.write_batch(ids, vals, batch_size=64)
    readers = sorted(sh.reader_shard)
    rng = np.random.default_rng(2)
    new = max(bp.writers) + 1
    for k in range(40):  # a burst of new writers overflows writer capacity
        sd.add_node(new + k, set(), {int(rng.choice(readers))})
    res = sd.apply()
    assert any(r is not None and r.recompiled for r in res)
    assert TE.plan_dims(sh.shard_plans[0]) != shape0
    assert len({TE.plan_dims(p) for p in sh.shard_plans}) == 1
    assert stacked.arrays.push.seg.shape[1:] == \
        sh.shard_plans[0].arrays.push.seg.shape
    ids = np.concatenate([np.arange(new, new + 40), bp.writers[:24]])
    vals = np.arange(64, dtype=np.float32)
    stacked.write_batch(ids, vals, batch_size=64)
    engines = _host_engines(sh, "max", "tuple")
    for e, s in zip(engines, range(N_SHARDS)):
        e.adopt_state(TE.EngineState(
            type(stacked.state.windows)(*(x[s].clone() for x in
                                          stacked.state.windows)),
            stacked.state.pao[s].clone(), stacked.state.now[s].clone()),
            now_host=stacked._now_host, last_eval_now=stacked._now_host)
    q = np.asarray(readers[:40])
    np.testing.assert_array_equal(stacked.read_batch(q, batch_size=40),
                                  TS.host_loop_read(sh, engines, q))


def test_out_of_range_ids_dropped_and_unknown_reader_raises(world):
    sh, stacked = _port_shards(world, "sum")
    before = stacked.state.windows.count.clone()
    stacked.write_batch(np.array([-1, 10 ** 9, stacked._base_cap]),
                        np.array([5.0, 7.0, 1.0], np.float32), batch_size=4)
    assert torch.equal(before, stacked.state.windows.count)
    assert stacked._now_host == 1.0
    bad = max(sh.reader_shard) + 700
    with pytest.raises(ValueError, match="owned by no shard"):
        stacked.read_batch(np.array([min(sh.reader_shard), bad]))
    with pytest.raises(ValueError, match="owned by no shard"):
        stacked.read_batch(np.array([-3]))


# ----------------------------------------------------------------- alerts
def test_stacked_alerts_fire_the_reference_sets(world):
    bpr, br, bpt, bt = world
    dec = _decisions(br, all_push=True)
    sr = RS.partition_overlay(br, dec, N_SHARDS, seed=1, backend="xla")
    ref = RStacked(sr, r_agg("sum"), RSpec("tuple", 4), base_capacity=500)
    sh, port = _port_shards(world, "sum", all_push=True)
    bases = sorted(sh.reader_shard)[::2]
    ar, at = RAlertSet(cap=8), AlertSet(cap=8)
    ar.register(0, RAlertSpec(above=1.5, hysteresis=0.5), bases,
                dynamic=False)
    at.register(0, AlertSpec(above=1.5, hysteresis=0.5), bases,
                dynamic=False)
    ref.attach_alerts(ar)
    port.attach_alerts(at)
    n_fired = 0
    for ids, vals in _batches(bpt, 8, integral=True):
        ref.write_batch(ids, vals, batch_size=64)
        port.write_batch(ids, vals, batch_size=64)
        ar.collect()
        at.collect()
        fr, ft = ar.pop_fired(), at.pop_fired()
        assert len(fr) == len(ft)
        for a, b in zip(fr, ft):
            assert a.now == b.now and a.overflow == b.overflow
            np.testing.assert_array_equal(a.base_ids, b.base_ids)
            np.testing.assert_array_equal(a.aids, b.aids)
            np.testing.assert_allclose(a.values, b.values, rtol=1e-5)
            n_fired += len(b)
    assert n_fired > 0


# ------------------------------------------------------------------ ring
def test_stacked_ring_equals_synchronous_path(world):
    bp = world[2]
    _, piped = _port_shards(world, "sum")
    _, sync = _port_shards(world, "sum")
    pipe = IngestPipeline([piped], depth=2, device_batch=32)
    stream = list(_batches(bp, 6, B=48, seed=4))
    ids = np.concatenate([i for i, _ in stream])
    vals = np.concatenate([v for _, v in stream])
    for i, v in stream:
        pipe.submit(i, v)
    pipe.flush()
    for k in range(0, len(ids), 32):
        sync.write_batch(ids[k: k + 32], vals[k: k + 32], batch_size=32)
    for a, b in zip(_stacked_state(piped), _stacked_state(sync)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- session
def test_sharded_session_equals_reference():
    """EagrSession(shards=3) in both packages on one stream: plan tables,
    owner maps and decisions bit-equal; max and count exact, sums within
    1e-4; churn and flush land the same plans."""
    g_r, g_t = r_rmat(400, 2400, seed=8), t_rmat(400, 2400, seed=8)
    ref = RSession(g_r, shards=3, backend="xla")
    port = EagrSession(g_t, shards=3, device="cpu")
    qs = [("sum", RSpec("tuple", 4), WindowSpec("tuple", 4)),
          ("max", RSpec("tuple", 4), WindowSpec("tuple", 4)),
          ("count", RSpec("time", 3.0, capacity=8),
           WindowSpec("time", 3.0, capacity=8))]
    hs = [(ref.register(RQuery(agg=a, window=rw)),
           port.register(Query(agg=a, window=tw)), a) for a, rw, tw in qs]
    assert port.stats().n_shards == 3
    rng = np.random.default_rng(0)
    W, R = np.asarray(port.writers), np.asarray(port.readers)
    for step in range(6):
        ids = rng.choice(W, 64)
        vals = rng.integers(-3, 6, 64).astype(np.float32)
        ref.update(ids, vals)
        port.update(ids, vals)
        if step == 2:
            for s in (ref, port):
                s.add_edge(int(W[0]), int(R[5]))
                s.delete_edge(min(s.neighborhood(int(R[7]))), int(R[7]))
            rr, rt = ref.flush(), port.flush()
            assert (rt.patched, rt.relayout, rt.recompiled) == \
                (rr.patched, rr.relayout, rr.recompiled)
    q = rng.choice(R, 48)
    for hr, ht, a in hs:
        want, got = np.asarray(ref.read(hr, q)), port.read(ht, q)
        if a == "sum":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_array_equal(got, want)
    for (hr, ht, _) in hs:
        er, et = hr.group.engine, ht.group.engine
        np.testing.assert_array_equal(np.asarray(er.writer_map),
                                      et.writer_map.numpy())
        np.testing.assert_array_equal(np.asarray(er.reader_map),
                                      et.reader_map.numpy())
        np.testing.assert_array_equal(hr.group.dec_global,
                                      ht.group.dec_global)
        for pr, pt in zip(er.shard_plans, et.shard_plans):
            from repro.core import engine as RE
            ar, _ = RE.plan_snapshot(pr)
            at, _ = TE.plan_snapshot(pt)
            assert ar.keys() == at.keys()
            for k in ar:
                np.testing.assert_array_equal(np.asarray(ar[k]), at[k],
                                              err_msg=k)


# ------------------------------------------------- the shard-batched entries
def _stacked_level(rng, S=3, n_rows=700, L=3):
    """S aligned shards' leveled tables (the stacked (S, L, ...) layout),
    ragged edge counts and a hub row."""
    plans = []
    for _ in range(S):
        segs = []
        for _ in range(L):
            E = int(rng.integers(300, 3000))
            seg = rng.integers(0, n_rows, E)
            seg[: E // 4] = seg[0]
            segs.append(seg)
        plans.append(segs)
    nb = max(SA.make_leveled_plan(p, n_rows).tile_of_block.shape[1]
             for p in plans)
    lps = [SA.make_leveled_plan(p, n_rows, pad_levels=4, pad_blocks=nb)
           for p in plans]
    t = lambda f: torch.as_tensor(np.stack([getattr(p, f) for p in lps]))
    return t("seg"), t("tile_of_block"), t("first_of_tile"), \
        lps[0].n_row_tiles, nb


def _stacked_sources(rng, seg, n_val):
    """Sources and signs for stacked seg tables: live slots draw a source
    row below ``n_val`` and a sign of +-1, padding slots 0 and 0."""
    live = seg.numpy() >= 0
    src = np.where(live, rng.integers(0, n_val, live.shape), 0)
    sign = np.where(live, rng.choice([-1.0, 1.0], live.shape), 0.0)
    return (torch.as_tensor(src.astype(np.int32)),
            torch.as_tensor(sign.astype(np.float32)))


def _ragged_active(rng, S, nb):
    """Each shard's ascending active blocks, padded with ``nb`` to the
    widest shard's count (at least 1)."""
    acts = [np.sort(rng.choice(nb, int(rng.integers(0, nb)), replace=False))
            for _ in range(S)]
    K = max(1, max(len(a) for a in acts))
    return torch.as_tensor(np.stack([
        np.pad(a, (0, K - len(a)), constant_values=nb) for a in acts])
        .astype(np.int32))


def _gathered(val, src, sign, op):
    """One shard's slot values as the engine's single-shard level gathers
    them: ``val[src] * sign`` for sum, ``val[src]`` for max, ``-val[src]``
    for min."""
    x = val.index_select(0, src.long())
    return x * sign[:, None] if op == "sum" else (-x if op == "min" else x)


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("F", [1, 3, 40])
def test_stacked_entries_equal_per_shard_plain(op, F):
    """On CPU tensors the stacked entries run the plain version shard by
    shard (a strided level of the (S, L, ...) tables, values gathered by
    src, min beside max): the dense entry's shard output equals the
    single-shard dense wrapper's on that shard's gathered values
    (``val[src] * sign``, or ``-val[src]`` negated back for min), and the
    fused active entry's the single-shard active wrapper's with ragged
    sentinel-padded lists, its row mask too; no launch is counted."""
    rng = np.random.default_rng(F)
    seg, tob, fot, nrt, nb = _stacked_level(rng)
    S, n_rows, n_val = seg.shape[0], 700, 600
    src, sign = _stacked_sources(rng, seg, n_val)
    SA.reset_launches()
    for l in range(3):
        s_l, t_l, f_l = seg[:, l], tob[:, l], fot[:, l]
        assert s_l.stride(0) == 4 * nb * SA.E_BLK   # a strided view
        val = torch.as_tensor(rng.standard_normal((S, n_val, F)),
                              dtype=torch.float32)
        tabs = (s_l, src[:, l], sign[:, l], t_l, f_l)
        ops = (op, "min") if op == "max" else (op,)
        for dop in ops:
            out = SA.segment_agg_level_stacked(val, *tabs, n_rows=n_rows,
                                               n_row_tiles=nrt, op=dop)
            assert out.shape == (S, n_rows, F)
            for s in range(S):
                x = _gathered(val[s], src[s, l], sign[s, l], dop)
                want = SA.segment_agg_level(
                    x, s_l[s], t_l[s], f_l[s], n_rows=n_rows,
                    n_row_tiles=nrt, op="sum" if dop == "sum" else "max")
                assert torch.equal(out[s], -want if dop == "min" else want)
        act = _ragged_active(rng, S, nb)
        for aop in ops:
            out, hit = SA.segment_agg_active_stacked(
                val, *tabs, act, n_rows=n_rows, n_row_tiles=nrt, op=aop)
            assert out.shape == (S, n_rows, F) and hit.shape == (S, n_rows)
            for s in range(S):
                want, want_hit = SA.segment_agg_active(
                    val[s], *(t[s] for t in tabs), act[s], n_rows=n_rows,
                    n_row_tiles=nrt, op=aop)
                assert torch.equal(out[s], want)
                assert torch.equal(hit[s], want_hit)
    assert sum(SA.LAUNCHES.values()) == 0


@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_stacked_active_plain_matches_jax_composition(op):
    """The stacked fused plain version against the JAX package's
    frontier-sparse level (``_gather_active`` + ``_level_reduce_active`` +
    ``_row_active``, ``backend="xla"``) on each shard's slice: row masks
    equal; values on those rows exact on integers (every op), sums of
    normal values within rtol/atol 1e-4, max and min exact."""
    import jax.numpy as jnp
    from repro.core import engine as RE

    rng = np.random.default_rng(7)
    seg, tob, fot, nrt, nb = _stacked_level(rng)
    S, n_rows, n_val, F = seg.shape[0], 700, 600, 2
    src, sign = _stacked_sources(rng, seg, n_val)
    meta = RE.PlanMeta(n_nodes=n_rows, n_writers=1, n_levels=4,
                       unroll_levels=0, n_row_tiles=nrt, backend="xla",
                       interpret=False)
    act = _ragged_active(rng, S, nb)
    for integer in (True, False):
        val = (rng.integers(-8, 9, (S, n_val, F)) if integer
               else rng.normal(size=(S, n_val, F))).astype(np.float32)
        for l in range(3):
            out, hit = SA.segment_agg_active_stacked(
                torch.as_tensor(val), seg[:, l], src[:, l], sign[:, l],
                tob[:, l], fot[:, l], act, n_rows=n_rows, n_row_tiles=nrt,
                op=op)
            for s in range(S):
                tables = RE.LevelTables(*(jnp.asarray(t[s].numpy()) for t in (
                    seg, src, sign, tob, fot)),
                    touched=jnp.ones((4, n_rows), bool))
                g = RE._gather_active(meta, tables, l,
                                      jnp.asarray(act[s].numpy()))
                want = np.asarray(RE._level_reduce_active(
                    meta, *g, jnp.asarray(val[s]), op))
                want_hit = np.asarray(RE._row_active(meta, g[0]))
                np.testing.assert_array_equal(hit[s].numpy(), want_hit)
                got = out[s].numpy()[want_hit]
                if integer or op != "sum":
                    np.testing.assert_array_equal(got, want[want_hit])
                else:
                    np.testing.assert_allclose(got, want[want_hit],
                                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_stacked_dense_plain_matches_jax_composition(op):
    """The stacked dense plain version against the JAX package's dense
    level (``_level_reduce``, ``backend="xla"``) on each shard's slice, on
    the rows some live slot routes to: exact on integers (every op), sums
    of normal values within rtol/atol 1e-4, max and min exact."""
    import jax.numpy as jnp
    from repro.core import engine as RE

    rng = np.random.default_rng(11)
    seg, tob, fot, nrt, nb = _stacked_level(rng)
    S, n_rows, n_val, F = seg.shape[0], 700, 600, 2
    src, sign = _stacked_sources(rng, seg, n_val)
    meta = RE.PlanMeta(n_nodes=n_rows, n_writers=1, n_levels=4,
                       unroll_levels=0, n_row_tiles=nrt, backend="xla",
                       interpret=False)
    for integer in (True, False):
        val = (rng.integers(-8, 9, (S, n_val, F)) if integer
               else rng.normal(size=(S, n_val, F))).astype(np.float32)
        for l in range(3):
            out = SA.segment_agg_level_stacked(
                torch.as_tensor(val), seg[:, l], src[:, l], sign[:, l],
                tob[:, l], fot[:, l], n_rows=n_rows, n_row_tiles=nrt, op=op)
            for s in range(S):
                tables = RE.LevelTables(*(jnp.asarray(t[s].numpy()) for t in (
                    seg, src, sign, tob, fot)),
                    touched=jnp.ones((4, n_rows), bool))
                want = np.asarray(RE._level_reduce(meta, tables, l,
                                                   jnp.asarray(val[s]), op))
                sg = seg[s, l].numpy()
                rows = np.zeros(n_rows, bool)
                rows[sg[sg >= 0]] = True
                got = out[s].numpy()[rows]
                if integer or op != "sum":
                    np.testing.assert_array_equal(got, want[rows])
                else:
                    np.testing.assert_allclose(got, want[rows], rtol=1e-4,
                                               atol=1e-4)


def test_stacked_entries_check_their_arguments():
    rng = np.random.default_rng(0)
    seg, tob, fot, nrt, nb = _stacked_level(rng)
    S = seg.shape[0]
    val = torch.zeros((S, 10, 1))
    src = torch.zeros_like(seg)[:, 0]
    sign = torch.zeros(seg.shape)[:, 0]
    kw = dict(n_rows=700, n_row_tiles=nrt)

    def dense(v=val, s=seg[:, 0], sr=src, sg=sign, **over):
        return SA.segment_agg_level_stacked(v, s, sr, sg, tob[:, 0],
                                            fot[:, 0], **dict(kw, **over))

    with pytest.raises(ValueError, match=r"\(S, n, F\)"):
        dense(v=val[0])                             # 2-D val
    with pytest.raises(ValueError, match="seg must be"):
        dense(s=seg[:2, 0])
    with pytest.raises(ValueError, match="src must be"):
        dense(sr=src[:2])                           # src's shard axis
    with pytest.raises(ValueError, match="sign must be"):
        dense(sg=torch.zeros(seg.shape[0], 2 * seg.shape[2])[:, ::2])
    with pytest.raises(ValueError, match="share their shard stride"):
        dense(sr=src.contiguous())                  # src's shard stride
    with pytest.raises(ValueError, match="share their shard stride"):
        dense(sg=sign.contiguous())                 # sign's shard stride
    with pytest.raises(TypeError, match="src must be"):
        dense(sr=torch.zeros_like(seg, dtype=torch.int64)[:, 0])
    with pytest.raises(ValueError, match="contiguous"):
        dense(v=torch.zeros((S, 10, 2))[..., :1])
    with pytest.raises(ValueError, match="unknown op"):
        dense(op="mean")
    with pytest.raises(ValueError, match="active must be"):
        SA.segment_agg_active_stacked(
            torch.zeros((S, 10, 1)), seg[:, 0], src, sign, tob[:, 0],
            fot[:, 0], torch.zeros((S, 2), dtype=torch.int32)[:, :1], **kw)
    with pytest.raises(ValueError, match="share their shard stride"):
        SA.segment_agg_active_stacked(
            torch.zeros((S, 10, 1)), seg[:, 0], src.contiguous(), sign,
            tob[:, 0], fot[:, 0], torch.zeros((S, 1), dtype=torch.int32),
            **kw)
    with pytest.raises(ValueError, match="unknown op"):
        SA.segment_agg_active_stacked(
            torch.zeros((S, 10, 1)), seg[:, 0], src, sign, tob[:, 0],
            fot[:, 0], torch.zeros((S, 1), dtype=torch.int32), op="mean",
            **kw)
