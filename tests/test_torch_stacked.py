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


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("F", [1, 3, 40])
def test_stacked_entries_equal_per_shard_plain(op, F):
    """On CPU tensors the stacked entries run the plain version shard by
    shard: each shard's output equals the single-shard wrapper's on its
    slice (a strided level of the (S, L, ...) tables), dense and active
    with ragged sentinel-padded lists; no launch is counted."""
    rng = np.random.default_rng(F)
    seg, tob, fot, nrt, nb = _stacked_level(rng)
    S, n_rows = seg.shape[0], 700
    SA.reset_launches()
    for l in range(3):
        s_l, t_l, f_l = seg[:, l], tob[:, l], fot[:, l]
        assert s_l.stride(0) == 4 * nb * SA.E_BLK   # a strided view
        x = torch.as_tensor(rng.standard_normal((S, nb * SA.E_BLK, F)),
                            dtype=torch.float32)
        out = SA.segment_agg_level_stacked(x, s_l, t_l, f_l, n_rows=n_rows,
                                           n_row_tiles=nrt, op=op)
        assert out.shape == (S, n_rows, F)
        for s in range(S):
            want = SA.segment_agg_level(x[s], s_l[s], t_l[s], f_l[s],
                                        n_rows=n_rows, n_row_tiles=nrt,
                                        op=op)
            assert torch.equal(out[s], want)
        acts = [np.sort(rng.choice(nb, int(rng.integers(0, nb)),
                                   replace=False)) for _ in range(S)]
        K = max(1, max(len(a) for a in acts))
        act = torch.as_tensor(np.stack([
            np.pad(a, (0, K - len(a)), constant_values=nb) for a in acts])
            .astype(np.int32))
        xa = torch.as_tensor(rng.standard_normal((S, K * SA.E_BLK, F)),
                             dtype=torch.float32)
        out = SA.segment_agg_active_stacked(xa, s_l, t_l, f_l, act,
                                            n_rows=n_rows, n_row_tiles=nrt,
                                            op=op)
        for s in range(S):
            want = SA.segment_agg_active(xa[s], s_l[s], t_l[s], f_l[s],
                                         act[s], n_rows=n_rows,
                                         n_row_tiles=nrt, op=op)
            assert torch.equal(out[s], want)
    assert sum(SA.LAUNCHES.values()) == 0


def test_stacked_entries_check_their_arguments():
    rng = np.random.default_rng(0)
    seg, tob, fot, nrt, nb = _stacked_level(rng)
    S = seg.shape[0]
    x = torch.zeros((S, nb * SA.E_BLK, 1))
    kw = dict(n_rows=700, n_row_tiles=nrt)
    with pytest.raises(ValueError, match=r"\(S, E, F\)"):
        SA.segment_agg_level_stacked(x[0], seg[:, 0], tob[:, 0], fot[:, 0],
                                     **kw)
    with pytest.raises(ValueError, match="seg must be"):
        SA.segment_agg_level_stacked(x, seg[:2, 0], tob[:, 0], fot[:, 0],
                                     **kw)
    with pytest.raises(ValueError, match="contiguous"):
        SA.segment_agg_level_stacked(
            torch.zeros((S, nb * SA.E_BLK, 2))[..., :1], seg[:, 0],
            tob[:, 0], fot[:, 0], **kw)
    with pytest.raises(ValueError, match="active must be"):
        SA.segment_agg_active_stacked(
            torch.zeros((S, SA.E_BLK, 1)), seg[:, 0], tob[:, 0], fot[:, 0],
            torch.zeros((S, 2), dtype=torch.int32)[:, :1], **kw)
    with pytest.raises(ValueError, match="unknown op"):
        SA.segment_agg_level_stacked(x, seg[:, 0], tob[:, 0], fot[:, 0],
                                     op="mean", **kw)
