"""The port's streaming ingest ring (``repro_torch.streams.ingest``) on the
CPU: bit-equal to the port's synchronous write path at the same
device-batch boundaries (scalar and vector sums, an extremal time window,
partial-slot drains), pipelined and synchronous sessions equal under churn,
the routing tables tracking churn — and the same states and answers as the
JAX package's pipeline (``backend="xla"``) on the same stream: bit-equal
PAOs on integer values, within rtol/atol 1e-4 on normal floats."""
import types

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
from repro.streams.ingest import IngestPipeline as RPipe  # noqa: E402
from repro_torch import EagrSession, Query, WindowSpec  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core.aggregates import make_aggregate as t_agg  # noqa: E402
from repro_torch.core.bipartite import build_bipartite as t_bip  # noqa: E402
from repro_torch.core.dynamic import DynamicOverlay as TDyn  # noqa: E402
from repro_torch.core.vnm import construct_vnm as t_vnm  # noqa: E402
from repro_torch.graphs.generators import rmat_graph as t_rmat  # noqa: E402
from repro_torch.streams.ingest import IngestPipeline, IngestStats  # noqa: E402


# ---------------------------------------------------------------- fixtures
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


CASES = {
    "sum_scalar": ("sum", {}, False, ("tuple", 4, None, 1)),
    "sum_vector": ("sum", {"value_dim": 3}, False, ("tuple", 4, None, 3)),
    "max_time": ("max", {}, True, ("time", 4, 8, 1)),
}


def _engines(bases, case):
    agg, kw, all_push, (kind, size, cap, vd) = CASES[case]
    br, bt = bases
    dec = _decisions(br, all_push)
    port = lambda: TE.EagrEngine(  # noqa: E731
        bt, dec, t_agg(agg, **kw), WindowSpec(kind, size, cap, vd),
        headroom=2.0, device="cpu")
    ref = RE.EagrEngine(br, dec, r_agg(agg, **kw), RSpec(kind, size, cap, vd),
                        headroom=2.0, backend="xla")
    return port, ref, vd


def _batches(eng, *, n_batches, arrival, value_dim=1, seed=7,
             with_unknown=True, normal=False):
    """Random write batches over known writer bases; every third batch
    carries one unknown (droppable) base id to exercise masking."""
    writers = np.flatnonzero(eng.plan.routes.writer_row >= 0)
    unknown = np.flatnonzero(eng.plan.routes.writer_row < 0)
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_batches):
        ids = rng.choice(writers, size=arrival).astype(np.int64)
        if with_unknown and len(unknown) and k % 3 == 0:
            ids[0] = unknown[0]
        shape = (arrival,) if value_dim == 1 else (arrival, value_dim)
        vals = (rng.normal(size=shape) if normal
                else rng.integers(0, 8, shape)).astype(np.float32)
        out.append((ids, vals))
    return out


def _state(eng):
    s = eng.state
    return [np.asarray(x) for x in (s.windows.values, s.windows.stamps,
                                    s.windows.head, s.windows.count, s.pao,
                                    s.now)]


def _sync_twin_drive(eng, batches, device_batch):
    """The synchronous twin: identical events at identical device-batch
    boundaries (full slots + one partial tail, what the ring dispatches)."""
    ids = np.concatenate([i for i, _ in batches])
    vals = np.concatenate([v for _, v in batches])
    for off in range(0, len(ids), device_batch):
        eng.write_batch(ids[off: off + device_batch],
                        vals[off: off + device_batch],
                        batch_size=device_batch)


# ----------------------------------------------------------- bit parity
@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_bit_identical_to_sync(bases, case):
    """Pipelined == synchronous inside the port, bit for bit, and both equal
    the JAX package's pipeline on the same integer-valued stream."""
    make, ref, vd = _engines(bases, case)
    piped, sync = make(), make()
    B = 64
    # 11 arrival batches of 16 = 176 events: 2 full slots + a partial tail
    batches = _batches(piped, n_batches=11, arrival=16, value_dim=vd)
    pipe = IngestPipeline([piped], depth=2, device_batch=B)
    rpipe = RPipe([ref], depth=2, device_batch=B)
    for ids, vals in batches:
        pipe.submit(ids, vals)
        rpipe.submit(ids, vals)
    pipe.flush()
    rpipe.flush()
    _sync_twin_drive(sync, batches, B)

    for x, y in zip(_state(piped), _state(sync)):
        np.testing.assert_array_equal(x, y)
    want = [np.asarray(x) for x in (ref.state.windows.values,
                                    ref.state.windows.stamps,
                                    ref.state.windows.head,
                                    ref.state.windows.count, ref.state.pao,
                                    ref.state.now)]
    for x, y in zip(_state(piped), want):
        np.testing.assert_array_equal(x, y)
    assert pipe.stats.events_in == 176 and pipe.stats.partial_batches == 1
    for f in ("events_in", "events_dispatched", "events_dropped", "batches",
              "partial_batches", "flushes", "max_in_flight"):
        assert getattr(pipe.stats, f) == getattr(rpipe.stats, f), f

    readers = np.flatnonzero(piped.plan.routes.reader_node >= 0)[:32]
    got = piped.read_batch(readers, batch_size=32)
    np.testing.assert_array_equal(got, sync.read_batch(readers,
                                                       batch_size=32))
    np.testing.assert_array_equal(got, np.asarray(
        ref.read_batch(readers, batch_size=32)))


def test_pipeline_matches_reference_on_normal_floats(bases):
    """Normal-valued writes: the port's pipeline against the JAX package's
    within the port's float bar (rtol/atol 1e-4)."""
    make, ref, _ = _engines(bases, "sum_scalar")
    piped = make()
    batches = _batches(piped, n_batches=12, arrival=24, seed=3, normal=True)
    pipe, rpipe = IngestPipeline([piped], depth=3, device_batch=32), \
        RPipe([ref], depth=3, device_batch=32)
    for ids, vals in batches:
        pipe.submit(ids, vals)
        rpipe.submit(ids, vals)
    pipe.flush()
    rpipe.flush()
    np.testing.assert_allclose(piped.state.pao.numpy(),
                               np.asarray(ref.state.pao), rtol=1e-4,
                               atol=1e-4)
    readers = np.flatnonzero(piped.plan.routes.reader_node >= 0)[:40]
    np.testing.assert_allclose(
        piped.read_batch(readers), np.asarray(ref.read_batch(readers)),
        rtol=1e-4, atol=1e-4)


def test_drain_dispatches_partial_without_blocking(bases):
    make, _, _ = _engines(bases, "sum_scalar")
    piped, sync = make(), make()
    batches = _batches(piped, n_batches=3, arrival=16, with_unknown=False)
    pipe = IngestPipeline([piped], depth=2, device_batch=64)
    for ids, vals in batches:
        pipe.submit(ids, vals)
    assert pipe.pending == 48 and pipe.in_flight == 0
    pipe.drain()  # partial slot dispatched, ring not barriered
    assert pipe.pending == 0 and pipe.in_flight == 1
    assert pipe.stats.partial_batches == 1 and pipe.stats.flushes == 0
    _sync_twin_drive(sync, batches, 64)
    readers = np.flatnonzero(piped.plan.routes.reader_node >= 0)[:16]
    np.testing.assert_array_equal(
        piped.read_batch(readers, batch_size=16),
        sync.read_batch(readers, batch_size=16))


def test_pipeline_rejects_bad_input_and_stacked_engines(bases):
    make, _, _ = _engines(bases, "sum_scalar")
    pipe = IngestPipeline([make()], depth=1, device_batch=20)
    assert pipe.device_batch == 32 and pipe.depth == 1
    with pytest.raises(ValueError, match="shape"):
        pipe.submit([1, 2], [1.0])
    with pytest.raises(ValueError, match="at least one"):
        IngestPipeline([])
    with pytest.raises(NotImplementedError, match="item 10"):
        IngestPipeline([types.SimpleNamespace(plan=None)])
    assert IngestStats().as_dict()["batches"] == 0


# ----------------------------------------------- session + churn ordering
def test_session_pipeline_matches_sync_session_under_churn():
    """Interleaved updates and add_edge/delete_edge through a pipelined
    port session (device batch == update batch), a synchronous one and the
    JAX package's pipelined session: reads equal throughout, and the
    pipelined session matches the windows oracle. The churn flush is the
    pipeline barrier."""
    spec = WindowSpec("tuple", 4)
    piped = EagrSession(t_rmat(120, 700, seed=5), device="cpu",
                        ingest_depth=2, ingest_batch=32)
    sync = EagrSession(t_rmat(120, 700, seed=5), device="cpu")
    ref = RSession(r_rmat(120, 700, seed=5), backend="xla", ingest_depth=2,
                   ingest_batch=32)
    hp = piped.register(Query(agg="sum", window=spec))
    hs = sync.register(Query(agg="sum", window=spec))
    hr = ref.register(RQuery(agg="sum", window=RSpec("tuple", 4)))

    rng = np.random.default_rng(11)
    writers = np.array(sorted(piped.writers))
    readers = np.array(sorted(set(piped.readers) & set(sync.readers)))

    def mutate(step):
        r = int(readers[step % len(readers)])
        nbrs = piped.neighborhood(r)
        if step % 2 and nbrs:
            w = min(nbrs)
            for s in (piped, sync, ref):
                s.delete_edge(w, r)
        else:
            w = int(writers[(step * 7) % len(writers)])
            if w not in nbrs and w != r:
                for s in (piped, sync, ref):
                    s.add_edge(w, r)

    for step in range(8):
        ids = rng.choice(writers, size=32).astype(np.int64)
        vals = rng.integers(0, 8, 32).astype(np.float32)
        for s in (piped, sync, ref):
            s.update(ids, vals)
        if step % 3 == 0:
            mutate(step)  # journaled; auto-flushes on the next update/read
        sample = rng.choice(readers, size=8, replace=False)
        got = piped.read(hp, sample)
        np.testing.assert_array_equal(got, sync.read(hs, sample))
        np.testing.assert_array_equal(got, np.asarray(ref.read(hr, sample)))

    piped.flush()
    sync.flush()
    st = piped.stats().ingest
    assert st.batches == 8 and st.flushes >= 1 and sync.stats().ingest is None
    eng = hp.group.engine
    for r in map(int, readers[:5]):
        want = eng.oracle_read(r, {r: piped.neighborhood(r)})
        np.testing.assert_allclose(piped.read(hp, [r])[0], want, rtol=0,
                                   atol=0)


def test_session_ingest_settings_and_coalescing(monkeypatch):
    """``EAGR_INGEST_DEPTH``/``EAGR_INGEST_BATCH`` set the ring; arrival
    batches coalesce into device batches (one clock tick each), and a new
    query group retires the ring (rebuilt over the new engine set, with its
    counters carried)."""
    monkeypatch.setenv("EAGR_INGEST_DEPTH", "3")
    monkeypatch.setenv("EAGR_INGEST_BATCH", "64")
    s = EagrSession(t_rmat(100, 500, seed=1), device="cpu")
    assert (s.ingest_depth, s.ingest_batch) == (3, 64)
    monkeypatch.delenv("EAGR_INGEST_BATCH")
    assert EagrSession(t_rmat(100, 500, seed=1), device="cpu",
                       ingest_depth=1).ingest_batch == 8192
    h = s.register(Query(agg="count"))
    writers = np.asarray(s.writers)
    for _ in range(8):
        s.update(writers[:16])
    eng = h.group.engine
    assert s.stats().ingest.batches == 2 and eng._now_host == 2.0
    s.register(Query(agg="max"))        # a new group: ring flushed, dropped
    assert s._pipeline is None and s.stats().ingest.batches == 2
    s.update(writers[:16])
    assert s.stats().ingest.events_in == 16 * 9


def _assert_routes_match_dicts(plan):
    r = plan.routes
    for table, m in ((r.writer_row, plan.writer_row_of_base),
                     (r.reader_node, plan.reader_node_of_base)):
        want = np.full(len(table), -1, np.int32)
        for b, v in m.items():
            want[b] = v
        np.testing.assert_array_equal(table, want)


def test_routes_table_tracks_dicts_under_churn():
    """The dense routing tables the ring routes with and the bookkeeping
    dicts agree after every patch: adds, deletes, node retirement."""
    sess = EagrSession(t_rmat(120, 700, seed=5), device="cpu",
                       ingest_depth=2, ingest_batch=16)
    h = sess.register(Query(agg="sum", window=WindowSpec("tuple", 4)))
    _assert_routes_match_dicts(h.group.engine.plan)
    readers = sorted(sess.readers)
    sess.add_edge(readers[0], readers[1])
    sess.delete_edge(min(sess.neighborhood(readers[2])), readers[2])
    sess.add_node(5000, in_neighbors=[readers[0]], out_readers=[readers[1]])
    sess.flush()
    _assert_routes_match_dicts(h.group.engine.plan)
    sess.delete_node(5000)
    sess.flush()
    _assert_routes_match_dicts(h.group.engine.plan)
    sess.update([readers[1]], [2.0])  # the patched plan still routes
    assert np.isfinite(sess.read(h, [readers[1]])[0])
