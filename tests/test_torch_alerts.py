"""The port's standing alerts (``repro_torch.streams.alerts``) on the CPU:
the fired sets of the evaluation after each write step equal the port's
poll oracle and the JAX package's fused path (``backend="xla"``) on the
same integer-valued stream — equal base ids, alert ids, overflow flags and
values — across aggregates, window kinds, a vector payload, per-reader
thresholds, fired-set overflow, structural churn, sync and pipelined
sessions; plus the state machine (hysteresis, debounce, delta re-base),
ring-boundary collection, the registration rules and the kill switch."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

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
from repro.streams import alerts as RA  # noqa: E402
from repro.streams.ingest import IngestPipeline as RPipe  # noqa: E402
from repro_torch import EagrSession, Query, WindowSpec  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core.aggregates import make_aggregate as t_agg  # noqa: E402
from repro_torch.core.bipartite import build_bipartite as t_bip  # noqa: E402
from repro_torch.core.dynamic import DynamicOverlay as TDyn  # noqa: E402
from repro_torch.core.vnm import construct_vnm as t_vnm  # noqa: E402
from repro_torch.graphs.generators import rmat_graph as t_rmat  # noqa: E402
from repro_torch.streams import alerts as TA  # noqa: E402
from repro_torch.streams.ingest import IngestPipeline  # noqa: E402


# ---------------------------------------------------------------- fixtures
def _bases(seed=3, n=150, e=900):
    out = []
    for rmat, bip, vnm, dyn in ((r_rmat, r_bip, r_vnm, RDyn),
                                (t_rmat, t_bip, t_vnm, TDyn)):
        bp = bip(rmat(n, e, seed=seed))
        ov, _ = vnm(bp, variant="vnm_a", max_iterations=3, seed=0)
        out.append(dyn.from_overlay(ov, bp.reader_input_sets())
                   .to_overlay(prune=False))
    return out


def _engines(seed=3, *, agg="sum", kind="tuple", size=4, cap=None, vd=1,
             **kw):
    """A port engine and a JAX-package engine, all-PUSH (alerts need
    push-maintained readers) over the same overlay."""
    br, bt = _bases(seed=seed)
    dec = np.full(br.n_nodes, RD.PUSH, np.int64)
    port = TE.EagrEngine(bt, dec, t_agg(agg, **kw),
                         WindowSpec(kind, size, cap, vd), headroom=2.0,
                         device="cpu")
    ref = RE.EagrEngine(br, dec, r_agg(agg, **kw), RSpec(kind, size, cap, vd),
                        headroom=2.0, backend="xla")
    return port, ref


def _batches(eng, *, n_batches, arrival, value_dim=1, seed=7, lo=0, hi=8):
    writers = np.flatnonzero(eng.plan.routes.writer_row >= 0)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        ids = rng.choice(writers, size=arrival).astype(np.int64)
        shape = (arrival,) if value_dim == 1 else (arrival, value_dim)
        out.append((ids, rng.integers(lo, hi, shape).astype(np.float32)))
    return out


def _alert_bases(eng, k=None):
    bases = np.flatnonzero(eng.plan.routes.reader_node >= 0).astype(np.int64)
    return bases if k is None else bases[:k]


def _flat(batches):
    """Canonical form of a FiredBatch list: (now, base, value, aid,
    overflow) per fired reader, sorted."""
    out = []
    for b in batches:
        for i in range(len(b)):
            out.append((float(b.now), int(b.base_ids[i]),
                        float(np.float32(b.values[i])), int(b.aids[i]),
                        bool(b.overflow)))
    return sorted(out)


def _run(mod, eng, spec, batches, bases, cap, pipelined, poll=True):
    """Fired sets of one package's evaluated writes (and of its poll
    oracle, polled after every device batch when not pipelined)."""
    al = mod.AlertSet(cap)
    al.register(0, spec, bases.tolist(), dynamic=False, engine=None)
    eng.attach_alerts(al)
    oracle = mod.PollOracle(al)
    oracle.resync(eng)
    polled = []
    if pipelined:
        pipe = (IngestPipeline if mod is TA else RPipe)(
            [eng], depth=2, device_batch=len(batches[0][0]))
        for ids, vals in batches:
            pipe.submit(ids, vals)
        pipe.flush()
    else:
        for ids, vals in batches:
            eng.write_batch(ids, vals, batch_size=len(ids))
            if poll:
                ob = oracle.poll(eng, float(eng._now_host) - 1.0)
                if len(ob):
                    polled.append(ob)
    al.collect()
    pushed = al.pop_fired()
    eng.alerts = None
    return _flat(pushed), _flat(polled)


def _parity(spec_t, spec_r, ekw, *, bases=None, cap=None, **bkw):
    """Fired sets on one stream: the port's evaluated writes, its poll
    oracle and the JAX package's, synchronous and through both rings."""
    port, ref = _engines(**ekw)
    batches = _batches(port, **bkw)
    bases = _alert_bases(port) if bases is None else bases
    got, polled = _run(TA, port, spec_t, batches, bases, cap, False)
    want, _ = _run(RA, ref, spec_r, batches, bases, cap, False, poll=False)
    assert got, "fixture never fired — thresholds too loose to test parity"
    assert got == [g[:4] + (False,) for g in polled] or cap is not None
    assert got == want
    # the same stream through both packages' ingest rings (device batches
    # of the arrival size bucketed to a power of two: the synchronous
    # boundaries when the arrival size is one)
    port2, ref2 = _engines(**ekw)
    got_p, _ = _run(TA, port2, spec_t, batches, bases, cap, True)
    want_p, _ = _run(RA, ref2, spec_r, batches, bases, cap, True)
    assert got_p and got_p == want_p
    if TE.bucket_batch(len(batches[0][0])) == len(batches[0][0]):
        assert got_p == got
    return got


# ---------------------------------------------------- push-vs-poll parity
def test_parity_sum_tuple_window():
    _parity(TA.AlertSpec(above=10.0, hysteresis=1.0),
            RA.AlertSpec(above=10.0, hysteresis=1.0), {},
            n_batches=24, arrival=32)


def test_parity_max_time_window():
    """Extremal aggregate + time window: expiries change measures without a
    write touching the reader — the evaluation must still see them."""
    kw = dict(above=6.0, below=0.5, hysteresis=0.25)
    _parity(TA.AlertSpec(**kw), RA.AlertSpec(**kw),
            dict(seed=5, agg="max", kind="time", size=3.0, cap=8),
            n_batches=30, arrival=16, seed=11)


def test_parity_delta_predicate_with_debounce():
    _parity(TA.AlertSpec(delta=4.0, debounce=3.0),
            RA.AlertSpec(delta=4.0, debounce=3.0), dict(seed=9),
            n_batches=24, arrival=32, seed=2)


def test_parity_vector_payload_component():
    _parity(TA.AlertSpec(above=9.0, component=2),
            RA.AlertSpec(above=9.0, component=2),
            dict(seed=4, vd=3, value_dim=3),
            n_batches=20, arrival=24, value_dim=3, seed=13)


def test_parity_per_reader_threshold_arrays():
    bases = _alert_bases(_engines(seed=6)[0])
    thr = np.random.default_rng(0).uniform(4.0, 14.0, len(bases)) \
        .astype(np.float32)
    _parity(TA.AlertSpec(above=thr), RA.AlertSpec(above=thr), dict(seed=6),
            bases=bases, n_batches=24, arrival=32, seed=21)


@pytest.mark.parametrize("agg,window", [
    ("sum", ("tuple", 4, None)), ("sum", ("time", 3.0, 8)),
    ("max", ("tuple", 4, None)), ("max", ("time", 3.0, 8))])
@pytest.mark.parametrize("above,hys,deb,seed", [(5.0, 0.0, 0.0, 1),
                                                (12.5, 1.5, 2.0, 17)])
def test_parity_sweep(agg, window, above, hys, deb, seed):
    kw = dict(above=np.float32(above), hysteresis=hys, debounce=deb)
    port, ref = _engines(agg=agg, kind=window[0], size=window[1],
                         cap=window[2])
    batches = _batches(port, n_batches=16, arrival=24, seed=seed)
    bases = _alert_bases(port)
    got, polled = _run(TA, port, TA.AlertSpec(**kw), batches, bases, None,
                       False)
    want, _ = _run(RA, ref, RA.AlertSpec(**kw), batches, bases, None, False,
                   poll=False)
    assert got == want == polled


def test_overflow_recovers_exact_fired_set():
    """A batch firing more than the compact capacity still reports the exact
    set (dense fallback), flagged ``overflow`` as the JAX package flags it."""
    port, ref = _engines(seed=8)
    batches = _batches(port, n_batches=6, arrival=64, seed=3, lo=1)
    bases = _alert_bases(port)
    got, polled = _run(TA, port, TA.AlertSpec(above=-1.0), batches, bases, 4,
                       False)
    want, _ = _run(RA, ref, RA.AlertSpec(above=-1.0), batches, bases, 4,
                   False, poll=False)
    assert any(g[4] for g in got) and got == want
    assert [g[:4] for g in got] == [p[:4] for p in polled]
    assert max(sum(1 for g in got if g[0] == t) for t in {g[0] for g in got}) > 4


# ----------------------------------------------- state-machine unit semantics
def _mk_state(n, **over):
    cols = {
        "active": np.ones(n, bool), "armed": np.ones(n, bool),
        "hi": np.full(n, np.inf, np.float32),
        "lo": np.full(n, -np.inf, np.float32),
        "dthr": np.full(n, np.inf, np.float32),
        "hys": np.zeros(n, np.float32), "deb": np.zeros(n, np.float32),
        "comp": np.zeros(n, np.int32),
        "last_fire": np.full(n, -np.inf, np.float32),
        "ref": np.zeros(n, np.float32), "last_m": np.zeros(n, np.float32),
    }
    for k, v in over.items():
        cols[k] = np.asarray(v, cols[k].dtype)
    return cols


def _eval_seq(cols, measures, cap=8):
    """One row's per-tick measures through both packages' ``alert_eval``
    (sum aggregate: finalize is the identity); the fire ticks and values
    of each."""
    out = []
    for mod, put, agg in ((TA, torch.as_tensor, t_agg("sum")),
                          (RA, jnp.asarray, r_agg("sum"))):
        state = mod.AlertState(**{k: put(v.copy()) for k, v in cols.items()})
        fires = []
        for t, m in enumerate(measures):
            pao = np.full((1, 1), np.float32(m))
            if mod is TA:
                count, _, vals, _, _ = TA.alert_eval(
                    agg, state, torch.as_tensor(pao),
                    torch.tensor(float(t)), cap)
            else:
                state, count, _, vals, _, _ = RA.alert_eval(
                    agg, state, jnp.asarray(pao), jnp.float32(t), cap)
            if int(count):
                fires.append((t, float(np.asarray(vals)[0])))
        out.append(fires)
    assert out[0] == out[1]
    return out[0]


def test_hysteresis_one_fire_per_excursion():
    st0 = _mk_state(1, hi=[5.0], hys=[1.0], last_m=[0.0], ref=[0.0])
    seq = [6.0, 4.5, 6.0, 4.5, 6.0, 3.0, 7.0]
    assert [t for t, _ in _eval_seq(st0, seq)] == [0, 6]


def test_debounce_spaces_fires():
    st0 = _mk_state(1, dthr=[0.5], deb=[3.0], last_m=[0.0], ref=[0.0])
    seq = [2.0, 4.0, 6.0, 8.0, 10.0, 12.0, 14.0]
    assert [t for t, _ in _eval_seq(st0, seq)] == [0, 3, 6]


def test_delta_ref_rebases_on_fire():
    st0 = _mk_state(1, dthr=[3.0], last_m=[0.0], ref=[0.0])
    fires = _eval_seq(st0, [4.0, 6.0, 8.0])
    assert [t for t, _ in fires] == [0, 2] and fires[1][1] == 8.0


def test_unchanged_measure_never_fires():
    st0 = _mk_state(1, hi=[1.0], last_m=[5.0], ref=[5.0], armed=[True])
    assert _eval_seq(st0, [5.0, 5.0, 5.0]) == []


def test_compaction_keeps_row_order_and_fresh_fallback_tensors():
    """The sync-free compaction lists the first ``cap`` fired rows in
    ascending order, -1 padded; the dense ``fired``/``m`` it returns are
    fresh tensors, not views of the state's ``last_m``."""
    n = 40
    fire = np.zeros(n, bool)
    fire[[3, 7, 8, 20, 33]] = True
    cols = _mk_state(n, hi=np.where(fire, 0.5, np.inf), last_m=np.zeros(n))
    state = TA.AlertState(**{k: torch.as_tensor(v) for k, v in cols.items()})
    pao = torch.ones((n, 1))
    for cap, want in ((8, [3, 7, 8, 20, 33, -1, -1, -1]), (3, [3, 7, 8])):
        st = TA.AlertState(*(t.clone() for t in state))
        count, idx, vals, fired, m = TA.alert_eval(
            t_agg("sum"), st, pao, torch.tensor(0.0), cap)
        assert int(count) == 5 and idx.tolist() == want
        assert vals.tolist() == [1.0 if i >= 0 else 0.0 for i in want]
        assert m.data_ptr() != st.last_m.data_ptr()
        assert fired.tolist() == fire.tolist()


# --------------------------------------------------------------- churn parity
@pytest.mark.parametrize("depth", [0, 2])
def test_parity_across_structural_churn(depth):
    """Edge churn mid-stream, sync and pipelined: alerted readers follow
    their node through the patch, and the port's fired sets equal its
    resynced oracle's and the JAX package's session's."""
    t = EagrSession(t_rmat(150, 900, seed=3), device="cpu", ingest_batch=32,
                    ingest_depth=depth)
    r = RSession(r_rmat(150, 900, seed=3), backend="xla", ingest_batch=32,
                 ingest_depth=depth)
    qt = t.register(Query(agg="sum", window=WindowSpec("tuple", 4),
                          continuous=True))
    qr = r.register(RQuery(agg="sum", window=RSpec("tuple", 4),
                           continuous=True))
    ah = qt.on_threshold(above=8.0, hysteresis=0.5)
    qr.on_threshold(above=8.0, hysteresis=0.5)
    eng = qt.group.engine
    oracle = TA.PollOracle(eng.alerts)
    oracle.resync(eng)
    rng = np.random.default_rng(1)
    got, want, poll = [], [], []

    def drive(steps):
        for _ in range(steps):
            ids = rng.integers(0, 150, size=32)
            vals = rng.integers(0, 8, 32).astype(np.float32)
            t.update(ids, vals)
            r.update(ids, vals)
            if t._pipeline is not None:
                t._pipeline.flush()
            got.extend(t.drain_fired())
            want.extend(r.drain_fired())
            ob = oracle.poll(eng, float(eng._now_host) - 1.0)
            if len(ob):
                poll.append(ob)

    drive(8)
    n_before = eng.alerts.n_alerts
    for _ in range(6):
        u, v = int(rng.integers(0, 150)), int(rng.integers(0, 150))
        t.add_edge(u, v)
        r.add_edge(u, v)
    res = t.flush()
    assert res.patched + res.relayout + res.recompiled == 1
    r.flush()
    oracle = TA.PollOracle(eng.alerts)   # re-seeds from the carried state
    oracle.resync(eng)
    drive(8)
    assert got, "churn parity fixture never fired"
    assert _flat(got) == _flat(poll) == _flat(want)
    assert eng.alerts.n_alerts >= n_before
    t.unregister_alert(ah)
    assert eng.alerts is None


def test_dynamic_registration_adopts_new_readers():
    sess = EagrSession(t_rmat(80, 400, seed=2), device="cpu")
    q = sess.register(Query(agg="sum", window=WindowSpec("tuple", 4),
                            continuous=True))
    q.on_threshold(above=1e9)  # readers=None on an unscoped query = dynamic
    eng = q.group.engine
    n0 = eng.alerts.n_alerts
    assert n0 == len(_alert_bases(eng))
    sess.add_node(80, in_neighbors=[0, 1, 2])
    sess.flush()
    assert eng.alerts.n_alerts > n0 and 80 in eng.alerts._base.tolist()


def test_second_registration_keeps_first_alerts_state():
    """A second alert on an engine whose alerts are already placed (the
    JAX package raises ``IndexError`` there: ROADMAP.md §3): both fire,
    and the first keeps its armed state."""
    sess = EagrSession(t_rmat(80, 400, seed=2), device="cpu")
    q = sess.register(Query(agg="sum", window=WindowSpec("tuple", 4),
                            continuous=True))
    rd = sess.readers
    a = sess.register_alert(q, above=5.0, readers=rd[:20])
    writers = np.asarray(sess.writers)
    sess.update(writers, np.full(len(writers), 3.0, np.float32))
    first = a.fired()
    assert first
    b = sess.register_alert(q, above=5.0, readers=rd[20:40])
    al = q.group.engine.alerts
    assert al.n_alerts == 40
    fired = set(first[0].base_ids.tolist())
    armed = dict(zip(al._base.tolist(), al._dyn["armed"].tolist()))
    assert not any(armed[int(x)] for x in fired)  # carried, not re-armed
    sess.update(writers, np.full(len(writers), 3.0, np.float32))
    assert b.fired() and not a.fired()  # a's rows stay disarmed


# ------------------------------------------------------ ring-boundary readback
def test_ring_boundary_collects_fired_sets():
    """Fired sets land host-side at ring-slot reuse without any explicit
    drain; an interleaved user drain must not double-count (seq marks)."""
    port, _ = _engines()
    al = TA.AlertSet()
    al.register(0, TA.AlertSpec(above=8.0), _alert_bases(port).tolist(),
                dynamic=False)
    port.attach_alerts(al)
    pipe = IngestPipeline([port], depth=2, device_batch=32)
    seen = []
    for i, (ids, vals) in enumerate(
            _batches(port, n_batches=16, arrival=32, seed=9)):
        pipe.submit(ids, vals)
        if i == 7:       # user drains mid-ring: collect() races the marks
            al.collect()
        if i == 3:       # the ring has freed slot 0: its batch is in
            assert al.seq_done >= 2
        seen.extend(al.pop_fired())
    pipe.flush()
    seen.extend(al.pop_fired())
    assert al.seq == al.seq_done == 16 and al.pending == 0
    assert sum(len(b) for b in seen) > 0
    assert len({float(b.now) for b in seen}) == len(seen)


# ----------------------------------------------------------- session API edges
def test_register_alert_rejects_pull_readers():
    sess = EagrSession(t_rmat(150, 900, seed=3), device="cpu")
    q = sess.register(Query(agg="sum", window=WindowSpec("tuple", 4)))
    eng = q.group.engine
    pull = [int(b) for b in _alert_bases(eng)
            if eng.plan.decision[eng.plan.routes.reader_node[b]] != RD.PUSH]
    assert pull, "min-cut made every reader PUSH on this fixture"
    with pytest.raises(ValueError, match="PULL-decided"):
        sess.register_alert(q, above=5.0, readers=pull[:4])
    assert eng.alerts is None  # rejected registration fully rolled back


def test_register_alert_rejects_topk_component_and_scope():
    sess = EagrSession(t_rmat(80, 400, seed=2), device="cpu")
    qk = sess.register(Query(agg=t_agg("topk", k=3, domain=16),
                             window=WindowSpec("tuple", 4), continuous=True))
    with pytest.raises(ValueError, match="topk"):
        qk.on_threshold(above=1.0)
    q = sess.register(Query(agg="sum", window=WindowSpec("tuple", 4),
                            continuous=True))
    with pytest.raises(ValueError, match="component"):
        q.on_threshold(above=1.0, component=5)
    with pytest.raises(ValueError, match="OR keyword"):
        sess.register_alert(q, TA.AlertSpec(above=1.0), below=0.0)
    rd = sess.readers
    qs = sess.register(Query(agg="sum", window=WindowSpec("tuple", 4),
                             continuous=True, readers=rd[:5]))
    with pytest.raises(ValueError, match="outside"):
        qs.on_threshold(above=1.0, readers=rd[5:7])


def test_one_predicate_per_reader_row():
    sess = EagrSession(t_rmat(80, 400, seed=2), device="cpu")
    q = sess.register(Query(agg="sum", window=WindowSpec("tuple", 4),
                            continuous=True))
    bases = _alert_bases(q.group.engine)[:4].tolist()
    sess.register_alert(q, above=5.0, readers=bases)
    with pytest.raises(ValueError, match="already carry an alert"):
        sess.register_alert(q, below=0.0, readers=bases[:1])


def test_unregister_last_alert_detaches_eval():
    sess = EagrSession(t_rmat(80, 400, seed=2), device="cpu",
                       ingest_depth=2, ingest_batch=16)
    q = sess.register(Query(agg="sum", window=WindowSpec("tuple", 4),
                            continuous=True))
    eng = q.group.engine
    ah = sess.register_alert(q, above=5.0,
                             readers=_alert_bases(eng)[:4].tolist())
    assert eng.alerts is not None and eng.alerts.n_alerts == 4
    assert sess.alerts == [ah] and sess.adapt() == 0
    sess.unregister_alert(ah)
    assert eng.alerts is None and sess.alerts == []
    with pytest.raises(ValueError, match="unknown alert handle"):
        sess.unregister_alert(ah)
    ah2 = q.on_threshold(above=5.0)
    sess.unregister(q)              # a query's alerts go with it
    assert sess.alerts == [] and ah2.aid == 1


def test_alert_eval_kill_switch(monkeypatch):
    monkeypatch.setenv("EAGR_ALERT_EVAL", "0")
    monkeypatch.setenv("EAGR_ALERT_CAP", "16")
    port, _ = _engines()
    al = TA.AlertSet()
    assert al.cap == 16 and not al.enabled
    al.register(0, TA.AlertSpec(above=-1.0), _alert_bases(port).tolist(),
                dynamic=False)
    port.attach_alerts(al)
    for ids, vals in _batches(port, n_batches=4, arrival=32, lo=1):
        port.write_batch(ids, vals, batch_size=32)
    al.collect()
    assert not al.pop_fired() and al.seq == 0


def test_check_alert_aggregate_measure_dims():
    for name, kw, dim in (("sum", {}, 1), ("sum", {"value_dim": 3}, 3),
                          ("avg", {}, 1), ("count", {}, 1), ("min", {}, 1)):
        assert TA.check_alert_aggregate(t_agg(name, **kw)) == \
            RA.check_alert_aggregate(r_agg(name, **kw)) == dim
