"""Durable port sessions (``repro_torch.distributed.checkpoint``):
save -> restore bit-identical for single and sharded sessions, with churn
and with standing alerts; a same-layout restore runs no construction,
min-cut or compile; reshards N -> M against the JAX package's own restore;
checkpoints cross between the packages in both directions with equal
answers; a process killed mid-save keeps the last committed step; and
auto-checkpointing with its garbage collection. The JAX package runs with
``backend="xla"`` on the CPU."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.window import WindowSpec as RSpec  # noqa: E402
from repro.graphs.generators import rmat_graph as r_rmat  # noqa: E402
from repro.session import EagrSession as RSession  # noqa: E402
from repro.session import Query as RQuery  # noqa: E402
from repro_torch import EagrSession, Query, WindowSpec  # noqa: E402
from repro_torch.distributed.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.graphs.generators import rmat_graph  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _graph():
    return rmat_graph(400, 2400, seed=7)


def _stream(W, rounds=5, n=24, seed=3, integral=True):
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        ids = rng.choice(W, n)
        vals = rng.integers(-3, 6, n) if integral else rng.normal(size=n)
        yield ids, vals.astype(np.float32)


def _drive(sess, handle, **kw):
    """Deterministic traffic; returns a read probe + its pre-save answer."""
    for ids, vals in _stream(np.asarray(sess.writers), **kw):
        sess.update(ids, vals)
    q = np.random.default_rng(kw.get("seed", 3)).choice(
        np.asarray(sess.readers), 24)
    return q, sess.read(handle, q)


def _lockstep(a, ha, b, hb, q, seed=11):
    """More identical traffic on both sessions; their reads stay equal."""
    for ids, vals in _stream(np.asarray(a.writers), rounds=3, seed=seed):
        a.update(ids, vals)
        b.update(ids, vals)
    np.testing.assert_array_equal(np.asarray(b.read(hb, q)),
                                  np.asarray(a.read(ha, q)))


# ------------------------------------------------------------ bit-identical
@pytest.mark.parametrize("shards,qkw", [
    (None, dict(agg="sum", window=WindowSpec("tuple", 4))),
    (None, dict(agg="max", window=WindowSpec("time", 3.0, capacity=8))),
    (None, dict(agg="topk", agg_kwargs={"k": 3, "domain": 16},
                window=WindowSpec("tuple", 6, capacity=8))),
    (3, dict(agg="sum", window=WindowSpec("tuple", 4))),
    (3, dict(agg="min", window=WindowSpec("time", 3.0, capacity=8))),
], ids=["single-sum", "single-max-time", "single-topk", "sharded-sum",
        "sharded-min-time"])
def test_roundtrip_bit_identical(tmp_path, shards, qkw):
    sess = EagrSession(_graph(), shards=shards, device="cpu")
    h = sess.register(Query(**qkw))
    q, want = _drive(sess, h, integral=False)
    step = sess.save(str(tmp_path), blocking=True)
    assert step == sess._seq == sess.stats().last_checkpoint_step
    r = EagrSession.restore(str(tmp_path), device="cpu")
    (h2,) = r.queries
    assert r._seq == sess._seq and r.n_shards == (shards or 0)
    np.testing.assert_array_equal(r.read(h2, q), want)
    _lockstep(sess, h, r, h2, q)


@pytest.mark.parametrize("shards", [None, 3])
def test_roundtrip_with_churn(tmp_path, shards):
    sess = EagrSession(_graph(), shards=shards, device="cpu")
    h = sess.register(Query(agg="sum", window=WindowSpec("tuple", 4)))
    W, R = np.asarray(sess.writers), np.asarray(sess.readers)
    # churn BEFORE save: the checkpoint carries the patched plans
    sess.delete_edge(min(sess.neighborhood(int(R[3]))), int(R[3]))
    sess.add_edge(int(W[1]), int(R[3]))
    rep = sess.flush()
    assert rep.patched + rep.relayout + rep.recompiled >= 1
    q, want = _drive(sess, h)
    sess.save(str(tmp_path), blocking=True)
    r = EagrSession.restore(str(tmp_path), device="cpu")
    (h2,) = r.queries
    np.testing.assert_array_equal(r.read(h2, q), want)
    # post-restore churn: the lazily rebuilt journals patch the restored
    # plans exactly as the original session's journals do
    new = int(max(W.max(), R.max())) + 1
    for s in (sess, r):
        s.add_node(new, out_readers=[int(R[2]), int(R[5])])
    assert r.flush().journal_nodes >= 1
    sess.flush()
    for s in (sess, r):
        s.update(np.full(6, new, np.int64), np.ones(6, np.float32))
    np.testing.assert_array_equal(r.read(h2, q), sess.read(h, q))


@pytest.mark.parametrize("shards", [None, 3])
def test_roundtrip_with_alerts(tmp_path, shards):
    """Alert columns (armed/debounce state) restore verbatim: the restored
    session fires exactly what the saved one fires next, never re-firing
    what was delivered before the save."""
    sess = EagrSession(_graph(), shards=shards, device="cpu")
    h = sess.register(Query(agg="sum", window=WindowSpec("tuple", 4),
                            continuous=True))
    a = h.on_threshold(above=3.0, hysteresis=1.0)
    _drive(sess, h)
    assert sum(len(b) for b in a.fired()) > 0
    sess.save(str(tmp_path), blocking=True)
    r = EagrSession.restore(str(tmp_path), device="cpu")
    (a2,) = r.alerts
    assert a2.aid == a.aid
    for ids, vals in _stream(np.asarray(sess.writers), seed=21):
        sess.update(ids, vals)
        r.update(ids, vals)
    fa, fb = a.fired(), a2.fired()
    assert len(fa) == len(fb) and sum(len(b) for b in fa) > 0
    for x, y in zip(fa, fb):
        assert x.now == y.now
        np.testing.assert_array_equal(x.base_ids, y.base_ids)
        np.testing.assert_array_equal(x.values, y.values)


@pytest.mark.parametrize("shards", [None, 3])
def test_restore_skips_construction_mincut_and_compile(tmp_path, shards,
                                                       monkeypatch):
    sess = EagrSession(_graph(), shards=shards, device="cpu")
    h = sess.register(Query(agg="sum", window=WindowSpec("tuple", 4)))
    q, want = _drive(sess, h)
    sess.save(str(tmp_path), blocking=True)
    import repro_torch.core.dataflow as dataflow_mod
    import repro_torch.core.engine as engine_mod
    import repro_torch.distributed.eagr_shard as shard_mod
    import repro_torch.session as session_mod

    def boom(*a, **k):
        raise AssertionError("restore ran the cold path")

    monkeypatch.setattr(session_mod, "construct_vnm", boom)
    monkeypatch.setattr(dataflow_mod, "decide_mincut", boom)
    monkeypatch.setattr(engine_mod, "compile_plan", boom)
    monkeypatch.setattr(shard_mod, "compile_plan", boom)
    monkeypatch.setattr(shard_mod, "partition_overlay", boom)
    r = EagrSession.restore(str(tmp_path), device="cpu")
    (h2,) = r.queries
    np.testing.assert_array_equal(r.read(h2, q), want)


# ---------------------------------------------------------------- resharding
@pytest.mark.parametrize("old,new", [(3, 2), (3, 0), (0, 2)],
                         ids=["3to2", "3tosingle", "singleto2"])
def test_reshard_equals_reference_restore(tmp_path, old, new):
    """The same stream into both packages' sessions, each saved and
    restored into ``new`` shards: equal answers (sums within 1e-4, max
    exact), also after more traffic."""
    g_r, g_t = r_rmat(400, 2400, seed=7), _graph()
    ref = RSession(g_r, shards=old or None, backend="xla")
    port = EagrSession(g_t, shards=old or None, device="cpu")
    specs = [("sum", RSpec("tuple", 4), WindowSpec("tuple", 4)),
             ("max", RSpec("tuple", 4), WindowSpec("tuple", 4))]
    for a, rw, tw in specs:
        ref.register(RQuery(agg=a, window=rw))
        port.register(Query(agg=a, window=tw))
    for ids, vals in _stream(np.asarray(port.writers), integral=False):
        ref.update(ids, vals)
        port.update(ids, vals)
    ref.save(str(tmp_path / "r"), blocking=True)
    port.save(str(tmp_path / "t"), blocking=True)
    rr = RSession.restore(str(tmp_path / "r"), shards=new)
    rt = EagrSession.restore(str(tmp_path / "t"), shards=new, device="cpu")
    assert rt.n_shards == new == rr.n_shards
    q = np.random.default_rng(1).choice(np.asarray(rt.readers), 32)
    for rnd in range(2):
        for (a, _, _), hr, ht in zip(specs, rr.queries, rt.queries):
            want, got = np.asarray(rr.read(hr, q)), rt.read(ht, q)
            if a == "max":
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        for ids, vals in _stream(np.asarray(rt.writers), rounds=2,
                                 seed=40 + rnd, integral=False):
            rr.update(ids, vals)
            rt.update(ids, vals)


# --------------------------------------------------------- across packages
@pytest.mark.parametrize("shards,target", [(None, None), (3, None), (3, 2),
                                           (None, 2)],
                         ids=["single", "sharded", "reshard3to2",
                              "reshard1to2"])
def test_reference_checkpoint_restores_in_port(tmp_path, shards, target):
    ref = RSession(r_rmat(400, 2400, seed=7), shards=shards, backend="xla")
    hs = ref.register(RQuery(agg="sum", window=RSpec("tuple", 4)))
    hm = ref.register(RQuery(agg="max",
                             window=RSpec("time", 3.0, capacity=8)))
    for ids, vals in _stream(np.asarray(ref.writers), integral=False):
        ref.update(ids, vals)
    ref.save(str(tmp_path), blocking=True)
    port = EagrSession.restore(str(tmp_path), shards=target, device="cpu")
    q = np.random.default_rng(2).choice(np.asarray(port.readers), 32)
    ts, tm = port.queries
    if target is None:
        # same layout: taken verbatim, so the saved session's answers bit
        # for bit
        np.testing.assert_array_equal(port.read(ts, q),
                                      np.asarray(ref.read(hs, q)))
        np.testing.assert_array_equal(port.read(tm, q),
                                      np.asarray(ref.read(hm, q)))
    else:
        # a reshard re-evaluates every PAO at the saved clock: the JAX
        # package's own reshard of the same checkpoint is the yardstick
        rr = RSession.restore(str(tmp_path), shards=target)
        rs, rm = rr.queries
        np.testing.assert_allclose(port.read(ts, q),
                                   np.asarray(rr.read(rs, q)),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(port.read(tm, q),
                                      np.asarray(rr.read(rm, q)))


@pytest.mark.parametrize("shards,target", [(None, None), (3, None), (3, 2),
                                           (None, 2)],
                         ids=["single", "sharded", "reshard3to2",
                              "reshard1to2"])
def test_port_checkpoint_restores_in_reference(tmp_path, shards, target):
    port = EagrSession(_graph(), shards=shards, device="cpu")
    ts = port.register(Query(agg="sum", window=WindowSpec("tuple", 4)))
    tm = port.register(Query(agg="max",
                             window=WindowSpec("time", 3.0, capacity=8)))
    for ids, vals in _stream(np.asarray(port.writers), integral=False):
        port.update(ids, vals)
    port.save(str(tmp_path), blocking=True)
    arrays, objs, _ = CheckpointManager(str(tmp_path)).restore_payload()
    assert objs["config"]["backend"] is None
    ref = RSession.restore(str(tmp_path), shards=target)
    q = np.random.default_rng(2).choice(np.asarray(port.readers), 32)
    rs, rm = ref.queries
    if target is not None:
        # a reshard re-evaluates every PAO at the saved clock: the port's
        # own reshard of the same checkpoint is the yardstick
        port = EagrSession.restore(str(tmp_path), shards=target,
                                   device="cpu")
        ts, tm = port.queries
    np.testing.assert_allclose(np.asarray(ref.read(rs, q)), port.read(ts, q),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(ref.read(rm, q)),
                                  port.read(tm, q))
    # and the reference keeps serving the restored state
    for ids, vals in _stream(np.asarray(port.writers), rounds=2, seed=9):
        ref.update(ids, vals)
        port.update(ids, vals)
    np.testing.assert_array_equal(np.asarray(ref.read(rm, q)),
                                  port.read(tm, q))


# ------------------------------------------------------------- crash safety
_CRASH_CHILD = """
import os, sys
import numpy as np
from repro_torch import EagrSession, Query, WindowSpec
from repro_torch.graphs.generators import rmat_graph

sess = EagrSession(rmat_graph(400, 2400, seed=7), device="cpu",
                   shards=int(sys.argv[3]) or None)
sess.register(Query(agg="sum", window=WindowSpec("tuple", 4)))
rng = np.random.default_rng(0)
W = np.asarray(sess.writers)
sess.update(rng.choice(W, 20), np.ones(20, np.float32))
sess.save(sys.argv[1], blocking=True)        # step 1 commits
sess.update(rng.choice(W, 20), np.ones(20, np.float32))
os.environ["EAGR_CKPT_CRASH"] = sys.argv[2]  # arm the fault
sess.save(sys.argv[1], blocking=True)        # step 2 dies mid-write
raise SystemExit("unreachable: crash hook did not fire")
"""


@pytest.mark.parametrize("stage,shards", [("arrays", 0), ("manifest", 3)])
def test_kill_mid_save_keeps_last_committed_step(tmp_path, stage, shards):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    env.pop("EAGR_CKPT_CRASH", None)
    p = subprocess.run([sys.executable, "-c", _CRASH_CHILD, str(tmp_path),
                        stage, str(shards)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 17, p.stderr[-2000:]
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [1]
    assert os.path.isdir(tmp_path / "step_00000002.tmp")
    r = EagrSession.restore(str(tmp_path), device="cpu")
    assert r._seq == 1 and r.n_shards == shards
    (h,) = r.queries
    assert np.isfinite(r.read(h, np.asarray(r.readers)[:8])).all()


# ----------------------------------------------------------- auto + gc
def test_auto_checkpoint_and_gc(tmp_path, monkeypatch):
    monkeypatch.setenv("EAGR_CKPT_DIR", str(tmp_path))
    monkeypatch.setenv("EAGR_CKPT_EVERY", "2")
    monkeypatch.setenv("EAGR_CKPT_KEEP", "2")
    sess = EagrSession(_graph(), device="cpu", shards=2)
    h = sess.register(Query(agg="sum", window=WindowSpec("tuple", 4)))
    W = np.asarray(sess.writers)
    for _ in range(7):
        sess.update(W[:5], np.ones(5, np.float32))
    sess.wait_for_checkpoint()
    steps = CheckpointManager(str(tmp_path)).all_steps()
    assert steps == [4, 6]         # every 2nd batch; the newest 2 kept
    assert sess.stats().last_checkpoint_step == 6
    r = EagrSession.restore(str(tmp_path), device="cpu")
    assert r._seq == 6
    sess2 = EagrSession(_graph(), device="cpu", ckpt_dir=str(tmp_path / "x"),
                        ckpt_every=3, ckpt_keep=1)
    assert (sess2.ckpt_every, sess2.ckpt_keep) == (3, 1)
    monkeypatch.delenv("EAGR_CKPT_DIR")
    with pytest.raises(ValueError, match="no checkpoint directory"):
        EagrSession(_graph(), device="cpu").save()
    assert EagrSession.restore(str(tmp_path), step=4, device="cpu")._seq == 4
    (h2,) = r.queries
    r.update(W[:5], np.ones(5, np.float32))
    sess.update(W[:5], np.ones(5, np.float32))
    q = np.asarray(r.readers)[:16]
    np.testing.assert_array_equal(r.read(h2, q), sess.read(h, q))


def test_save_quiesces_ring_and_pending_churn(tmp_path):
    sess = EagrSession(_graph(), device="cpu", shards=2, ingest_depth=2,
                       ingest_batch=32)
    h = sess.register(Query(agg="sum", window=WindowSpec("tuple", 4)))
    q, _ = _drive(sess, h)
    W, R = np.asarray(sess.writers), np.asarray(sess.readers)
    sess.update(W[:7], np.ones(7, np.float32))       # a partial ring slot
    sess.add_edge(int(W[0]), int(R[1]))
    assert sess._pending
    sess.save(str(tmp_path), blocking=True)          # flushes both first
    assert not sess._pending
    r = EagrSession.restore(str(tmp_path), device="cpu")
    (h2,) = r.queries
    np.testing.assert_array_equal(r.read(h2, q), sess.read(h, q))
    assert r.stats().ingest.events_in == sess.stats().ingest.events_in


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
@pytest.mark.parametrize("shards", [None, 2])
def test_cross_format_carries_alerts_and_ingest(tmp_path, direction, shards):
    """A pipelined session with a standing alert, saved by one package and
    restored by the other: the ingest counters carry over, the alert's
    armed/debounce state restores verbatim, and on the same stream
    afterwards both fire the same sets with equal answers."""
    def build(pkg):
        if pkg == "r":
            s = RSession(r_rmat(400, 2400, seed=7), shards=shards,
                         backend="xla", ingest_depth=2, ingest_batch=32)
            h = s.register(RQuery(agg="sum", window=RSpec("tuple", 4),
                                  continuous=True))
        else:
            s = EagrSession(_graph(), shards=shards, device="cpu",
                            ingest_depth=2, ingest_batch=32)
            h = s.register(Query(agg="sum", window=WindowSpec("tuple", 4),
                                 continuous=True))
        return s, h, h.on_threshold(above=3.0, hysteresis=1.0)

    src, dst = ("r", "t") if direction == "reference_to_port" else ("t", "r")
    a, ha, aa = build(src)
    b, hb, ab = build(dst)
    for ids, vals in _stream(np.asarray(b.writers)):
        a.update(ids, vals)
        b.update(ids, vals)
    assert len(aa.fired()) == len(ab.fired()) > 0
    a.save(str(tmp_path), blocking=True)
    r = RSession.restore(str(tmp_path)) if dst == "r" else \
        EagrSession.restore(str(tmp_path), device="cpu")
    (hr,), (ar,) = r.queries, r.alerts
    assert r.stats().ingest.events_in == a.stats().ingest.events_in
    for ids, vals in _stream(np.asarray(b.writers), seed=21):
        a.update(ids, vals)
        r.update(ids, vals)
    fa, fr = aa.fired(), ar.fired()
    assert len(fa) == len(fr) and sum(len(x) for x in fa) > 0
    for x, y in zip(fa, fr):
        assert x.now == y.now
        np.testing.assert_array_equal(x.base_ids, y.base_ids)
        np.testing.assert_allclose(x.values, y.values, rtol=1e-5)
    q = np.random.default_rng(5).choice(np.asarray(b.readers), 24)
    np.testing.assert_allclose(np.asarray(r.read(hr, q)),
                               np.asarray(a.read(ha, q)), rtol=1e-4,
                               atol=1e-4)
