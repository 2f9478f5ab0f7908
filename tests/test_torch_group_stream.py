"""EAGr's streaming and recovery on a group of ranks: the ingest ring over a
group's stacked engines, ``SessionRecoveryDriver`` run SPMD, and
``EagrSession.restore(dir, shards=M)`` resharding onto a group of M ranks.

A 3-rank gloo group on the CPU (one shard a rank) runs every case while the
parent runs the same cases on the one-card stack, and a subprocess runs the
JAX package's ``shard_map`` session on 3 forced CPU devices. The inputs come
from one plan the parent writes first (the stream, the churn burst, the
alert's readers, the driver's batches), with integral values, so any order
of reduction is exact:

  (a) a ring session (``ingest_depth=2``, device batches of 64 coalesced
      from arrival batches of 40) with ``sum``, ``max`` and ``count``
      queries and a continuous ``sum``: the group's state, answers and
      fired sets equal the one-card stack's ring bit for bit, the group's
      synchronous session fed at the ring's device-batch boundaries, and
      the JAX package's ring session;
  (b) in the same stream a churn burst flushed through the ring barrier
      and a standing alert registered mid-stream;
  (c) the recovery driver over a ring session, ``fail_at={13, 27}``,
      ``ckpt_every=8``: recovered equals uninterrupted on the group, the
      one-card driver and the JAX package's driver;
  (d) restores of a single-engine, a 2-shard and a 4-shard checkpoint (each
      with a ring and a standing alert) with ``shards=3`` onto the group,
      against one card's ``restore(shards=3)`` and the JAX package's;
  (e) no rank of the group loads JAX or the JAX package.

Every collective has a timeout and the spawn a join deadline, so a hung
rank fails the tests instead of stalling the suite."""
import os
import pickle
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import EagrSession, Query, WindowSpec  # noqa: E402
from repro_torch.core.bipartite import build_bipartite  # noqa: E402
from repro_torch.distributed import SessionRecoveryDriver  # noqa: E402
from repro_torch.graphs.generators import rmat_graph  # noqa: E402
from repro_torch.launch import mesh as PM  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
N_SHARDS = 3
GRAPH = dict(n_nodes=200, n_edges=1200, seed=9)   # rmat_graph's
AGGS = ("sum", "max", "count")
DEPTH, DEVICE_BATCH, ARRIVAL = 2, 64, 40
ARRIVALS = 16                # arrival batches of the ring stream
READ_EVERY = 4               # a read of every query after every 4th
CHURN_AT, ALERT_AT = 6, 9    # the burst lands, the alert registers, before
ALERT = dict(above=12.0, hysteresis=2.0)
DRIVER_BATCHES, DRIVER_EVERY, DRIVER_FAIL = 30, 8, (13, 27)
RESHARD_FROM = (0, 2, 4)     # saved layouts restored with shards=3
SAVED_ARRIVALS, AFTER_ARRIVALS = 8, 4
COLLECTIVE_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 240.0


# ------------------------------------------------------------- the cases
def _plan() -> dict:
    """Every input of every case, from the graph's bipartite spec and one
    seed: arrival batches of ``ARRIVAL`` integral writes, the churn burst,
    the alert's readers, the read sample, the driver's batches."""
    bp = build_bipartite(rmat_graph(**GRAPH))
    writers = np.asarray(sorted(bp.writers), np.int64)
    inputs = bp.reader_input_sets()
    readers = np.asarray(sorted(r for r, ws in inputs.items() if ws),
                         np.int64)
    rng = np.random.default_rng(28)

    def batch():
        return (rng.choice(writers, ARRIVAL),
                rng.integers(0, 8, ARRIVAL).astype(np.float32))

    hit = rng.choice(readers, 4, replace=False)
    churn = []
    for r in hit[:3]:
        w = int(next(w for w in rng.permutation(writers)
                     if w not in inputs[int(r)] and w != r))
        churn.append(("add_edge", w, int(r)))
    churn.append(("delete_edge", int(min(inputs[int(hit[3])])),
                  int(hit[3])))
    calm = np.setdiff1d(readers, hit)
    return dict(
        arrivals=[batch() for _ in range(ARRIVALS)],
        after=[batch() for _ in range(AFTER_ARRIVALS)],
        driver=[batch() for _ in range(DRIVER_BATCHES)],
        churn=churn, alert_readers=[int(r) for r in calm[::3]],
        q=rng.choice(calm, 48))


def _ring_session(session_cls, query, spec, *, depth=DEPTH, shards=N_SHARDS,
                  **kw):
    """The session of cases (a) and (b) (either package's classes): one
    query of each of AGGS and a continuous sum, which the alert rides."""
    s = session_cls(_rmat_graph_of(session_cls)(**GRAPH), shards=shards,
                    ingest_depth=depth, ingest_batch=DEVICE_BATCH, **kw)
    hs = [s.register(query(agg=a, window=spec("tuple", 4))) for a in AGGS]
    hs.append(s.register(query(agg="sum", window=spec("tuple", 4),
                               continuous=True)))
    return s, hs


def _rmat_graph_of(session_cls):
    """The generator of the session's own package."""
    if session_cls is EagrSession:
        return rmat_graph
    from repro.graphs.generators import rmat_graph as r_rmat
    return r_rmat


def _fired(batches) -> list:
    return [(float(b.now), np.asarray(b.base_ids), np.asarray(b.values),
             np.asarray(b.aids)) for b in batches]


class _AtRingBoundaries:
    """Feeds a synchronous session the ring's device batches: events
    accumulate to ``DEVICE_BATCH`` and go as one ``update``; ``cut``
    sends the partial batch, where the ring would dispatch its slot."""

    def __init__(self, session):
        self.s, self.ids, self.vals = session, [], []

    def feed(self, ids, vals):
        self.ids.extend(np.asarray(ids).tolist())
        self.vals.extend(np.asarray(vals).tolist())
        while len(self.ids) >= DEVICE_BATCH:
            self._send(DEVICE_BATCH)

    def cut(self):
        if self.ids:
            self._send(len(self.ids))

    def _send(self, n):
        self.s.update(np.asarray(self.ids[:n], np.int64),
                      np.asarray(self.vals[:n], np.float32))
        del self.ids[:n], self.vals[:n]


def _ring_script(s, hs, plan, feed, cut) -> dict:
    """Cases (a) and (b) on one session: the arrival batches through
    ``feed``; the burst flushed before batch CHURN_AT, the alert registered
    before batch ALERT_AT, reads of every query and a drain of the fired
    sets after every READ_EVERY-th batch. ``cut`` runs where the ring
    dispatches a partial slot (a no-op for the ring itself)."""
    out = dict(reads=[], fired=[])
    alert = None
    for k, (ids, vals) in enumerate(plan["arrivals"]):
        if k == CHURN_AT:
            cut()
            for op, u, v in plan["churn"]:
                getattr(s, op)(u, v)
            rep = s.flush()
            out["kinds"] = (rep.patched, rep.relayout, rep.recompiled)
        if k == ALERT_AT:
            cut()
            alert = s.register_alert(hs[-1], readers=plan["alert_readers"],
                                     **ALERT)
        feed(ids, vals)
        if k % READ_EVERY == READ_EVERY - 1:
            cut()
            out["reads"].append([np.asarray(s.read(h, plan["q"]))
                                 for h in hs])
            if alert is not None:
                out["fired"] += _fired(s.drain_fired())
    return out


def _states(s) -> list:
    """Every group's whole-stack state as host arrays (a collective on a
    group: every rank calls it)."""
    out = []
    for h in s.queries:
        st = h.group.engine.global_state_host()
        out.append([np.asarray(x).copy()
                    for x in (*st.windows, st.pao, st.now)])
    return out


def _on_group(s) -> list:
    return [h.group.engine.mesh is not None for h in s.queries]


def _driver_session():
    s = EagrSession(rmat_graph(**GRAPH), shards=N_SHARDS, device="cpu",
                    ingest_depth=DEPTH, ingest_batch=DEVICE_BATCH)
    for a in ("sum", "max"):
        s.register(Query(agg=a, window=WindowSpec("tuple", 4)))
    return s


def _driver(plan, directory, fail) -> dict:
    drv = SessionRecoveryDriver(_driver_session,
                                lambda seq: plan["driver"][seq], directory,
                                ckpt_every=DRIVER_EVERY, device="cpu")
    s = drv.run(DRIVER_BATCHES, fail_at=set(fail) if fail else None)
    return dict(seq=s._seq, restarts=drv.report.restarts, states=_states(s),
                reads=[s.read(h, plan["q"]) for h in s.queries],
                on_group=_on_group(s))


def _saved(plan, m: int, work: str):
    """A ring session of ``m`` shards (0: one engine) with a standing alert,
    driven on SAVED_ARRIVALS batches and saved to ``src_{m}``; returns its
    reads at the save."""
    s, hs = _ring_session(EagrSession, Query, WindowSpec, shards=m or None,
                          device="cpu")
    s.register_alert(hs[-1], readers=plan["alert_readers"], **ALERT)
    for ids, vals in plan["arrivals"][:SAVED_ARRIVALS]:
        s.update(ids, vals)
    want = [s.read(h, plan["q"]) for h in hs]
    s.drain_fired()
    s.save(os.path.join(work, f"src_{m}"), blocking=True)
    return want


def _restored(plan, m: int, work: str) -> dict:
    """Case (d): the ``src_{m}`` checkpoint restored with shards=3, its
    first reads, then AFTER_ARRIVALS batches through the carried ring."""
    r = EagrSession.restore(os.path.join(work, f"src_{m}"), shards=N_SHARDS,
                            device="cpu")
    out = dict(first=[r.read(h, plan["q"]) for h in r.queries],
               depth=r.ingest_depth, alerts=len(r.alerts),
               n_shards=r.n_shards, on_group=_on_group(r))
    for ids, vals in plan["after"]:
        r.update(ids, vals)
    out["after"] = [r.read(h, plan["q"]) for h in r.queries]
    out["fired"] = _fired(r.drain_fired())
    out["states"] = _states(r)
    return out


def _cases(plan, work: str, tag: str) -> dict:
    """Every case on this process's engines: one shard a rank inside the
    group, the one-card stack outside it. The group also runs the
    synchronous session and the uninterrupted driver."""
    out = {}
    s, hs = _ring_session(EagrSession, Query, WindowSpec, device="cpu")
    out["ring"] = _ring_script(s, hs, plan, s.update, lambda: None)
    out["ring"].update(states=_states(s), on_group=_on_group(s),
                       ingest=s.stats().ingest.as_dict())
    del s, hs
    if tag == "group":
        s, hs = _ring_session(EagrSession, Query, WindowSpec, depth=0,
                              device="cpu")
        at = _AtRingBoundaries(s)
        out["sync"] = _ring_script(s, hs, plan, at.feed, at.cut)
        out["sync"].update(states=_states(s), on_group=_on_group(s),
                           ingest=s.stats().ingest)
        del s, hs
        out["clean"] = _driver(plan, os.path.join(work, f"clean_{tag}"),
                               None)
    out["fault"] = _driver(plan, os.path.join(work, f"fault_{tag}"),
                           DRIVER_FAIL)
    for m in RESHARD_FROM:
        out[("reshard", m)] = _restored(plan, m, work)
    return out


# ------------------------------------------------------------ the group
def _rank(rank, store, work):
    """One rank of the group: every case on its own shard, the results to
    ``rank{rank}.pkl``."""
    torch.set_num_threads(1)
    PM.init_group(rank, N_SHARDS, store, backend="gloo",
                  timeout_s=COLLECTIVE_TIMEOUT_S)
    import torch.distributed as dist

    try:
        with open(os.path.join(work, "plan.pkl"), "rb") as f:
            plan = pickle.load(f)
        out = _cases(plan, work, "group")
        out["loaded"] = sorted(k for k in sys.modules
                               if k == "jax" or k.startswith("jax.")
                               or k == "repro" or k.startswith("repro."))
        with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


_JAX = textwrap.dedent("""
    import os, pickle, sys
    import numpy as np
    import jax
    work, tests = sys.argv[1], sys.argv[2]
    sys.path.insert(0, tests)
    import test_torch_group_stream as T
    from repro.core.window import WindowSpec
    from repro.distributed.fault import SessionRecoveryDriver
    from repro.graphs.generators import rmat_graph
    from repro.session import EagrSession, Query
    assert len(jax.devices()) == T.N_SHARDS
    with open(os.path.join(work, "plan.pkl"), "rb") as f:
        plan = pickle.load(f)
    out = {}
    s, hs = T._ring_session(EagrSession, Query, WindowSpec, backend="xla")
    assert all(h.group.engine.mesh is not None for h in hs), "no mesh"
    out["ring"] = T._ring_script(s, hs, plan, s.update, lambda: None)
    del s, hs

    def make():
        s = EagrSession(rmat_graph(**T.GRAPH), shards=T.N_SHARDS,
                        backend="xla", ingest_depth=T.DEPTH,
                        ingest_batch=T.DEVICE_BATCH)
        for a in ("sum", "max"):
            s.register(Query(agg=a, window=WindowSpec("tuple", 4)))
        return s

    drv = SessionRecoveryDriver(make, lambda seq: plan["driver"][seq],
                                os.path.join(work, "fault_jax"),
                                ckpt_every=T.DRIVER_EVERY)
    s = drv.run(T.DRIVER_BATCHES, fail_at=set(T.DRIVER_FAIL))
    assert all(h.group.engine.mesh is not None for h in s.queries)
    out["fault"] = dict(restarts=drv.report.restarts, reads=[
        np.asarray(s.read(h, plan["q"])) for h in s.queries])
    for m in T.RESHARD_FROM:
        r = EagrSession.restore(os.path.join(work, f"src_{m}"),
                                shards=T.N_SHARDS)
        assert all(h.group.engine.mesh is not None for h in r.queries)
        first = [np.asarray(r.read(h, plan["q"])) for h in r.queries]
        for ids, vals in plan["after"]:
            r.update(ids, vals)
        out[("reshard", m)] = dict(first=first, after=[
            np.asarray(r.read(h, plan["q"])) for h in r.queries],
            fired=T._fired(r.drain_fired()))
    with open(os.path.join(work, "jax.pkl"), "wb") as f:
        pickle.dump(out, f)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The group's results by rank, the one-card results, the JAX
    package's, the saved sessions' reads and the working directory."""
    work = str(tmp_path_factory.mktemp("group_stream"))
    plan = _plan()
    with open(os.path.join(work, "plan.pkl"), "wb") as f:
        pickle.dump(plan, f)
    saved = {m: _saved(plan, m, work) for m in RESHARD_FROM}
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", EAGR_BACKEND="xla",
               XLA_FLAGS="--xla_force_host_platform_device_count="
                         f"{N_SHARDS}")
    ref = subprocess.Popen([sys.executable, "-c", _JAX, work, HERE],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    errors = []

    def group():
        try:
            PM.spawn_group(_rank, N_SHARDS,
                           args=(os.path.join(work, "store"), work),
                           join_timeout_s=JOIN_TIMEOUT_S)
        except BaseException as e:  # re-raised in the parent below
            errors.append(e)

    t = threading.Thread(target=group)
    t.start()
    try:
        one = _cases(plan, work, "one")
    finally:
        t.join()
        log, _ = ref.communicate(timeout=JOIN_TIMEOUT_S)
    if errors:
        raise errors[0]
    assert ref.returncode == 0, log
    ranks = []
    for r in range(N_SHARDS):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    with open(os.path.join(work, "jax.pkl"), "rb") as f:
        jax_out = pickle.load(f)
    return dict(ranks=ranks, one=one, jax=jax_out, saved=saved, work=work)


def _equal(a, b, what):
    """Nested lists of arrays equal bit for bit (signed zeros included)."""
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
        return
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        x, y = np.ascontiguousarray(a), np.ascontiguousarray(b)
        assert x.shape == y.shape and x.dtype == y.dtype, what
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), what
        return
    assert a == b, what


def _same_values(a, b, what):
    """Nested lists of arrays equal as values (the JAX package's sums may
    turn -0.0 into +0.0); integral inputs make every sum exact."""
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same_values(x, y, f"{what}[{i}]")
        return
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=what)
        return
    assert a == b, what


# ------------------------------------------------------------- the tests
def test_group_ring_bit_equal_to_one_card_ring(runs):
    """(a), (b): the ring on the group against the one-card stack's ring,
    state, answers and fired sets, across the burst and the alert."""
    want = runs["one"]["ring"]
    assert want["on_group"] == [False] * 4
    assert sum(len(f[1]) for f in want["fired"]) > 0
    assert want["ingest"]["partial_batches"] > 0
    assert want["kinds"][2] == 0 and sum(want["kinds"]) > 0
    for r, out in enumerate(runs["ranks"]):
        got = out["ring"]
        assert got["on_group"] == [True] * 4, f"rank {r}"
        assert got["kinds"] == want["kinds"], f"rank {r}"
        for k in ("events_in", "events_dispatched", "batches",
                  "partial_batches", "flushes"):
            assert got["ingest"][k] == want["ingest"][k], (r, k)
        _equal(got["reads"], want["reads"], f"rank {r} reads")
        _equal(got["fired"], want["fired"], f"rank {r} fired")
        _equal(got["states"], want["states"], f"rank {r} states")


def test_group_ring_bit_equal_to_group_sync_at_ring_boundaries(runs):
    """(a): pipelined equals synchronous on the group when the synchronous
    session's batches are the ring's device batches."""
    for r, out in enumerate(runs["ranks"]):
        ring, sync = out["ring"], out["sync"]
        assert sync["ingest"] is None and sync["on_group"] == [True] * 4
        assert sync["kinds"] == ring["kinds"], f"rank {r}"
        _equal(sync["reads"], ring["reads"], f"rank {r} reads")
        _equal(sync["fired"], ring["fired"], f"rank {r} fired")
        _equal(sync["states"], ring["states"], f"rank {r} states")


def test_group_ring_equals_jax_shard_map_session(runs):
    want = runs["jax"]["ring"]
    for r, out in enumerate(runs["ranks"]):
        got = out["ring"]
        assert got["kinds"] == tuple(want["kinds"]), f"rank {r}"
        _same_values(got["reads"], want["reads"], f"rank {r} reads")
        _same_values(got["fired"], want["fired"], f"rank {r} fired")


def test_group_recovery_driver_replays_bit_equal(runs):
    """(c): two injected failures on every rank, recovered equal to the
    uninterrupted group run and to the one-card driver, bit for bit."""
    one = runs["one"]["fault"]
    assert one["restarts"] == 2 and one["seq"] == DRIVER_BATCHES
    for r, out in enumerate(runs["ranks"]):
        fault, clean = out["fault"], out["clean"]
        assert fault["restarts"] == 2 and clean["restarts"] == 0, f"rank {r}"
        assert fault["seq"] == clean["seq"] == DRIVER_BATCHES
        assert fault["on_group"] == clean["on_group"] == [True, True]
        _equal(fault["states"], clean["states"], f"rank {r} states")
        _equal(fault["reads"], clean["reads"], f"rank {r} reads")
        _equal(fault["states"], one["states"], f"rank {r} one card")
        _equal(fault["reads"], one["reads"], f"rank {r} one card")


def test_group_recovery_driver_equals_jax_driver(runs):
    want = runs["jax"]["fault"]
    assert want["restarts"] == 2
    for r, out in enumerate(runs["ranks"]):
        _same_values(out["fault"]["reads"], want["reads"], f"rank {r}")


@pytest.mark.parametrize("m", RESHARD_FROM, ids=["single", "2", "4"])
def test_reshard_onto_group_bit_equal_to_one_card(runs, m):
    """(d): an m-shard checkpoint restored with shards=3 onto the group
    equals one card's restore(shards=3) bit for bit (first reads, state,
    and reads and fired sets after writes through the carried ring), and
    its first reads equal the saved session's."""
    want = runs["one"][("reshard", m)]
    assert want["on_group"] == [False] * 4 and want["n_shards"] == N_SHARDS
    assert want["depth"] == DEPTH and want["alerts"] == 1
    _same_values(want["first"], runs["saved"][m], "one card against saved")
    for r, out in enumerate(runs["ranks"]):
        got = out[("reshard", m)]
        assert got["on_group"] == [True] * 4, f"rank {r}"
        assert (got["depth"], got["alerts"], got["n_shards"]) == \
            (DEPTH, 1, N_SHARDS)
        for k in ("first", "after", "fired", "states"):
            _equal(got[k], want[k], f"rank {r} {k}")


@pytest.mark.parametrize("m", RESHARD_FROM, ids=["single", "2", "4"])
def test_reshard_onto_group_equals_jax_reshard(runs, m):
    want = runs["jax"][("reshard", m)]
    for r, out in enumerate(runs["ranks"]):
        got = out[("reshard", m)]
        for k in ("first", "after", "fired"):
            _same_values(got[k], want[k], f"rank {r} {k}")


def test_group_ranks_load_no_jax(runs):
    """(e): the ranks ran every case without JAX or the JAX package."""
    for r, out in enumerate(runs["ranks"]):
        assert out["loaded"] == [], f"rank {r}: {out['loaded']}"
