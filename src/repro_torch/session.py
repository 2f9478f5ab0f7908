"""``EagrSession`` — one declarative front door for continuous ego-centric
aggregation, on one device (the static single-engine slice of the port).

    session = EagrSession(graph)                       # overlay built once
    trends  = session.register(Query(agg="topk", agg_kwargs={"k": 3},
                                     window=WindowSpec("tuple", 16)))
    session.update(writer_ids, topic_ids)              # one write stream
    session.read(trends, user_ids)                     # per-query reads

Queries registered with equal ``(aggregate, window, continuous)`` specs are
grouped into one *engine group* — one set of push/pull decisions, one
compiled plan, one window/PAO state — the paper's aggregate sharing expressed
in the API. Distinct specs get their own group over the *same* overlay
construction (the expensive VNM pass runs exactly once per session).

Graph mutations (``add_edge``/``delete_edge``/``add_node``/
``delete_node``) are journaled per group and land on the live plans at
``flush()`` through the in-place patch path (§3.3); ``adapt()`` re-runs the
§4.8 push/pull decision against observed traffic.

With ``ingest_depth=N`` updates flow through a pipelined ring of N pinned
slots (``streams/ingest.py``), coalesced into device batches of
``ingest_batch`` events; standing alerts (``register_alert`` /
``QueryHandle.on_threshold``) are evaluated on the device after every write
step and drained with ``drain_fired`` (``streams/alerts.py``).

The session runs on CUDA unless the caller passes ``device="cpu"``; without
a card and without that argument it raises. Checkpoints and shards are
later slices of the port: their entry points raise ``NotImplementedError``
naming the ROADMAP.md item.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Mapping

import numpy as np

from repro_torch.core import dataflow as D
from repro_torch.core.aggregates import Aggregate, make_aggregate
from repro_torch.core.bipartite import Bipartite, build_bipartite
from repro_torch.core.dynamic import DynamicOverlay
from repro_torch.core.engine import EagrEngine, bucket_batch, not_ported
from repro_torch.core.vnm import construct_vnm
from repro_torch.core.window import WindowSpec
from repro_torch.device import resolve_device

__all__ = ["Query", "QueryHandle", "EagrSession", "bucket_batch",
           "SessionStats", "FlushReport", "AdaptReport", "AlertHandle"]


# ------------------------------------------------------------------- queries
@dataclasses.dataclass(frozen=True)
class Query:
    """Declarative spec of one continuous ego-centric aggregate query.

    ``agg`` is a built-in aggregate name (see ``aggregates.BUILTINS``) or a
    constructed :class:`Aggregate`; ``agg_kwargs`` feed the built-in
    constructor (e.g. ``{"k": 3, "domain": 64}`` for top-k). ``window``
    defaults to the paper's ``c = 1`` last-value tuple window. ``readers``
    optionally scopes the query to a subset of ego nodes — reads outside the
    scope are rejected. ``continuous=True`` pins all-push decisions (results
    always fresh) instead of cost-optimized push/pull.
    """

    agg: "str | Aggregate" = "count"
    window: WindowSpec | None = None
    readers: "Iterable[int] | None" = None
    continuous: bool = False
    agg_kwargs: Mapping | None = None

    def __post_init__(self):
        if self.readers is not None:
            object.__setattr__(self, "readers",
                               frozenset(int(r) for r in self.readers))

    def resolve(self) -> tuple[Aggregate, WindowSpec]:
        """Construct the aggregate and validate aggregate/window compatibility
        *now*, so a bad spec fails at ``register`` with a naming error instead
        of deep inside plan compilation or the first masked write."""
        agg = make_aggregate(self.agg, **dict(self.agg_kwargs or {}))
        spec = self.window or WindowSpec(kind="tuple", size=1)
        if not isinstance(spec, WindowSpec):
            raise ValueError(f"Query.window must be a WindowSpec, "
                             f"got {type(spec).__name__}")
        if spec.kind not in ("tuple", "time"):
            raise ValueError(f"unknown window kind {spec.kind!r}; "
                             f"choose 'tuple' or 'time'")
        if spec.kind == "time" and not spec.capacity:
            raise ValueError(
                "time windows need an explicit ring capacity: "
                "WindowSpec('time', T, capacity=...) — the ring must hold "
                "every write that can arrive within T")
        if spec.size < 1:
            raise ValueError(f"window size must be >= 1, got {spec.size}")
        if spec.capacity and spec.kind == "tuple" \
                and spec.capacity < int(spec.size):
            raise ValueError(
                f"tuple window of c={int(spec.size)} cannot fit in a ring of "
                f"capacity {spec.capacity}")
        # the aggregate declares the raw write arity its lift consumes
        expected = agg.value_dim
        if spec.value_dim != expected:
            raise ValueError(
                f"aggregate {agg.name!r} consumes value_dim={expected} "
                f"writes but the window carries value_dim={spec.value_dim}")
        if self.readers is not None and not self.readers:
            raise ValueError("Query.readers is empty — omit it (None) to "
                             "cover every reader")
        return agg, spec


@dataclasses.dataclass(frozen=True, eq=False)
class QueryHandle:
    """Registered query: the ticket ``read`` answers against. Handles of one
    engine group share plan, windows and PAOs (aggregate sharing)."""

    qid: int
    query: Query
    agg: Aggregate
    spec: WindowSpec
    session: "EagrSession"
    group: "_EngineGroup"
    # sorted array cache of `readers` for the vectorized scope check —
    # lazily materialized by EagrSession.read
    _reader_arr: "np.ndarray | None" = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def readers(self) -> "frozenset[int] | None":
        return self.query.readers

    def read(self, ids) -> np.ndarray:
        return self.session.read(self, ids)

    def on_threshold(self, *, above=None, below=None, delta=None,
                     hysteresis: float = 0.0, debounce: float = 0.0,
                     component: int = 0, readers=None) -> "AlertHandle":
        """Register a standing alert on this query — sugar for
        :meth:`EagrSession.register_alert`. Thresholds may be scalars or
        per-reader arrays (matched against the sorted reader list)."""
        from repro_torch.streams.alerts import AlertSpec
        return self.session.register_alert(
            self, AlertSpec(above=above, below=below, delta=delta,
                            hysteresis=hysteresis, debounce=debounce,
                            component=component),
            readers=readers)


@dataclasses.dataclass(frozen=True, eq=False)
class AlertHandle:
    """Registered standing alert: the ticket fired batches are attributed to
    and drained with (:meth:`EagrSession.drain_fired`)."""

    aid: int
    spec: "object"           # streams.alerts.AlertSpec
    query: QueryHandle
    session: "EagrSession"

    def fired(self) -> list:
        """Drain this alert's :class:`~repro_torch.streams.alerts.FiredBatch`
        es."""
        return self.session.drain_fired(self)


class FlushReport(list):
    """Typed result of :meth:`EagrSession.flush`: the list of per-group
    patch results (``PatchResult``, or ``None`` for a group with an empty
    journal), plus counters over them:

    * ``patched`` — plans updated in place through the §3.3 patch path
    * ``relayout`` — patches that rebuilt level tables within capacity
    * ``recompiled`` — genuine capacity overflows (a fresh compile)
    * ``journal_nodes`` — overlay nodes the drained journals carried
    """

    def __init__(self, results, *, patched: int = 0, recompiled: int = 0,
                 relayout: int = 0, journal_nodes: int = 0):
        super().__init__(results)
        self.patched = patched
        self.recompiled = recompiled
        self.relayout = relayout
        self.journal_nodes = journal_nodes

    def __repr__(self) -> str:
        return (f"FlushReport(groups={len(self)}, patched={self.patched}, "
                f"relayout={self.relayout}, recompiled={self.recompiled}, "
                f"journal_nodes={self.journal_nodes})")


class AdaptReport(int):
    """Typed result of :meth:`EagrSession.adapt`: the total §4.8
    decision-flip count as an ``int``, plus the per-group breakdown."""

    per_group: tuple

    def __new__(cls, per_group=()):
        self = super().__new__(cls, sum(per_group))
        self.per_group = tuple(int(f) for f in per_group)
        return self

    @property
    def flips(self) -> int:
        return int(self)

    def __repr__(self) -> str:
        return f"AdaptReport(flips={int(self)}, per_group={self.per_group})"


@dataclasses.dataclass
class SessionStats:
    """Counter snapshot of a session (:meth:`EagrSession.stats`)."""

    n_queries: int
    n_engine_groups: int
    n_shards: int                   # always 0: one engine per group
    updates: int                    # update() batches applied
    pending_mutations: bool
    journal_nodes: int              # overlay nodes awaiting the next flush
    patches_applied: int            # in-place patches, all plans
    frontier: dict                  # frontier-size distribution (writes)
    ingest: "object | None"         # streams.ingest.IngestStats
    construction: "object | None"   # core.vnm.ConstructionStats


# ------------------------------------------------------------- engine groups
class _EngineGroup:
    """One (aggregate, window, continuous) equivalence class of queries: a
    decision vector, an engine and its churn journal, shared by every query
    registered with the compatible spec."""

    def __init__(self, session: "EagrSession", key: tuple,
                 agg: Aggregate, spec: WindowSpec, continuous: bool):
        self.session = session
        self.key = key
        self.agg = agg
        self.spec = spec
        self.continuous = continuous
        self.handles: list[int] = []
        self.window_int = int(max(1, spec.capacity or spec.size))
        self.cost = session._cost_model(agg, self.window_int)
        # the group's own churn journal, forked from the master; its
        # unpruned export is the id space the patch path works in
        self.dyn = session._master.fork()
        basis = self.dyn.to_overlay(prune=False)
        if continuous:
            decisions = np.full(basis.n_nodes, D.PUSH, np.int64)
        else:
            wf, rf = session._frequencies(basis)
            decisions, _ = D.decide_mincut(basis, wf, rf, self.cost,
                                           window=self.window_int)
        self.engine = EagrEngine(basis, decisions, agg, spec,
                                 device=session.device,
                                 headroom=session.headroom)
        # churn-added nodes of a continuous group stay push-maintained
        self.engine.pin_push = bool(continuous)

    # ------------------------------------------------------------- mutations
    def journal_nodes(self) -> int:
        """Overlay nodes the next flush() will drain."""
        return self.dyn.pending_nodes

    def flush(self, growth: float):
        delta = self.dyn.drain_delta()
        if delta.empty:
            return None
        return self.engine.apply_delta(delta, growth=growth)

    # ------------------------------------------------------------ adaptation
    def adapt(self) -> int:
        """§4.8 frontier re-decision against observed frequencies;
        recompiles and re-adopts only when a flip happened. Continuous
        groups are pinned all-push and never adapt."""
        if self.continuous:
            return 0
        if self.engine.alerts:
            # standing alerts predicate on push-maintained reader PAOs; a
            # pull flip would silence them — alerted groups never adapt
            return 0
        plan = self.engine.plan
        ov = plan.host.export_overlay() if plan.host is not None \
            else self.engine.overlay
        obs_w, obs_r = self.session._observed(ov)
        dec, flips = D.adapt_decisions(ov, plan.decision, obs_w, obs_r,
                                       self.cost, window=self.window_int)
        if flips:
            self.engine.adopt_decisions(dec)
        return flips


# ----------------------------------------------------------------------- API
class EagrSession:
    """Session over one data graph: overlay construction, cost-model
    calibration and push/pull decisions happen inside; queries, writes and
    reads are the public surface.

    Parameters
    ----------
    graph : CSRGraph | Bipartite
        The data graph (1-hop in-neighborhood queries by default; ``hops``/
        ``pred``/``neighborhood`` forward to :func:`build_bipartite`), or a
        pre-built bipartite writer/reader spec.
    device : str | torch.device | None
        Where plans and state live; ``None`` means CUDA and raises when no
        CUDA device is present. Pass ``"cpu"`` to run on the CPU.
    headroom : float
        Slot/node/level padding growth at first compile, so structural churn
        patches in place (§3.3) instead of recompiling.
    growth : float
        Padding growth of a recompile after a capacity overflow.
    write_freq, read_freq : np.ndarray | None
        Per-base-id frequencies for ``decide_mincut``. Default: observed
        session traffic when any exists, else uniform.
    calibrate : bool
        Learn the cost model by timing the aggregate on ``device`` (§4.2)
        instead of the analytic model.
    adapt_every : int
        Re-run §4.8 frontier adaptation every N ``update``/``read`` calls
        (0 disables).
    ingest_depth : int | None
        ``0`` keeps the synchronous write path (one dispatch and one tick
        per ``update``); ``N >= 1`` routes ``update`` through an
        :class:`~repro_torch.streams.ingest.IngestPipeline` ring of N slots.
        Defaults to ``EAGR_INGEST_DEPTH`` (0).
    ingest_batch : int | None
        Events per device batch of the ring (its coalescing factor and clock
        tick). Defaults to ``EAGR_INGEST_BATCH``, else 8192.
    shards, ckpt_dir, ckpt_every, ckpt_keep :
        Not ported yet; anything but the default raises
        ``NotImplementedError``.
    """

    def __init__(self, graph, *, device=None, headroom: float = 2.0,
                 growth: float = 2.0, variant: str = "vnm_a", max_iterations: int = 3,
                 seed: int = 0, threshold: int = 4, split_limit: int = 5,
                 hops: int = 1, pred=None, neighborhood=None,
                 write_freq=None, read_freq=None, calibrate: bool = False,
                 shards: int | None = None, adapt_every: int = 0,
                 ingest_depth: int | None = None,
                 ingest_batch: int | None = None,
                 ckpt_dir: str | None = None,
                 ckpt_every: int | None = None,
                 ckpt_keep: int | None = None):
        if shards:
            raise not_ported("sharded sessions (shards=N)", "10")
        if ckpt_dir is not None or ckpt_every or ckpt_keep is not None:
            raise not_ported("checkpoints (ckpt_dir, ckpt_every, ckpt_keep)",
                             "9")
        self.device = resolve_device(device)
        bp = graph if isinstance(graph, Bipartite) else build_bipartite(
            graph, hops=hops, pred=pred, neighborhood=neighborhood)
        self.bipartite = bp
        self.n_base = bp.n_base
        self.headroom = headroom
        self.growth = growth
        self.adapt_every = int(adapt_every)
        self.calibrate = calibrate
        self.write_freq = None if write_freq is None \
            else np.asarray(write_freq, np.float64)
        self.read_freq = None if read_freq is None \
            else np.asarray(read_freq, np.float64)
        overlay, self.overlay_stats = construct_vnm(
            bp, variant=variant, max_iterations=max_iterations, seed=seed)
        self._master = DynamicOverlay.from_overlay(
            overlay, bp.reader_input_sets(),
            threshold=int(threshold), split_limit=int(split_limit))
        self._groups: dict[tuple, _EngineGroup] = {}
        self._handles: dict[int, QueryHandle] = {}
        self._next_qid = 0
        self._value_dim: int | None = None
        self._wcount = np.zeros(self.n_base, np.float64)
        self._rcount = np.zeros(self.n_base, np.float64)
        self._ops_since_adapt = 0
        self._pending = False
        self._seq = 0
        self._alerts: dict[int, AlertHandle] = {}
        self._next_aid = 0
        # streaming ingest: depth 0 keeps the synchronous write path; depth
        # >= 1 routes `update` through the ring (streams/ingest.py)
        if ingest_depth is None:
            ingest_depth = int(os.environ.get("EAGR_INGEST_DEPTH", "0") or 0)
        if ingest_batch is None:
            ingest_batch = int(os.environ.get("EAGR_INGEST_BATCH", "0") or 0)
        self.ingest_depth = max(0, int(ingest_depth))
        self.ingest_batch = int(ingest_batch) or 8192
        self._pipeline = None
        self._carry_ingest = None  # IngestStats across pipeline rebuilds

    # ------------------------------------------------------------- lifecycle
    def register(self, query: Query) -> QueryHandle:
        """Validate and register one query. Compatible specs share an engine
        group (and with it plan, windows and partial aggregates); the first
        query of a new spec compiles the group's plan. A query registered
        after traffic starts with empty windows."""
        if not isinstance(query, Query):
            raise ValueError(f"register() takes a Query, "
                             f"got {type(query).__name__}")
        agg, spec = query.resolve()
        if self._value_dim is None:
            self._value_dim = spec.value_dim
        elif spec.value_dim != self._value_dim:
            raise ValueError(
                f"session write stream carries value_dim={self._value_dim} "
                f"but this query's window wants value_dim={spec.value_dim}; "
                f"one session serves one write-value shape")
        key = (agg, spec, bool(query.continuous))
        group = self._groups.get(key)
        if group is None:
            self._retire_pipeline()  # the engine set is about to change
            group = _EngineGroup(self, key, agg, spec, bool(query.continuous))
            self._groups[key] = group
        handle = QueryHandle(qid=self._next_qid, query=query, agg=agg,
                             spec=spec, session=self, group=group)
        self._next_qid += 1
        group.handles.append(handle.qid)
        self._handles[handle.qid] = handle
        return handle

    def unregister(self, handle: QueryHandle) -> None:
        """Retire one query; the last query of a group releases its engine."""
        self._check_handle(handle)
        for ah in [a for a in self._alerts.values() if a.query is handle]:
            self.unregister_alert(ah)
        del self._handles[handle.qid]
        handle.group.handles.remove(handle.qid)
        if not handle.group.handles:
            self._retire_pipeline()  # the engine set is about to change
            del self._groups[handle.group.key]
        if not self._groups:
            self._value_dim = None  # nothing constrains the stream anymore

    # ---------------------------------------------------------- standing alerts
    def register_alert(self, handle: QueryHandle, spec=None, *,
                       readers=None, **predicates) -> AlertHandle:
        """Register a standing alert against a registered query: the
        predicate (``AlertSpec``, or keyword thresholds ``above``/``below``/
        ``delta`` + ``hysteresis``/``debounce``/``component``) is evaluated
        **on the device after the query's write step** from then on, and
        only the readers that fired come back per batch
        (:meth:`drain_fired`).

        ``readers`` scopes the alert (defaults to the query's own scope;
        ``None`` on an unscoped query tracks every reader through churn).
        Requires push-maintained readers — register the query with
        ``continuous=True``. Thresholds may be per-reader arrays, matched
        positionally against the sorted reader list."""
        from repro_torch.streams.alerts import (
            AlertSet,
            AlertSpec,
            check_alert_aggregate,
        )

        self._check_handle(handle)
        if spec is None:
            spec = AlertSpec(**predicates)
        elif predicates:
            raise ValueError("pass an AlertSpec OR keyword thresholds, "
                             "not both")
        md = check_alert_aggregate(handle.agg)
        if not (0 <= int(spec.component) < md):
            raise ValueError(f"component={spec.component} out of range for "
                             f"{handle.agg.name!r} (measure dim {md})")
        # alerts resolve against the live plan — land pending churn first
        # and quiesce the ingest ring so the attach sees settled state
        if self._pending:
            self.flush()
        elif self._pipeline is not None:
            self._pipeline.flush()
        scope = handle.readers
        if readers is None:
            readers = scope  # None + unscoped query = dynamic (all readers)
        elif scope is not None:
            outside = [int(r) for r in readers if int(r) not in scope]
            if outside:
                raise ValueError(f"alert readers {sorted(outside)[:8]} are "
                                 "outside the query's readers scope")
        engine = handle.group.engine
        alerts = engine.alerts
        if alerts is None:
            alerts = AlertSet()
        aid = self._next_aid
        alerts.register(aid, spec, () if readers is None else readers,
                        dynamic=readers is None,
                        engine=engine if engine.alerts is alerts else None)
        if engine.alerts is not alerts:
            engine.attach_alerts(alerts)
        self._next_aid += 1
        ahandle = AlertHandle(aid=aid, spec=spec, query=handle, session=self)
        self._alerts[aid] = ahandle
        return ahandle

    def unregister_alert(self, ahandle: AlertHandle) -> None:
        """Retire one standing alert; the last alert of an engine detaches
        alert evaluation from its write path entirely."""
        if self._alerts.get(getattr(ahandle, "aid", -1)) is not ahandle:
            raise ValueError("unknown alert handle")
        del self._alerts[ahandle.aid]
        engine = ahandle.query.group.engine
        alerts = engine.alerts
        if alerts is None:
            return
        if self._pipeline is not None:
            self._pipeline.flush()  # quiesce in-flight evaluated steps
        alerts.collect()
        alerts.unregister(ahandle.aid, engine)
        if not alerts:
            engine.alerts = None

    @property
    def alerts(self) -> list[AlertHandle]:
        return list(self._alerts.values())

    def drain_fired(self, ahandle: AlertHandle | None = None) -> list:
        """Collect every fired batch produced since the last drain — the
        compact readback of all standing alerts (optionally filtered to one
        :class:`AlertHandle`). With a pipelined session the ring has already
        collected completed slots at its boundaries; this adds a partial-slot
        dispatch so every submitted event is observed."""
        if self._pipeline is not None:
            self._pipeline.drain()
        out = []
        for g in self._groups.values():
            alerts = g.engine.alerts
            if alerts is None:
                continue
            alerts.collect()
            out.extend(alerts.pop_fired())
        out.sort(key=lambda b: b.now)
        if ahandle is not None:
            keep = []
            for b in out:
                sel = b.aids == ahandle.aid
                if sel.any():
                    keep.append(dataclasses.replace(
                        b, base_ids=b.base_ids[sel], values=b.values[sel],
                        aids=b.aids[sel]))
            return keep
        return out

    @property
    def queries(self) -> list[QueryHandle]:
        return list(self._handles.values())

    @property
    def n_engine_groups(self) -> int:
        return len(self._groups)

    @property
    def readers(self) -> list[int]:
        """Base ids currently readable (non-empty ego neighborhoods)."""
        return sorted(r for r, ws in self._master.reader_inputs.items() if ws)

    @property
    def writers(self) -> list[int]:
        """Base ids with a registered write stream."""
        return sorted(self._master.b.writer_node)

    def neighborhood(self, reader: int) -> set[int]:
        """The reader's writer set N(reader)."""
        return set(self._master.reader_inputs.get(int(reader), set()))

    # -------------------------------------------------------------- execution
    def update(self, src_ids, values=None) -> None:
        """Apply one batch of writes (base writer ids + raw values) to every
        registered query — the session's single shared write stream. Values
        default to ones (pure count/presence streams). Writes to ids no query
        consumes are dropped, exactly as the engines drop them."""
        if not self._groups:
            raise ValueError("no queries registered — register() one before "
                             "streaming updates")
        if self._pending:
            self.flush()
        ids = np.asarray(src_ids, np.int64).reshape(-1)
        if len(ids) and ids.min() < 0:
            raise ValueError("negative base ids in update batch")
        if values is None:
            values = np.ones(len(ids), np.float32)
        vals = np.asarray(values, np.float32)
        want = (len(ids),) if self._value_dim == 1 \
            else (len(ids), self._value_dim)
        if vals.shape != want:
            raise ValueError(f"update values shape {vals.shape} != {want} "
                             f"(session value_dim={self._value_dim})")
        if self.ingest_depth:
            self._ingest().submit(ids, vals)
        else:
            B = bucket_batch(len(ids))
            for group in self._groups.values():
                group.engine.write_batch(ids, vals, batch_size=B)
        if len(ids):
            self._grow_counts(int(ids.max()))
            np.add.at(self._wcount, ids, 1.0)
        self._tick()
        self._seq += 1

    def read(self, handle: QueryHandle, ids) -> np.ndarray:
        """Answer one batch of ego-centric reads for a registered query.
        Raises for ids outside the query's ``readers`` scope or unknown to
        the overlay."""
        self._check_handle(handle)
        if self._pending:
            self.flush()
        if self._pipeline is not None:
            # reads must observe every submitted event: dispatch the partial
            # slot (no barrier — the read is queued after every write step)
            self._pipeline.drain()
        ids = np.asarray(ids, np.int64).reshape(-1)
        if handle.readers is not None:
            arr = handle._reader_arr
            if arr is None:
                arr = np.fromiter(handle.readers, np.int64,
                                  len(handle.readers))
                arr.sort()
                object.__setattr__(handle, "_reader_arr", arr)
            inside = np.isin(ids, arr)
            if not inside.all():
                raise ValueError(
                    f"read: base ids "
                    f"{sorted(set(map(int, ids[~inside])))[:8]} are outside "
                    f"this query's readers scope")
        out = handle.group.engine.read_batch(ids,
                                             batch_size=bucket_batch(len(ids)))
        if len(ids):
            self._grow_counts(int(ids.max()))
            np.add.at(self._rcount, ids, 1.0)
        self._tick()
        return out

    # --------------------------------------------------------------- mutations
    def add_edge(self, u: int, v: int, *, affected=None) -> None:
        """Data-graph edge u -> v appeared (reader v's neighborhood gains
        writer u for 1-hop queries; pass ``affected={reader: {writers}}`` for
        custom neighborhoods). Journaled; lands on the plans at flush()."""
        self._touch(u, v)
        self._master.add_edge(u, v, affected=affected)
        for group in self._groups.values():
            group.dyn.add_edge(u, v, affected=affected)

    def delete_edge(self, u: int, v: int, *, affected=None) -> None:
        self._touch(u, v)
        self._master.delete_edge(u, v, affected=affected)
        for group in self._groups.values():
            group.dyn.delete_edge(u, v, affected=affected)

    def add_node(self, u: int, in_neighbors: Iterable[int] = (),
                 out_readers: Iterable[int] = ()) -> None:
        """New base node u: a writer feeding ``out_readers`` and a reader
        over ``in_neighbors``."""
        ins, outs = set(map(int, in_neighbors)), set(map(int, out_readers))
        self._touch(u, *ins, *outs)
        self._master.add_node(u, ins, outs)
        for group in self._groups.values():
            group.dyn.add_node(u, ins, outs)

    def delete_node(self, u: int) -> None:
        self._touch(u)
        self._master.delete_node(u)
        for group in self._groups.values():
            group.dyn.delete_node(u)

    def flush(self) -> FlushReport:
        """Drain every group's mutation journal into its live plan through
        the §3.3 patch path (in-place table edits; recompile only on a
        genuine capacity overflow). Called by the next ``update``/``read``
        after a mutation; explicit calls let callers batch churn bursts.
        Returns a :class:`FlushReport`."""
        if self._pipeline is not None:
            # pipeline barrier BEFORE patches land: writes submitted so far
            # hit the plans they were routed against
            self._pipeline.flush()
        self._master.drain_delta()  # the master only snapshots for register
        journal = sum(g.journal_nodes() for g in self._groups.values())
        results = [group.flush(self.growth)
                   for group in self._groups.values()]
        self._pending = False
        counts = {"patched": 0, "recompiled": 0, "relayout": 0}
        for res in results:
            if res is not None and res.kind in counts:
                counts[res.kind] += 1
        return FlushReport(results, journal_nodes=journal, **counts)

    def adapt(self) -> AdaptReport:
        """Re-run the §4.8 frontier adaptation on every group against
        observed frequencies now (also triggered every ``adapt_every``
        operations). Returns an :class:`AdaptReport`."""
        if self._pipeline is not None:
            self._pipeline.flush()  # plans may swap underneath the ring
        if self._pending:
            self.flush()
        return AdaptReport([group.adapt()
                            for group in self._groups.values()])

    def stats(self) -> SessionStats:
        from repro_torch.core.frontier import frontier_summary

        logs: list[int] = []
        for g in self._groups.values():
            logs.extend(g.engine.frontier_log)
        return SessionStats(
            n_queries=len(self._handles),
            n_engine_groups=len(self._groups),
            n_shards=0,
            updates=self._seq,
            pending_mutations=self._pending,
            journal_nodes=sum(g.journal_nodes()
                              for g in self._groups.values()),
            patches_applied=sum(g.engine.plan.patches_applied
                                for g in self._groups.values()),
            frontier=frontier_summary(logs),
            ingest=self._pipeline.stats if self._pipeline is not None
            else self._carry_ingest,
            construction=self.overlay_stats,
        )

    # ------------------------------------------------ outside this slice
    def save(self, directory: str | None = None, **_) -> int:
        raise not_ported("checkpoints (save)", "9")

    def wait_for_checkpoint(self) -> None:
        raise not_ported("checkpoints (wait_for_checkpoint)", "9")

    @classmethod
    def restore(cls, directory: str, **_) -> "EagrSession":
        raise not_ported("checkpoints (restore)", "9")

    # ---------------------------------------------------------------- internal
    def _check_handle(self, handle) -> None:
        if not isinstance(handle, QueryHandle) \
                or self._handles.get(getattr(handle, "qid", -1)) is not handle:
            raise ValueError("unknown query handle (not registered with this "
                             "session, or already unregistered)")

    def _ingest(self):
        if self._pipeline is None:
            from repro_torch.streams.ingest import IngestPipeline
            self._pipeline = IngestPipeline(
                [g.engine for g in self._groups.values()],
                depth=self.ingest_depth, device_batch=self.ingest_batch,
                value_dim=self._value_dim or 1, stats=self._carry_ingest)
            # lifetime counters survive pipeline retirement
            self._carry_ingest = self._pipeline.stats
        return self._pipeline

    def _retire_pipeline(self) -> None:
        """Barrier and drop the pipeline: the next pipelined update
        rebuilds it over the current engine set."""
        if self._pipeline is not None:
            self._pipeline.flush()
            self._pipeline = None

    def _tick(self) -> None:
        self._ops_since_adapt += 1
        if self.adapt_every and self._ops_since_adapt >= self.adapt_every:
            self._ops_since_adapt = 0
            self.adapt()

    def _touch(self, *ids) -> None:
        self._pending = True
        top = max((int(i) for i in ids), default=-1)
        if top >= 0:
            self._grow_counts(top)

    def _grow_counts(self, top: int) -> None:
        if top < len(self._wcount):
            return
        size = 1 << max(1, int(top)).bit_length()
        grow = lambda a: np.concatenate([a, np.zeros(size - len(a))])
        self._wcount, self._rcount = grow(self._wcount), grow(self._rcount)

    def _need(self, overlay) -> int:
        top = max((o for o in overlay.origin if o >= 0), default=0)
        return max(self.n_base, top + 1, len(self._wcount))

    def _observed(self, overlay) -> tuple[np.ndarray, np.ndarray]:
        """Raw observed per-base-id frequencies, sized to cover the overlay's
        origin space (zeros for never-seen ids)."""
        need = self._need(overlay)
        pad = lambda a: np.concatenate([a, np.zeros(need - len(a))]) \
            if need > len(a) else a[:need]
        return pad(self._wcount), pad(self._rcount)

    def _frequencies(self, overlay) -> tuple[np.ndarray, np.ndarray]:
        """Decision-time frequencies: explicit constructor arrays win, then
        observed traffic (+1 smoothing so unseen nodes keep a floor), then
        uniform."""
        need = self._need(overlay)

        def resolve(explicit, observed):
            out = np.ones(need, np.float64)
            if explicit is not None:
                out[: min(need, len(explicit))] = explicit[:need]
            elif observed.sum() > 0:
                out += observed[:need] if len(observed) >= need else \
                    np.concatenate([observed,
                                    np.zeros(need - len(observed))])
            return out

        return (resolve(self.write_freq, self._wcount),
                resolve(self.read_freq, self._rcount))

    def _cost_model(self, agg: Aggregate, window: int) -> D.CostModel:
        if self.calibrate:
            return D.calibrate_cost_model(agg, pao_dim=agg.pao_dim,
                                          device=self.device)
        try:
            return D.cost_model_for(agg.name, window=window)
        except ValueError:
            # custom aggregate: assume O(1) incremental update, O(k) merge
            return D.CostModel(H=lambda k: 1.0,
                               L=lambda k: float(max(1, k)), name=agg.name)
