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

Deployment shape is a constructor argument, not a different API:
``EagrSession(graph)`` runs each group on an :class:`EagrEngine`;
``EagrSession(graph, shards=N)`` stands up ``partition_overlay ->
align_shard_plans -> StackedShardedEngine`` (paper §7's reader-partitioned
shards, stacked on one card) behind the same methods, with churn journaled
per shard (``ShardedDynamic``). Inside an initialised ``torch.distributed``
group of exactly N ranks the same call holds one shard per rank
(``launch.mesh.make_shard_mesh``): every rank makes the same calls with the
same global batches (the ingest ring, alerts, churn, ``adapt``, ``save`` and
the recovery driver included), and ``read`` returns the global answers on
every rank.

Sessions are durable: ``save`` checkpoints every group's plans, windows,
PAOs and clocks (two-phase commit, written by a background thread),
``EagrSession.restore`` brings a session back without construction or
compilation, or reshards it (``shards=M``), and ``ckpt_dir``/``ckpt_every``
checkpoint automatically; ``distributed.fault.SessionRecoveryDriver``
replays a stream after a crash. The on-disk format is the JAX package's.

The session runs on CUDA unless the caller passes ``device="cpu"``; without
a card and without that argument it raises.
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
from repro_torch.core.engine import EagrEngine, bucket_batch
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
    n_shards: int                   # shards per group (0: one engine)
    updates: int                    # update() batches applied (= checkpoint
                                    # sequence number: replay resumes here)
    pending_mutations: bool
    journal_nodes: int              # overlay nodes awaiting the next flush
    patches_applied: int            # in-place patches, all plans
    frontier: dict                  # frontier-size distribution (writes)
    ingest: "object | None"         # streams.ingest.IngestStats
    construction: "object | None"   # core.vnm.ConstructionStats
    last_checkpoint_step: "int | None"


# ------------------------------------------------------------- engine groups
class _EngineGroup:
    """One (aggregate, window, continuous) equivalence class of queries: a
    decision vector, an engine (single or stacked-sharded) and its churn
    journal, shared by every query registered with the compatible spec."""

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
        # single-engine groups journal churn in their own fork of the
        # master (its unpruned export is the id space the patch path works
        # in); sharded groups journal per shard inside ShardedDynamic
        basis_dyn = None if session.n_shards else session._master.fork()
        basis = (basis_dyn or session._master).to_overlay(prune=False)
        if continuous:
            decisions = np.full(basis.n_nodes, D.PUSH, np.int64)
        else:
            wf, rf = session._frequencies(basis)
            decisions, _ = D.decide_mincut(basis, wf, rf, self.cost,
                                           window=self.window_int)
        if session.n_shards:
            from repro_torch.distributed.eagr_shard import (
                ShardedDynamic,
                partition_overlay,
            )
            from repro_torch.distributed.stacked import StackedShardedEngine

            self.dyn = None
            # creation-time global decisions over the basis id space: the
            # repartition key a checkpoint needs to reshard N -> M
            self.dec_global = decisions
            # on a group every rank partitions alike on the host; the
            # engine uploads the rank's own shard only
            mesh = session.mesh
            self.sharded = partition_overlay(
                basis, decisions, n_shards=session.n_shards,
                seed=session.seed,
                device="cpu" if mesh is not None else session.device,
                headroom=session.headroom)
            self.engine = StackedShardedEngine(
                self.sharded, agg, spec, mesh=mesh, device=session.device,
                base_capacity=session.n_base)
            self.sdyn = ShardedDynamic(self.sharded, self.engine,
                                       growth=session.growth)
        else:
            self.dyn = basis_dyn
            self.sdyn = None
            self.engine = EagrEngine(basis, decisions, agg, spec,
                                     device=session.device,
                                     headroom=session.headroom)
        # churn-added nodes of a continuous group stay push-maintained
        self.engine.pin_push = bool(continuous)

    @property
    def _journal(self):
        return self.sdyn if self.sdyn is not None else self.dyn

    def ensure_journal(self) -> None:
        """Materialize the churn journal of a restored group. Restored
        groups come up journal-less (rebuilding every group's
        DynamicOverlay at restore would cost more than the restore itself);
        the session calls this before the first post-restore mutation, so
        the journal forks the master in its pre-mutation state."""
        if self.dyn is not None or self.sdyn is not None:
            return
        if self.session.n_shards:
            from repro_torch.distributed.eagr_shard import ShardedDynamic

            # the saved per-shard overlays are unpruned exports: deleted
            # writer nodes linger with their 'W' label and must not be
            # re-registered as live by the rebuilt journals
            self.sdyn = ShardedDynamic(
                self.sharded, self.engine, growth=self.session.growth,
                live_writers=[set(p.writer_row_of_base)
                              for p in self.sharded.shard_plans])
        else:
            self.dyn = self.session._master.fork()

    # ------------------------------------------------------------- mutations
    def journal_nodes(self) -> int:
        """Overlay nodes the next flush() will drain across this group."""
        if self.sdyn is not None:
            return sum(d.pending_nodes for _, d in self.sdyn.dynamics.built())
        return self.dyn.pending_nodes if self.dyn is not None else 0

    def flush(self, growth: float):
        if self.sdyn is not None:
            return self.sdyn.apply()
        if self.dyn is None:
            return None  # restored group, no churn since restore
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
        if self.sdyn is None and not self.session.n_shards:
            plan = self.engine.plan
            ov = plan.host.export_overlay() if plan.host is not None \
                else self.engine.overlay
            obs_w, obs_r = self.session._observed(ov)
            dec, flips = D.adapt_decisions(ov, plan.decision, obs_w, obs_r,
                                           self.cost, window=self.window_int)
            if flips:
                self.engine.adopt_decisions(dec)
            return flips
        self.ensure_journal()
        decs: list[np.ndarray | None] = []
        total = 0
        for s, plan in enumerate(self.sharded.shard_plans):
            ov = plan.host.export_overlay() if plan.host is not None \
                else self.sharded.shards[s]
            obs_w, obs_r = self.session._observed(ov)
            dec, flips = D.adapt_decisions(ov, plan.decision, obs_w, obs_r,
                                           self.cost, window=self.window_int)
            decs.append(dec if flips else None)
            total += flips
        if total:
            self.sdyn.readopt_decisions(decs)
        return total


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
    shards : int | None
        ``None`` runs each engine group on one :class:`EagrEngine`; ``N``
        reader-partitions the overlay into N shards stacked on the device
        (:class:`~repro_torch.distributed.stacked.StackedShardedEngine`),
        or, inside a ``torch.distributed`` group of N ranks, one shard per
        rank: rank r on ``device``, else ``cuda:{r % device_count}``. On a
        group each rank runs its own ingest ring over the same global
        stream; every rank must make the same calls in the same order.
    ckpt_dir, ckpt_every, ckpt_keep :
        Auto-checkpointing: every ``ckpt_every`` updates the session saves
        to ``ckpt_dir`` in the background, keeping the newest ``ckpt_keep``
        checkpoints. Default to ``EAGR_CKPT_DIR`` / ``EAGR_CKPT_EVERY`` (0:
        off) / ``EAGR_CKPT_KEEP`` (3).
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
        from repro_torch.launch.mesh import make_shard_mesh

        self.n_shards = int(shards) if shards else 0
        if shards is not None and self.n_shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        self.mesh = make_shard_mesh(self.n_shards, device=device) \
            if self.n_shards else None
        self.device = self.mesh.device if self.mesh is not None \
            else resolve_device(device)
        bp = graph if isinstance(graph, Bipartite) else build_bipartite(
            graph, hops=hops, pred=pred, neighborhood=neighborhood)
        self.bipartite = bp
        self.n_base = bp.n_base
        self.headroom = headroom
        self.growth = growth
        self.seed = seed
        self.threshold = int(threshold)
        self.split_limit = int(split_limit)
        self.adapt_every = int(adapt_every)
        self.calibrate = calibrate
        self.write_freq = None if write_freq is None \
            else np.asarray(write_freq, np.float64)
        self.read_freq = None if read_freq is None \
            else np.asarray(read_freq, np.float64)
        overlay, self.overlay_stats = construct_vnm(
            bp, variant=variant, max_iterations=max_iterations, seed=seed)
        self._master_obj = DynamicOverlay.from_overlay(
            overlay, bp.reader_input_sets(),
            threshold=self.threshold, split_limit=self.split_limit)
        self._master_src = None  # restored sessions carry the payload instead
        self._master_dup = bool(overlay.dup_insensitive)
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
        # durable sessions: the update-batch sequence number doubles as the
        # checkpoint step — replay resumes the event stream from it
        if ckpt_dir is None:
            ckpt_dir = os.environ.get("EAGR_CKPT_DIR") or None
        if ckpt_every is None:
            ckpt_every = int(os.environ.get("EAGR_CKPT_EVERY", "0") or 0)
        if ckpt_keep is None:
            ckpt_keep = int(os.environ.get("EAGR_CKPT_KEEP", "3") or 3)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = max(0, int(ckpt_every))
        self.ckpt_keep = max(1, int(ckpt_keep))
        self._ckpt_mgrs: dict = {}
        self._last_ckpt_step: int | None = None

    @property
    def _master(self) -> DynamicOverlay:
        """The session-wide master overlay journal. Restored sessions carry
        the checkpoint payload instead and materialize the DynamicOverlay
        only when something needs it (a mutation, a late register, a
        neighborhood query): a same-layout restore followed by pure
        update/read traffic never pays the O(nodes) rebuild."""
        if self._master_obj is None:
            from repro_torch.distributed.checkpoint import master_from_arrays
            self._master_obj = master_from_arrays(
                self._master_src, threshold=self.threshold,
                split_limit=self.split_limit, dup=self._master_dup)
        return self._master_obj

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
        if self.ckpt_dir and self.ckpt_every \
                and self._seq % self.ckpt_every == 0:
            self.save(blocking=False)

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
        self._ensure_journals()
        self._master.add_edge(u, v, affected=affected)
        for group in self._groups.values():
            group._journal.add_edge(u, v, affected=affected)

    def delete_edge(self, u: int, v: int, *, affected=None) -> None:
        self._touch(u, v)
        self._ensure_journals()
        self._master.delete_edge(u, v, affected=affected)
        for group in self._groups.values():
            group._journal.delete_edge(u, v, affected=affected)

    def add_node(self, u: int, in_neighbors: Iterable[int] = (),
                 out_readers: Iterable[int] = ()) -> None:
        """New base node u: a writer feeding ``out_readers`` and a reader
        over ``in_neighbors``."""
        ins, outs = set(map(int, in_neighbors)), set(map(int, out_readers))
        self._touch(u, *ins, *outs)
        self._ensure_journals()
        self._master.add_node(u, ins, outs)
        for group in self._groups.values():
            group._journal.add_node(u, ins, outs)

    def delete_node(self, u: int) -> None:
        self._touch(u)
        self._ensure_journals()
        self._master.delete_node(u)
        for group in self._groups.values():
            group._journal.delete_node(u)

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
        if self._master_obj is not None:
            # the master only snapshots for register; a restored session
            # with an unmaterialized master has nothing to drain
            self._master_obj.drain_delta()
        journal = sum(g.journal_nodes() for g in self._groups.values())
        results = [group.flush(self.growth)
                   for group in self._groups.values()]
        self._pending = False
        counts = {"patched": 0, "recompiled": 0, "relayout": 0}

        def count(res):
            # sharded groups report one result per shard
            if isinstance(res, (list, tuple)):
                for r in res:
                    count(r)
            elif res is not None and res.kind in counts:
                counts[res.kind] += 1

        count(results)
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
        patches = 0
        for g in self._groups.values():
            logs.extend(getattr(g.engine, "frontier_log", []))
            if self.n_shards:
                patches += sum(p.patches_applied
                               for p in g.sharded.shard_plans)
            else:
                patches += g.engine.plan.patches_applied
        return SessionStats(
            n_queries=len(self._handles),
            n_engine_groups=len(self._groups),
            n_shards=self.n_shards,
            updates=self._seq,
            pending_mutations=self._pending,
            journal_nodes=sum(g.journal_nodes()
                              for g in self._groups.values()),
            patches_applied=patches,
            frontier=frontier_summary(logs),
            ingest=self._ingest_stats(),
            construction=self.overlay_stats,
            last_checkpoint_step=self._last_ckpt_step,
        )

    def _ingest_stats(self):
        if self._pipeline is not None:
            return self._pipeline.stats
        return self._carry_ingest

    # ------------------------------------------------------------ durability
    def save(self, directory: str | None = None, *, step: int | None = None,
             blocking: bool = False, keep: int | None = None) -> int:
        """Checkpoint the live session; returns the committed step number.

        Quiesces first — pending structural churn lands through
        :meth:`flush`, the ingest ring drains — then copies every group's
        plan, window and PAO state to host memory (pinned, behind one event
        wait) and hands the files to the checkpoint thread
        (``blocking=False``), so updates resume while they are written. The
        commit is atomic (two-phase manifest + rename): a crash mid-save
        leaves the previous committed checkpoint restorable. On a group of
        ranks every rank calls it: one gather of the shard states, then
        rank 0 writes the one-card stack's format (a blocking save, and
        :meth:`wait_for_checkpoint`, return on every rank after the
        commit).

        ``directory`` defaults to the session's ``ckpt_dir``; ``step``
        defaults to the update-batch sequence number, which is what
        :class:`repro_torch.distributed.fault.SessionRecoveryDriver`
        replays from."""
        directory = directory or self.ckpt_dir
        if directory is None:
            raise ValueError("no checkpoint directory — pass save(dir) or "
                             "construct with ckpt_dir=/EAGR_CKPT_DIR")
        if self._pending:
            self.flush()
        elif self._pipeline is not None:
            self._pipeline.flush()
        from repro_torch.distributed.checkpoint import snapshot_session
        arrays, objs = snapshot_session(self)
        step = self._seq if step is None else int(step)
        if self.mesh is None or self.mesh.rank == 0:
            self._ckpt_manager(directory, keep).save_payload(
                step, arrays, objs, blocking=blocking)
        if blocking and self.mesh is not None:
            self.mesh.barrier()
        self._last_ckpt_step = step
        return step

    def wait_for_checkpoint(self) -> None:
        """Block until every in-flight background save committed (on a
        group, on every rank)."""
        for mgr in self._ckpt_mgrs.values():
            mgr.wait()
        if self.mesh is not None:
            self.mesh.barrier()

    @classmethod
    def restore(cls, directory: str, *, step: int | None = None,
                graph=None, shards: int | None = None,
                device=None) -> "EagrSession":
        """Rebuild a session from a checkpoint directory (the latest
        committed step unless ``step=`` pins one), on ``device`` (CUDA
        unless the caller names another).

        ``shards=None`` restores the saved deployment shape bit for bit —
        compiled plans, window rings, PAOs and clocks adopt verbatim, with
        no construction, min-cut or compilation; inside a group of as many
        ranks as the checkpoint has shards, every rank adopts its own
        shard only. ``shards=M`` (``M >= 1``, or ``0`` for a single engine)
        reshards: plans recompile over the saved master overlay and window
        rings redistribute by base writer id; inside a group of M ranks
        every rank partitions alike on the host and builds its own shard's
        windows and PAOs only, bit-equal to the one-card ``shards=M``.
        Standing alerts and the ingest ring's settings carry over. A
        checkpoint the JAX package wrote restores here, and the reverse."""
        from repro_torch.distributed.checkpoint import restore_session
        return restore_session(directory, step=step, graph=graph,
                               shards=shards, device=device)

    def _ckpt_manager(self, directory: str, keep: int | None = None):
        from repro_torch.distributed.checkpoint import CheckpointManager
        mgr = self._ckpt_mgrs.get(directory)
        if mgr is None:
            mgr = CheckpointManager(
                directory, keep=self.ckpt_keep if keep is None else keep)
            self._ckpt_mgrs[directory] = mgr
        elif keep is not None:
            mgr.keep = keep
        return mgr

    # ---------------------------------------------------------------- internal
    def _check_handle(self, handle) -> None:
        if not isinstance(handle, QueryHandle) \
                or self._handles.get(getattr(handle, "qid", -1)) is not handle:
            raise ValueError("unknown query handle (not registered with this "
                             "session, or already unregistered)")

    def _ensure_journals(self) -> None:
        """Materialize restored groups' churn journals before a mutation
        touches the master, so each fork snapshots pre-mutation state."""
        for group in self._groups.values():
            group.ensure_journal()

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
