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

The session runs on CUDA unless the caller passes ``device="cpu"``; without
a card and without that argument it raises. Graph churn, adaptation,
streaming ingest, alerts, checkpoints and shards are later slices of the
port: their entry points raise ``NotImplementedError`` naming the
ROADMAP.md item.
"""
from __future__ import annotations

import dataclasses
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
           "SessionStats"]


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

    def on_threshold(self, **_):
        raise not_ported("standing alerts (on_threshold)", "8")


@dataclasses.dataclass
class SessionStats:
    """Counter snapshot of a session (:meth:`EagrSession.stats`)."""

    n_queries: int
    n_engine_groups: int
    n_shards: int                   # always 0: one engine per group
    updates: int                    # update() batches applied
    construction: "object | None"   # core.vnm.ConstructionStats


# ------------------------------------------------------------- engine groups
class _EngineGroup:
    """One (aggregate, window, continuous) equivalence class of queries: a
    decision vector and an engine, shared by every query registered with the
    compatible spec."""

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
        # the unpruned export of the master journal: the id space later
        # churn slices patch in place
        basis = session._master.to_overlay(prune=False)
        if continuous:
            decisions = np.full(basis.n_nodes, D.PUSH, np.int64)
        else:
            wf, rf = session._frequencies(basis)
            decisions, _ = D.decide_mincut(basis, wf, rf, self.cost,
                                           window=self.window_int)
        self.engine = EagrEngine(basis, decisions, agg, spec,
                                 device=session.device,
                                 headroom=session.headroom)


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
        Slot/node/level padding growth at first compile (the capacity later
        churn slices patch into).
    write_freq, read_freq : np.ndarray | None
        Per-base-id frequencies for ``decide_mincut``. Default: observed
        session traffic when any exists, else uniform.
    calibrate : bool
        Learn the cost model by timing the aggregate on ``device`` (§4.2)
        instead of the analytic model.
    shards, adapt_every, ingest_depth, ckpt_dir :
        Not ported yet; anything but the default raises
        ``NotImplementedError``.
    """

    def __init__(self, graph, *, device=None, headroom: float = 2.0,
                 variant: str = "vnm_a", max_iterations: int = 3,
                 seed: int = 0, threshold: int = 4, split_limit: int = 5,
                 hops: int = 1, pred=None, neighborhood=None,
                 write_freq=None, read_freq=None, calibrate: bool = False,
                 shards: int | None = None, adapt_every: int = 0,
                 ingest_depth: int | None = None,
                 ckpt_dir: str | None = None):
        if shards:
            raise not_ported("sharded sessions (shards=N)", "10")
        if adapt_every:
            raise not_ported("adaptive re-decision (adapt_every)", "6")
        if ingest_depth:
            raise not_ported("streaming ingest (ingest_depth)", "7")
        if ckpt_dir is not None:
            raise not_ported("checkpoints (ckpt_dir)", "9")
        self.device = resolve_device(device)
        bp = graph if isinstance(graph, Bipartite) else build_bipartite(
            graph, hops=hops, pred=pred, neighborhood=neighborhood)
        self.bipartite = bp
        self.n_base = bp.n_base
        self.headroom = headroom
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
        self._seq = 0

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
        del self._handles[handle.qid]
        handle.group.handles.remove(handle.qid)
        if not handle.group.handles:
            del self._groups[handle.group.key]
        if not self._groups:
            self._value_dim = None  # nothing constrains the stream anymore

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
        B = bucket_batch(len(ids))
        for group in self._groups.values():
            group.engine.write_batch(ids, vals, batch_size=B)
        if len(ids):
            self._grow_counts(int(ids.max()))
            np.add.at(self._wcount, ids, 1.0)
        self._seq += 1

    def read(self, handle: QueryHandle, ids) -> np.ndarray:
        """Answer one batch of ego-centric reads for a registered query.
        Raises for ids outside the query's ``readers`` scope or unknown to
        the overlay."""
        self._check_handle(handle)
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
        return out

    def stats(self) -> SessionStats:
        return SessionStats(
            n_queries=len(self._handles),
            n_engine_groups=len(self._groups),
            n_shards=0,
            updates=self._seq,
            construction=self.overlay_stats,
        )

    # ------------------------------------------------ outside this slice
    def add_edge(self, u: int, v: int, *, affected=None) -> None:
        raise not_ported("graph churn (add_edge)", "6")

    def delete_edge(self, u: int, v: int, *, affected=None) -> None:
        raise not_ported("graph churn (delete_edge)", "6")

    def add_node(self, u: int, in_neighbors=(), out_readers=()) -> None:
        raise not_ported("graph churn (add_node)", "6")

    def delete_node(self, u: int) -> None:
        raise not_ported("graph churn (delete_node)", "6")

    def flush(self):
        raise not_ported("graph churn (flush)", "6")

    def adapt(self):
        raise not_ported("adaptive re-decision (adapt)", "6")

    def register_alert(self, handle, spec=None, **_):
        raise not_ported("standing alerts (register_alert)", "8")

    def save(self, directory: str | None = None, **_) -> int:
        raise not_ported("checkpoints (save)", "9")

    @classmethod
    def restore(cls, directory: str, **_) -> "EagrSession":
        raise not_ported("checkpoints (restore)", "9")

    # ---------------------------------------------------------------- internal
    def _check_handle(self, handle) -> None:
        if not isinstance(handle, QueryHandle) \
                or self._handles.get(getattr(handle, "qid", -1)) is not handle:
            raise ValueError("unknown query handle (not registered with this "
                             "session, or already unregistered)")

    def _grow_counts(self, top: int) -> None:
        if top < len(self._wcount):
            return
        size = 1 << max(1, int(top)).bit_length()
        grow = lambda a: np.concatenate([a, np.zeros(size - len(a))])
        self._wcount, self._rcount = grow(self._wcount), grow(self._rcount)

    def _need(self, overlay) -> int:
        top = max((o for o in overlay.origin if o >= 0), default=0)
        return max(self.n_base, top + 1, len(self._wcount))

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
