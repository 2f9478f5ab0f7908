"""Standing alerts: device-evaluated predicate queries over reader PAOs.

EAGr's motivating workloads are continuous *alerting* queries — anomaly
detection, local threshold alerts — yet a poll-everything client must read
back O(readers) measures per batch just to notice the handful that moved.
This module turns the predicate around: alerts are registered once as dense
per-reader threshold columns plus an armed/fired state vector
(:class:`AlertState`, tensors on the engine's device), and evaluation runs
**right after every write step** on the device (:func:`alert_eval`, called
by ``EagrEngine.write_rows``): the finalized measure of every *alerted* row
is compared against its previous value — only rows the batch (or a
time-window expiry) actually changed can differ, so the predicate check is
exactly the reachable-reader restriction, expressed as one vectorized
compare instead of a gather. What crosses to the host per batch is a
compact fired set: a count plus a fixed-capacity padded index/value buffer,
copied into pinned host memory behind the step — never an O(readers) poll,
and no implicit sync.

Semantics (canonical — the poll oracle replicates them bit for bit):

* a row *fires* when its measure **changes** to a tripping value while the
  row is armed and its debounce interval has elapsed:
  ``trip = (m > above) | (m < below) | (|m - ref| > delta)``
* firing disarms the row; it re-arms when a later change lands back
  *inside* the band by the hysteresis margin
  (``below + hysteresis <= m <= above - hysteresis``), so a reader
  flapping across a threshold re-fires at most once per excursion;
* ``debounce`` (logical ticks = device batches) lower-bounds the spacing
  between fires of one row regardless of arming;
* ``ref`` — the delta-vs-previous baseline — re-bases to the fired value.

Unset thresholds default to the never-trip identities (``+inf`` / ``-inf``),
so a spec may use any subset of the three predicates.

A stacked shard engine (``distributed/stacked.py``) keeps (S, n_rows)
columns, one row of columns per shard: each reader is owned by exactly one
shard, so the per-shard compact fired buffers are disjoint
(:func:`alert_eval_stacked`), and the count that comes back carries the
batch's total first. :meth:`AlertSet.snapshot` / :meth:`AlertSet.
from_snapshot` are the checkpoint codec's view: per-base columns keyed by
base id, not row, so a restore places them on any shard layout.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.aggregates import Aggregate
from repro_torch.core.dataflow import PUSH
from repro_torch.core.engine import to_host

__all__ = ["AlertSet", "AlertSpec", "AlertState", "FiredBatch", "PollOracle",
           "alert_cap", "alert_eval", "alert_eval_enabled",
           "alert_eval_stacked", "check_alert_aggregate"]

# Aggregates whose finalize output is value-shaped (comparable against a
# threshold). topk finalizes to *indices* — order predicates on it are
# meaningless, so it is rejected at registration.
ALERT_COMPATIBLE = ("sum", "count", "avg", "max", "min")


def alert_cap(default: int = 1024) -> int:
    """Fired-set capacity K (``EAGR_ALERT_CAP``): the padded per-batch fired
    buffer holds up to K (index, value) pairs. A batch firing more than K
    alerts still reports the exact set — the collector falls back to reading
    the full fired vector for that batch (rare; size K for your worst batch
    to stay on the compact path)."""
    return int(os.environ.get("EAGR_ALERT_CAP", str(default)) or default)


def alert_eval_enabled() -> bool:
    """``EAGR_ALERT_EVAL=0`` detaches alert evaluation from the write path
    (registered state is kept; nothing fires) — the switch that measures
    the evaluation's marginal cost."""
    return os.environ.get("EAGR_ALERT_EVAL", "1").strip() != "0"


# --------------------------------------------------------------------- specs
@dataclasses.dataclass(frozen=True)
class AlertSpec:
    """One standing predicate, broadcast over the readers it is registered
    on. ``above`` / ``below`` / ``delta`` may each be a scalar or a
    per-reader array (matched positionally against the registration's reader
    list); unset predicates never trip. ``component`` selects the payload
    lane of vector-valued aggregates."""

    above: float | np.ndarray | None = None   # fire when measure > above
    below: float | np.ndarray | None = None   # fire when measure < below
    delta: float | np.ndarray | None = None   # fire when |m - ref| > delta
    hysteresis: float = 0.0                   # re-arm margin inside the band
    debounce: float = 0.0                     # min ticks between fires
    component: int = 0                        # payload lane for vector values

    def _field(self, name: str, n: int, fill: float) -> np.ndarray:
        v = getattr(self, name)
        if v is None:
            return np.full(n, fill, np.float32)
        arr = np.broadcast_to(np.asarray(v, np.float32), (n,))
        return np.ascontiguousarray(arr)

    def to_json(self) -> dict:
        out = {"hysteresis": float(self.hysteresis),
               "debounce": float(self.debounce),
               "component": int(self.component)}
        for f in ("above", "below", "delta"):
            v = getattr(self, f)
            if v is None:
                out[f] = None
            elif np.ndim(v) == 0:
                out[f] = float(v)
            else:
                out[f] = np.asarray(v, np.float32).tolist()
        return out

    @classmethod
    def from_json(cls, d: dict) -> "AlertSpec":
        kw = {}
        for f in ("above", "below", "delta"):
            v = d.get(f)
            kw[f] = None if v is None else (
                float(v) if np.ndim(v) == 0 else np.asarray(v, np.float32))
        return cls(hysteresis=float(d.get("hysteresis", 0.0)),
                   debounce=float(d.get("debounce", 0.0)),
                   component=int(d.get("component", 0)), **kw)

    def tables(self, n: int) -> dict[str, np.ndarray]:
        """Dense per-reader threshold columns for ``n`` registered readers."""
        return {
            "hi": self._field("above", n, np.inf),
            "lo": self._field("below", n, -np.inf),
            "dthr": self._field("delta", n, np.inf),
            "hys": np.full(n, float(self.hysteresis), np.float32),
            "deb": np.full(n, float(self.debounce), np.float32),
            "comp": np.full(n, int(self.component), np.int32),
        }


class AlertState(NamedTuple):
    """Device half of the alert set: dense columns over the overlay's node
    axis ((n_rows,) for one engine, (S, n_rows) for a stacked one), so
    evaluation indexes them with no gather. Rows without an alert are
    ``active=False`` and carry never-trip thresholds. Evaluation updates
    the dynamic columns in place."""

    active: torch.Tensor      # bool — row has a registered alert
    armed: torch.Tensor       # bool — eligible to fire
    hi: torch.Tensor          # f32 upper threshold (+inf = unset)
    lo: torch.Tensor          # f32 lower threshold (-inf = unset)
    dthr: torch.Tensor        # f32 delta-vs-ref threshold (+inf = unset)
    hys: torch.Tensor         # f32 hysteresis margin
    deb: torch.Tensor         # f32 debounce (logical ticks)
    comp: torch.Tensor        # i32 payload component
    last_fire: torch.Tensor   # f32 eval time of the last fire (-inf = never)
    ref: torch.Tensor         # f32 delta baseline (re-based on fire)
    last_m: torch.Tensor      # f32 measure at the last evaluation


DYNAMIC_FIELDS = ("armed", "last_fire", "ref", "last_m")


@dataclasses.dataclass(frozen=True)
class FiredBatch:
    """One device batch's fired set, in ascending base-id order."""

    now: float               # logical eval time of the triggering batch
    base_ids: np.ndarray     # (k,) int64 fired reader base ids
    values: np.ndarray       # (k,) f32 measures at fire time
    aids: np.ndarray         # (k,) int64 alert handle id per fired reader
    overflow: bool = False   # fired count exceeded the compact capacity
                             # (set is still exact — recovered densely)

    def __len__(self) -> int:
        return len(self.base_ids)


# ------------------------------------------------------------- device bodies
def _measure(agg: Aggregate, pao: torch.Tensor,
             comp: torch.Tensor) -> torch.Tensor:
    """(n_rows,) finalized measure per row, at each row's payload lane."""
    fin = agg.finalize(pao)
    if fin.dim() == 1:
        fin = fin[:, None]
    c = torch.clamp(comp, 0, fin.shape[1] - 1).to(torch.int64)
    return torch.gather(fin, 1, c[:, None])[:, 0]


def alert_eval(agg: Aggregate, astate: AlertState, pao: torch.Tensor,
               now: torch.Tensor, cap: int):
    """Evaluate every alerted row against the post-write PAO at eval time
    ``now`` (a device scalar), updating ``astate``'s dynamic columns in
    place. No step reads a device value on the host. Returns ``(count,
    idx, vals, fired, m)``: ``idx``/``vals`` the compact (cap,) fired
    buffer (-1 padded, ascending row order), ``fired``/``m`` fresh dense
    tensors of this step that the collector falls back to when the count
    exceeds ``cap``. One engine is a stack of one shard
    (:func:`alert_eval_stacked` on views of the columns)."""
    count, idx, vals, fired, m = alert_eval_stacked(
        agg, AlertState(*(c[None] for c in astate)), pao[None],
        now.reshape(1), cap)
    return count[0], idx[0], vals[0], fired[0], m[0]


def alert_eval_stacked(agg: Aggregate, astate: AlertState, pao: torch.Tensor,
                       now: torch.Tensor, cap: int):
    """Evaluate every alerted row of a stacked engine against its
    post-write PAO at eval time ``now``: ``astate`` columns (S, n_rows),
    ``pao`` (S, n_rows, d), ``now`` (S,); the dynamic columns update in
    place and no step reads a device value on the host. Only rows whose
    *measure* changed this batch are evaluated (untouched rows compare
    equal by construction). Each shard compacts its own fired rows into its
    own (cap,) buffer (disjoint: a reader lives on one shard) with no host
    sync (nonzero and mask indexing both sync): a fired row's position
    among its shard's fired rows, the first ``cap`` of them scattered in
    row order into a (cap + 1,) buffer whose last slot takes every other
    row and is cut off. Returns ``(count, idx, vals, fired, m)``, ``count``
    (S + 1,) the batch's total first, then each shard's."""
    S, n = astate.active.shape
    m = _measure(agg, pao.reshape(S * n, pao.shape[-1]),
                 astate.comp.reshape(-1)).view(S, n)
    now = now[:, None]
    changed = astate.active & (m != astate.last_m)
    trip = (m > astate.hi) | (m < astate.lo) | \
        (torch.abs(m - astate.ref) > astate.dthr)
    can_fire = (now - astate.last_fire) >= astate.deb
    fired = changed & astate.armed & trip & can_fire
    inside = (m <= astate.hi - astate.hys) & (m >= astate.lo + astate.hys)
    astate.armed.copy_(torch.where(fired, False,
                                   astate.armed | (changed & inside)))
    astate.last_fire.copy_(torch.where(fired, now, astate.last_fire))
    astate.ref.copy_(torch.where(fired, m, astate.ref))
    astate.last_m.copy_(torch.where(changed, m, astate.last_m))
    pos = torch.cumsum(fired, 1, dtype=torch.int32) - 1
    dst = torch.where(fired & (pos < cap), pos, cap).to(torch.int64)
    idx = torch.full((S, cap + 1), -1, dtype=torch.int32, device=m.device)
    idx.scatter_(1, dst, torch.arange(n, dtype=torch.int32, device=m.device)
                 .expand(S, n).contiguous())
    idx = idx[:, :cap].contiguous()
    per = fired.sum(dim=1, dtype=torch.int32)
    count = torch.cat([per.sum(dtype=torch.int32)[None], per])
    vals = torch.where(idx >= 0,
                       m.gather(1, torch.clamp(idx, min=0).to(torch.int64)),
                       0.0)
    return count, idx, vals, fired, m


# --------------------------------------------------------------- host manager
class AlertSet:
    """Host bookkeeping for the alerts attached to one engine (single or
    stacked): the registered specs as per-base SoA columns, the device
    :class:`AlertState`, row placement (base id -> (shard, overlay node)),
    the in-flight fired buffers awaiting readback, and the host-side queue
    of collected :class:`FiredBatch` es.

    Lifecycle: ``register``/``unregister`` edit the SoA and rebuild the
    device columns via :meth:`sync`; the engine calls ``sync`` again after
    every structural patch so churn carries alert rows (retired readers drop
    out, moved readers follow their node, query-wide alerts pick up new
    readers). ``push_pending`` (engine write path) and ``collect``
    (ring-boundary readback) move fired sets host-side without adding a sync
    point."""

    def __init__(self, cap: int | None = None):
        self.cap = int(cap) if cap else alert_cap()
        self.enabled = alert_eval_enabled()
        # ------------------------- per-base SoA (registration order)
        self._base = np.zeros(0, np.int64)
        self._aid = np.zeros(0, np.int64)
        self._static = {f: np.zeros(0, np.float32) for f in
                        ("hi", "lo", "dthr", "hys", "deb")}
        self._static["comp"] = np.zeros(0, np.int32)
        self._dyn = {"armed": np.zeros(0, bool),
                     "last_fire": np.zeros(0, np.float32),
                     "ref": np.zeros(0, np.float32),
                     "last_m": np.zeros(0, np.float32)}
        self._specs: dict[int, AlertSpec] = {}
        self._dynamic_aids: set[int] = set()  # readers=None registrations
        # ------------------------- placement (rebuilt by sync)
        self._shard = np.zeros(0, np.int32)   # owner shard per base (0 single)
        self._node = np.zeros(0, np.int32)    # overlay node per base
        self._placed = np.zeros(0, bool)      # base resolved to a live row
        self._row_base: np.ndarray | None = None  # (S, n_rows) node -> base
        self._row_aid: np.ndarray | None = None   # (S, n_rows) node -> aid
        self._stacked = False
        # a mesh engine's gather of every rank's shards (None elsewhere):
        # the device columns hold the rank's own shard only
        self._gather = None
        self.state: AlertState | None = None
        # ------------------------- fired-set plumbing
        self._pending: collections.deque = collections.deque()
        self.fired: collections.deque[FiredBatch] = collections.deque()
        self.dropped_bases = 0   # alerted readers retired by churn (cumulative)
        # monotone dispatch/readback sequence numbers: the ingest ring marks
        # each slot with `seq` at dispatch and collects up to that mark when
        # the slot's token proves those steps completed
        self.seq = 0        # evaluated steps dispatched (push_pending calls)
        self.seq_done = 0   # pending entries read back (collect pops)
        # detection latency: host seconds from each evaluated step's
        # dispatch to its fired set's readback (the newest 65,536 steps)
        self.detect_s: collections.deque[float] = collections.deque(
            maxlen=1 << 16)

    # ------------------------------------------------------------ properties
    @property
    def n_alerts(self) -> int:
        return len(self._base)

    @property
    def n_placed(self) -> int:
        return int(np.count_nonzero(self._placed))

    def __bool__(self) -> bool:
        return self.n_alerts > 0

    # ---------------------------------------------------------- registration
    def register(self, aid: int, spec: AlertSpec, bases, *, dynamic: bool,
                 engine=None) -> None:
        """Add one spec over ``bases`` (ascending base ids). ``dynamic``
        registrations (session ``readers=None``) re-resolve to the engine's
        full reader set on every sync, so churn-added readers inherit the
        spec. Overlapping a base already alerted by another registration is
        an error — each reader row holds one predicate."""
        bases = np.unique(np.asarray(bases, np.int64).reshape(-1))
        if len(bases) == 0 and not dynamic:
            raise ValueError("register_alert: empty reader set")
        clash = np.intersect1d(bases, self._base)
        if len(clash):
            raise ValueError(
                f"readers {clash[:8].tolist()} already carry an alert; "
                "unregister it first (one predicate per reader row)")
        tables = spec.tables(len(bases))
        self._base = np.concatenate([self._base, bases])
        self._aid = np.concatenate(
            [self._aid, np.full(len(bases), aid, np.int64)])
        for f, col in tables.items():
            self._static[f] = np.concatenate([self._static[f], col])
        self._dyn["armed"] = np.concatenate(
            [self._dyn["armed"], np.ones(len(bases), bool)])
        self._dyn["last_fire"] = np.concatenate(
            [self._dyn["last_fire"], np.full(len(bases), -np.inf, np.float32)])
        # ref / last_m seed from the current measure at sync (NaN sentinel)
        for f in ("ref", "last_m"):
            self._dyn[f] = np.concatenate(
                [self._dyn[f], np.full(len(bases), np.nan, np.float32)])
        self._specs[aid] = spec
        if dynamic:
            self._dynamic_aids.add(aid)
        if engine is not None:
            try:
                self.sync(engine)
            except Exception:
                # roll the rejected registration back (e.g. PULL-decided
                # readers) so the set stays consistent for its peers
                self._take(self._aid != aid)
                self._specs.pop(aid, None)
                self._dynamic_aids.discard(aid)
                raise

    def unregister(self, aid: int, engine=None) -> None:
        if aid not in self._specs:
            return
        self._pull_dynamic()
        keep = self._aid != aid
        self._take(keep)
        del self._specs[aid]
        self._dynamic_aids.discard(aid)
        if engine is not None:
            self.sync(engine)

    def _take(self, keep: np.ndarray) -> None:
        self._base = self._base[keep]
        self._aid = self._aid[keep]
        for d in (self._static, self._dyn):
            for f in d:
                d[f] = d[f][keep]
        self._shard = self._shard[: len(self._base)]
        self._node = self._node[: len(self._base)]
        self._placed = np.zeros(len(self._base), bool)  # sync re-resolves

    # ----------------------------------------------------------------- sync
    def _pull_dynamic(self) -> None:
        """Fold the device dynamic columns (armed/debounce/ref state) back
        into the per-base host mirrors at the current placement — the carry
        step before any re-layout (churn sync, unregister) or readout."""
        if self.state is None or not self._placed.any():
            return
        host = dict(zip(DYNAMIC_FIELDS, to_host(
            *(self._global(getattr(self.state, f)) for f in DYNAMIC_FIELDS))))
        # a registration appends bases after the placed ones; only the
        # placed prefix has device rows (the JAX package indexes the whole
        # column with the shorter mask and raises on a second registration)
        p = self._placed
        for f in DYNAMIC_FIELDS:
            col = host[f] if self._stacked else host[f][None]
            self._dyn[f][: len(p)][p] = col[self._shard[p], self._node[p]]

    def _global(self, t: torch.Tensor) -> torch.Tensor:
        """A device column (or PAO) over every shard: on a mesh the
        all-gather of the ranks' own (a collective every rank calls)."""
        return t if self._gather is None else self._gather(t)

    @staticmethod
    def _plans(engine) -> list:
        sp = getattr(engine, "shard_plans", None)
        return list(sp) if sp is not None else [engine.plan]

    def sync(self, engine, retired=()) -> None:
        """(Re)build placement and device columns against the engine's
        current plan. Called at registration and after every structural
        patch / plan adoption: alerted bases follow their reader node, bases
        whose reader retired are dropped (``retired`` from the patch result
        speeds the common case; a full re-resolve catches the rest), and
        dynamic registrations pick up readers that churn added."""
        self._pull_dynamic()
        plans = self._plans(engine)
        self._stacked = getattr(engine, "shard_plans", None) is not None
        self._gather = engine.gather_shards \
            if getattr(engine, "mesh", None) is not None else None
        S, n_rows = len(plans), plans[0].meta.n_nodes

        if retired is not None and len(retired):
            gone = np.isin(self._base, np.asarray(list(retired), np.int64))
            if gone.any():
                self.dropped_bases += int(np.count_nonzero(gone))
                self._take(~gone)
        # dynamic registrations: adopt any reader base not yet alerted
        for aid in sorted(self._dynamic_aids):
            have = set(self._base.tolist())
            fresh = sorted(b for p in plans for b in p.reader_node_of_base
                           if b not in have)
            if fresh:
                spec = self._specs[aid]
                del self._specs[aid]  # re-entrant register() guard
                self._dynamic_aids.discard(aid)
                try:
                    self.register(aid, spec, fresh, dynamic=True)
                finally:
                    self._specs[aid] = spec
                    self._dynamic_aids.add(aid)

        # ---------------------------------------------------- row placement
        M = len(self._base)
        shard = np.zeros(M, np.int32)
        node = np.full(M, -1, np.int32)
        for s, p in enumerate(plans):
            if not M:
                break
            rn, ok = p.routes.reader_nodes(self._base)
            place = ok & (node < 0)
            shard[place] = s
            node[place] = rn[place]
        placed = node >= 0
        lost = ~placed
        if lost.any():
            self.dropped_bases += int(np.count_nonzero(lost))
            self._take(placed)
            shard, node, placed = shard[placed], node[placed], placed[placed]
        # alerts predicate on PAO currency: only PUSH-decided readers are
        # always current after a write step
        for s, p in enumerate(plans):
            mine = placed & (shard == s)
            if mine.any() and (p.decision[node[mine]] != PUSH).any():
                bad = self._base[mine][p.decision[node[mine]] != PUSH]
                raise ValueError(
                    f"alerted readers {bad[:8].tolist()} are PULL-decided — "
                    "alerts need push-maintained readers (register the "
                    "query with continuous=True)")
        self._shard, self._node, self._placed = shard, node, placed

        # ------------------------------------------- node -> base/aid LUTs
        self._row_base = np.full((S, n_rows), -1, np.int64)
        self._row_aid = np.full((S, n_rows), -1, np.int64)
        self._row_base[shard, node] = self._base
        self._row_aid[shard, node] = self._aid

        # ------------------------------------------------ measure seeding
        nan = np.isnan(self._dyn["last_m"]) | np.isnan(self._dyn["ref"])
        if nan.any():
            m = self._measures_host(engine)
            for f in ("ref", "last_m"):
                col = self._dyn[f]
                col[np.isnan(col)] = m[np.isnan(col)]

        # ------------------------------------------------- device columns
        shape = (S, n_rows) if self._stacked else (n_rows,)
        cols = {
            "active": np.zeros(shape, bool),
            "armed": np.zeros(shape, bool),
            "hi": np.full(shape, np.inf, np.float32),
            "lo": np.full(shape, -np.inf, np.float32),
            "dthr": np.full(shape, np.inf, np.float32),
            "hys": np.zeros(shape, np.float32),
            "deb": np.zeros(shape, np.float32),
            "comp": np.zeros(shape, np.int32),
            "last_fire": np.full(shape, -np.inf, np.float32),
            "ref": np.zeros(shape, np.float32),
            "last_m": np.zeros(shape, np.float32),
        }
        at = (shard, node) if self._stacked else (node,)
        cols["active"][at] = True
        for f, col in self._static.items():
            cols[f][at] = col
        for f, col in self._dyn.items():
            cols[f][at] = col
        if self._gather is not None:
            # a mesh rank evaluates its own shard's readers only
            cols = {f: c[engine.local] for f, c in cols.items()}
        self.state = AlertState(**{
            f: torch.as_tensor(c, device=engine.device)
            for f, c in cols.items()})

    def _measures_host(self, engine) -> np.ndarray:
        """Current finalized measure per registered base (one readback;
        only at registration / churn barriers, never per batch)."""
        (pao,) = to_host(self._global(engine.state.pao))
        if not self._stacked:
            pao = pao[None]
        fin = np.asarray(engine.agg.FINALIZE(pao.reshape(-1, pao.shape[-1])),
                         np.float32).reshape(pao.shape[0], pao.shape[1], -1)
        comp = np.clip(self._static["comp"], 0, fin.shape[-1] - 1)
        return fin[self._shard, self._node, comp]

    # --------------------------------------------------------- fired plumbing
    def push_pending(self, now: float, count, idx, vals, fired, m) -> None:
        """Stash one step's fired buffers: the count and the compact
        index/value buffer start their copies to pinned host memory now,
        behind the step, with one event; ``fired``/``m`` stay on the device
        for the overflow fallback. No wait, no implicit sync."""
        if count.device.type == "cuda":
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in (count, idx, vals)]
            for h, t in zip(host, (count, idx, vals)):
                h.copy_(t, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
        else:
            host, ev = [count, idx, vals], None
        self._pending.append((float(now), host, ev, fired, m,
                               time.perf_counter()))
        self.seq += 1

    @property
    def pending(self) -> int:
        return len(self._pending)

    def collect(self, n: int | None = None) -> int:
        """Read back up to ``n`` pending fired sets (all when ``None``) into
        host :class:`FiredBatch` es. The ingest ring collects exactly the
        freed slot's steps, whose copies have completed; elsewhere this
        waits on each entry's copy event (an explicit wait)."""
        n = len(self._pending) if n is None else min(n, len(self._pending))
        out = 0
        for _ in range(n):
            now, host, ev, fired, m, t_disp = self._pending.popleft()
            self.seq_done += 1
            if ev is not None:
                ev.synchronize()
            count, idx, vals = (np.asarray(h.numpy()) for h in host)
            self.detect_s.append(time.perf_counter() - t_disp)
            if int(count.reshape(-1)[0]) == 0:
                continue
            if self._gather is not None:
                # the total was all-reduced, so every rank gets here: the
                # ranks' compact buffers, in rank order
                per, idx, vals = to_host(*(
                    self._gather(torch.from_numpy(np.ascontiguousarray(a)))
                    for a in (count.reshape(-1)[1:], idx, vals)))
                count = np.concatenate([count.reshape(-1)[:1], per])
            batch = self._to_batch(now, idx, vals, count, fired, m)
            if len(batch):
                self.fired.append(batch)
                out += 1
        return out

    def _to_batch(self, now, idx, vals, count, fired, m) -> FiredBatch:
        """One step's fired set from its compact buffers: per shard, the
        (cap,) index/value buffer, or — when that shard fired more than
        ``cap`` rows — its dense fired vector (rare path, one readback)."""
        count = count.reshape(-1)
        if self._stacked:
            counts = count[1:]
        else:
            idx, vals, counts = idx[None], vals[None], count[:1]
        dense = None
        sh, nd, vv = [], [], []
        for s, c in enumerate(counts):
            if c > self.cap:
                if dense is None:
                    dense = to_host(self._global(fired), self._global(m))
                    if not self._stacked:
                        dense = [d[None] for d in dense]
                nodes = np.flatnonzero(dense[0][s])
                v = dense[1][s][nodes].astype(np.float32)
            else:
                live = idx[s] >= 0
                nodes, v = idx[s][live], vals[s][live]
            sh.append(np.full(len(nodes), s, np.int64))
            nd.append(nodes.astype(np.int64))
            vv.append(v)
        overflow = dense is not None
        sh, nd, vv = np.concatenate(sh), np.concatenate(nd), np.concatenate(vv)
        bases = self._row_base[sh, nd]
        aids = self._row_aid[sh, nd]
        live = bases >= 0
        order = np.argsort(bases[live], kind="stable")
        return FiredBatch(now=now, base_ids=bases[live][order],
                          values=vv[live][order], aids=aids[live][order],
                          overflow=bool(overflow))

    def collect_upto(self, upto: int) -> int:
        """Read back pending fired sets up through dispatch sequence ``upto``
        (a :attr:`seq` value recorded when those steps were enqueued). A
        no-op when an interleaved :meth:`collect` already drained past the
        mark."""
        return self.collect(max(0, upto - self.seq_done))

    def pop_fired(self) -> list[FiredBatch]:
        out = list(self.fired)
        self.fired.clear()
        return out

    def per_base(self) -> dict[str, np.ndarray]:
        """Copies of the per-base columns, the device's dynamic state folded
        in (keyed by base id, not row): the poll oracle seeds from them."""
        self._pull_dynamic()
        arrays = {"base": self._base.copy(), "aid": self._aid.copy()}
        for d in (self._static, self._dyn):
            for f, col in d.items():
                arrays[f] = col.copy()
        return arrays

    # ------------------------------------------------------------ checkpoint
    def snapshot(self) -> tuple[dict, list]:
        """Per-base packed arrays + JSON spec descriptors, in the JAX
        package's format. The packed layout is placement-free (base ids,
        not rows), so a reshard restore places the same armed/debounce
        state onto whatever layout the restored session compiles."""
        specs = [{"aid": int(a), "dynamic": a in self._dynamic_aids,
                  "spec": self._specs[a].to_json()}
                 for a in sorted(self._specs)]
        return self.per_base(), specs

    @classmethod
    def from_snapshot(cls, arrays: dict, specs: list, *,
                      cap: int | None = None) -> "AlertSet":
        alerts = cls(cap)
        alerts._base = np.asarray(arrays["base"], np.int64)
        alerts._aid = np.asarray(arrays["aid"], np.int64)
        M = len(alerts._base)
        for f in alerts._static:
            alerts._static[f] = np.asarray(
                arrays[f], alerts._static[f].dtype).copy()
        for f in alerts._dyn:
            alerts._dyn[f] = np.asarray(arrays[f], alerts._dyn[f].dtype).copy()
        alerts._shard = np.zeros(M, np.int32)
        alerts._node = np.full(M, -1, np.int32)
        alerts._placed = np.zeros(M, bool)
        for s in specs:
            alerts._specs[int(s["aid"])] = AlertSpec.from_json(s["spec"])
            if s.get("dynamic"):
                alerts._dynamic_aids.add(int(s["aid"]))
        return alerts


# ----------------------------------------------------------------- validation
def check_alert_aggregate(agg: Aggregate) -> int:
    """Reject aggregates whose finalize output is not value-shaped and
    return the measure dimensionality (payload lanes ``component`` may
    select)."""
    if agg.name not in ALERT_COMPATIBLE:
        raise ValueError(
            f"aggregate {agg.name!r} cannot back an alert — its finalize "
            f"output is not an ordered value (supported: "
            f"{', '.join(ALERT_COMPATIBLE)})")
    fin = np.asarray(agg.FINALIZE(np.zeros((1, agg.pao_dim), np.float32)))
    return int(fin.reshape(1, -1).shape[1])


# ------------------------------------------------------------------ poll oracle
class PollOracle:
    """The baseline this subsystem replaces, kept as the parity reference:
    after every device batch, read back the finalized measures of **all**
    alerted readers (O(alerts) per batch) and run the identical state
    machine on the host. Same f32 values, same comparisons — fired sets must
    match the device path bit for bit."""

    def __init__(self, alerts: AlertSet):
        arrays = alerts.per_base()
        self.base = arrays["base"]
        self.aid = arrays["aid"]
        self.static = {f: arrays[f] for f in
                       ("hi", "lo", "dthr", "hys", "deb", "comp")}
        # the full dynamic state, so an oracle seeded mid-stream carries
        # armed/debounce state and does not re-fire what already fired
        self.armed = arrays["armed"].copy()
        self.last_fire = arrays["last_fire"].copy()
        self.ref = arrays["ref"].copy()
        self.last_m = arrays["last_m"].copy()
        self._nodes = None

    def resync(self, engine) -> None:
        """Re-resolve reader nodes (registration / after churn)."""
        nodes, keep = engine.plan.routes.reader_nodes(self.base)
        if not keep.all():
            self.base, self.aid = self.base[keep], self.aid[keep]
            for f in self.static:
                self.static[f] = self.static[f][keep]
            for f in ("armed", "last_fire", "ref", "last_m"):
                setattr(self, f, getattr(self, f)[keep])
            nodes = nodes[keep]
        self._nodes = torch.as_tensor(nodes.astype(np.int64),
                                      device=engine.device)

    def poll(self, engine, now: float) -> FiredBatch:
        """One poll step: the O(alerts) readback the device path avoids."""
        if self._nodes is None:
            self.resync(engine)
        (fin,) = to_host(engine.agg.finalize(engine.state.pao[self._nodes]))
        fin = np.asarray(fin, np.float32)
        if fin.ndim == 1:
            fin = fin[:, None]
        m = fin[np.arange(len(self.base)),
                np.clip(self.static["comp"], 0, fin.shape[1] - 1)]
        now32 = np.float32(now)
        changed = m != self.last_m
        trip = (m > self.static["hi"]) | (m < self.static["lo"]) | \
            (np.abs(m - self.ref) > self.static["dthr"])
        can_fire = (now32 - self.last_fire) >= self.static["deb"]
        fired = changed & self.armed & trip & can_fire
        inside = (m <= self.static["hi"] - self.static["hys"]) & \
            (m >= self.static["lo"] + self.static["hys"])
        self.armed = np.where(fired, False, self.armed | (changed & inside))
        self.last_fire = np.where(fired, now32, self.last_fire)
        self.ref = np.where(fired, m, self.ref)
        self.last_m = np.where(changed, m, self.last_m)
        hit = np.flatnonzero(fired)
        order = np.argsort(self.base[hit], kind="stable")
        return FiredBatch(now=float(now), base_ids=self.base[hit][order],
                          values=m[hit][order], aids=self.aid[hit][order])
