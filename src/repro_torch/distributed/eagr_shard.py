"""Reader-partitioned EAGr execution (paper §7's parallelization), in
PyTorch.

The paper sketches the distribution strategy: "readers can be partitioned in
a disjoint fashion over a set of machines, and for each machine, an overlay
can be constructed for the readers assigned to that machine; the writes for
each writer would be sent to all the machines where they are needed."

Mapping to the port:
  * readers are hash-partitioned over the shards,
  * each shard holds the *sub-overlay closure* of its readers (writers +
    partial aggregation nodes reachable backwards from its readers) as a
    leveled CSR plan, padded to one shared program shape
    (``align_shard_plans``),
  * a write batch is relevant to every shard that consumes the writer: the
    batch is replicated (the all-gather the paper describes; on one card
    every shard's slice of the stack reads the same batch),
  * reads are shard-local (each reader lives on exactly one shard).

This module owns the host-side machinery: partitioning, plan alignment,
delta routing (``ShardedDynamic``), and the per-shard host loop helpers
(``shard_write_batch`` / ``shard_read_batch``) kept as the parity and
benchmark baseline. The production execution path is
``distributed.stacked.StackedShardedEngine``: all shards stacked along a
leading axis of one card's tensors, batch routing on the device, or, inside
a ``torch.distributed`` group of one rank per shard, each rank's own shard
(``keep_local_shard`` uploads its plan and leaves the others on the host).

Everything here is host numpy and equals the JAX package's array for
array.

For realistic deployments the write batch (ids + values) is tiny compared to
the partial-aggregate state, exactly as the paper argues.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.dataflow import PULL, PUSH
from repro_torch.core.dynamic import DynamicOverlay
from repro_torch.core.engine import (
    ExecPlan,
    PlanPad,
    compile_plan,
    grow_pad,
    measure_plan,
    plan_dims,
)
from repro_torch.core.overlay import Overlay


@dataclasses.dataclass
class ShardedOverlay:
    """Host-side partition of an overlay into per-shard closures."""

    shards: list[Overlay]
    shard_decisions: list[np.ndarray]
    reader_shard: dict[int, int]          # base reader id -> shard
    shard_plans: list[ExecPlan]
    writer_rows: list[dict[int, int]]     # per shard: base writer -> local row

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def replication_factor(self) -> float:
        """Avg #shards a writer is replicated to (paper's write fan-out)."""
        from collections import Counter
        c = Counter()
        for rows in self.writer_rows:
            for w in rows:
                c[w] += 1
        return float(np.mean(list(c.values()))) if c else 0.0


def align_shard_plans(shards: list[Overlay], decisions: list[np.ndarray],
                      *, device=None,
                      headroom: float | None = None) -> list[ExecPlan]:
    """Compile every shard's plan padded to the element-wise maximum of all
    shard dimensions (nodes, writers, levels, edge blocks, demand slots).

    Aligned plans share one ``PlanMeta`` (up to their real depth) and
    identical table shapes, so the shard axis can be a stacked leading
    dimension that one launch per level covers. Dims come from the host-side
    ``measure_plan`` pass, so each plan's tables are built exactly once.
    ``headroom`` grows the shared pad (as ``EagrEngine(headroom=...)``) so
    structural churn patches every shard in place instead of forcing a
    stack-wide realignment on the first slot overflow."""
    dims = [measure_plan(s, d) for s, d in zip(shards, decisions)]
    pad = PlanPad(**{f: max(getattr(d, f) for d in dims)
                     for f in PlanPad.__dataclass_fields__})
    if headroom and headroom > 1.0:
        pad = grow_pad(pad, headroom)
    return [compile_plan(s, d, device=device, pad=pad)
            for s, d in zip(shards, decisions)]


def keep_local_shard(sharded: ShardedOverlay, rank: int, device) -> None:
    """One shard per rank: shard ``rank``'s plan tables go to ``device``,
    the only tables this rank uploads; every other shard's plan stays on
    the CPU as host bookkeeping (each rank replays every shard's churn on
    it, so all ranks take the same realign decisions). Run on every rank
    after ``partition_overlay(..., device="cpu")``, which gives every rank
    the same plans from the same overlay, decisions and seed."""
    from repro_torch.core.engine import _map_arrays

    cpu = torch.device("cpu")
    for s, p in enumerate(sharded.shard_plans):
        dev = torch.device(device) if s == rank else cpu
        if p.arrays.decision.device != dev:
            p.arrays = _map_arrays(lambda x, dev=dev: x.to(dev), p.arrays)


def partition_overlay(overlay: Overlay, decisions: np.ndarray,
                      n_shards: int, seed: int = 0, *,
                      device=None,
                      headroom: float | None = None) -> ShardedOverlay:
    """Hash-partition readers; carve each shard's backward closure."""
    rng = np.random.default_rng(seed)
    readers = overlay.reader_nodes()
    shard_of_reader = {r: int(h) for r, h in zip(
        readers, rng.integers(0, n_shards, len(readers)))}

    shards, shard_decs, plans, writer_rows = [], [], [], []
    signatures = _decision_signatures(overlay, decisions)
    reader_shard = {}
    for s in range(n_shards):
        keep = np.zeros(overlay.n_nodes, dtype=bool)
        stack = [r for r in readers if shard_of_reader[r] == s]
        for r in stack:
            keep[r] = True
            reader_shard[overlay.origin[r]] = s
        while stack:
            v = stack.pop()
            for src, _ in overlay.in_edges[v]:
                if not keep[src]:
                    keep[src] = True
                    stack.append(src)
        remap = {}
        sub = Overlay(kinds=[], origin=[], in_edges=[],
                      dup_insensitive=overlay.dup_insensitive)
        for v in range(overlay.n_nodes):
            if keep[v]:
                kind = overlay.kinds[v]
                if kind == "R" and shard_of_reader.get(v, -1) != s:
                    kind = "I"  # another shard's reader pulled in as interior
                remap[v] = sub.add_node(kind, overlay.origin[v])
        dec = []
        for v in range(overlay.n_nodes):
            if keep[v]:
                for src, sign in overlay.in_edges[v]:
                    sub.add_edge(remap[src], remap[v], sign)
                dec.append(decisions[v])
        sub = sub.pruned()
        # pruning may drop nodes; recompute decisions on the pruned overlay by
        # rebuilding the remap through origin/kind alignment: simplest is to
        # re-run partitioning without pruning; instead keep unpruned sub.
        shards.append(sub)
        # align decisions with pruned overlay via greedy re-derivation:
        # push nodes whose all-inputs-push invariants must hold; reuse the
        # original decision for surviving nodes by matching origins where
        # possible, defaulting interior nodes to PUSH.
        shard_decs.append(_project_decisions(overlay, decisions, sub,
                                             signatures))
    # One padded plan shape for all shards: the stack runs every shard's
    # level in one launch (paper §7 on one machine).
    plans = align_shard_plans(shards, shard_decs, device=device,
                              headroom=headroom)
    writer_rows = [plan.writer_row_of_base for plan in plans]
    return ShardedOverlay(shards=shards, shard_decisions=shard_decs,
                          reader_shard=reader_shard, shard_plans=plans,
                          writer_rows=writer_rows)


def _decision_signatures(full: Overlay,
                         decisions: np.ndarray) -> dict[frozenset, int]:
    """Each interior/reader node's decision by its input-writer set
    signature (unique within one overlay construction; the first node of a
    signature wins), taken once for every shard's projection."""
    full_sets = full.input_writer_sets()
    sig_dec: dict[frozenset, int] = {}
    for v in range(full.n_nodes):
        if full.kinds[v] != "W":
            sig_dec.setdefault(frozenset(full_sets[v]), int(decisions[v]))
    return sig_dec


def _project_decisions(full: Overlay, decisions: np.ndarray, sub: Overlay,
                       sig_dec: dict[frozenset, int] | None = None
                       ) -> np.ndarray:
    """Project dataflow decisions onto a shard's sub-overlay.

    Writers stay PUSH. For interior/reader nodes we match by the node's
    input-writer set signature (``_decision_signatures`` of the full
    overlay, taken here unless the caller passes it)."""
    if sig_dec is None:
        sig_dec = _decision_signatures(full, decisions)
    dec = np.zeros(sub.n_nodes, dtype=np.int64)
    sub_sets = sub.input_writer_sets()
    for v in range(sub.n_nodes):
        if sub.kinds[v] == "W":
            dec[v] = PUSH
        else:
            dec[v] = sig_dec.get(frozenset(sub_sets[v]), PULL)
    # enforce the push/pull frontier invariant (no pull upstream of a push)
    order = sub.toposort()
    for v in order:
        if dec[v] == PUSH and any(dec[s] == PULL for s, _ in sub.in_edges[v]):
            dec[v] = PULL
    return dec


class _ShardJournals:
    """Each shard's ``DynamicOverlay``, built on its first use (indexing or
    iterating builds; ``built`` does not). A burst that touches one shard
    builds that shard's journal only; every build starts from the same
    construction snapshot, so a late build equals an early one."""

    def __init__(self, build, n: int):
        self._build = build
        self._dyn: list[DynamicOverlay | None] = [None] * n

    def __len__(self) -> int:
        return len(self._dyn)

    def __getitem__(self, s: int) -> DynamicOverlay:
        if self._dyn[s] is None:
            self._dyn[s] = self._build(s)
        return self._dyn[s]

    def __iter__(self):
        return (self[s] for s in range(len(self._dyn)))

    def built(self) -> list[tuple[int, DynamicOverlay]]:
        return [(s, d) for s, d in enumerate(self._dyn) if d is not None]


class ShardedDynamic:
    """Structural churn (§3.3) over a reader-partitioned deployment.

    Each shard adopts its sub-overlay into a ``DynamicOverlay`` (node ids
    align 1:1 with the shard's compiled plan, so deltas patch in place),
    on the shard's first mutation (``dynamics``). ``live_writers`` (a
    restored deployment's, whose saved overlays are unpruned exports) drops
    the writer nodes a shard no longer has from its journal as it is built.
    Base-graph mutations are routed to the shards that own the affected
    readers — a writer-side change fans out to every shard consuming the
    writer, mirroring how writes themselves are replicated. ``apply()``
    drains every shard's delta, patches the owning plans (through the shard
    engines when given, migrating their state), then re-runs the
    ``align_shard_plans`` dims check: if any shard fell back to a recompile
    with growth headroom, the remaining shards are recompiled to the same
    padded shape so execution stays on one compiled program."""

    def __init__(self, sharded: ShardedOverlay, engines=None,
                 *, growth: float = 2.0, live_writers: list | None = None):
        from repro_torch.distributed.stacked import StackedShardedEngine

        self.sharded = sharded
        self.stacked = engines if isinstance(engines, StackedShardedEngine) \
            else None
        self.engines = None if self.stacked is not None else engines
        self.growth = growth
        self._live_writers = live_writers
        self.dynamics = _ShardJournals(self._journal, sharded.n_shards)

    def _journal(self, s: int) -> DynamicOverlay:
        sub = self.sharded.shards[s]
        sets = sub.input_writer_sets()
        ris = {sub.origin[v]: set(sets[v]) for v in sub.reader_nodes()}
        dyn = DynamicOverlay.from_overlay(sub, ris)
        if self._live_writers is not None:
            from repro_torch.distributed.checkpoint import scrub_dead_writers
            scrub_dead_writers(dyn, self._live_writers[s])
        return dyn

    # --------------------------------------------------------------- routing
    def _owner(self, reader: int, *, allow_new: bool = False) -> int:
        s = self.sharded.reader_shard.get(int(reader))
        if s is None:
            if not allow_new:
                raise ValueError(
                    f"base id {int(reader)} is owned by no shard — register "
                    f"it through add_node() before routing mutations to it")
            # genuinely new reader: deterministic assignment
            s = int(reader) % self.sharded.n_shards
            self.sharded.reader_shard[int(reader)] = s
        return s

    def route(self, affected: dict[int, set[int]], *,
              allow_new: bool = False) -> dict[int, dict[int, set[int]]]:
        """Split one {reader: delta_writers} map by owning shard. Unknown
        readers raise unless ``allow_new`` (the add_node path) is set."""
        per_shard: dict[int, dict[int, set[int]]] = {}
        for r, delta in affected.items():
            per_shard.setdefault(self._owner(r, allow_new=allow_new),
                                 {})[r] = set(delta)
        return per_shard

    def add_edge(self, u: int, v: int,
                 affected: dict[int, set[int]] | None = None) -> None:
        for s, aff in self.route(affected if affected is not None else {v: {u}}).items():
            self.dynamics[s].add_edge(u, v, affected=aff)

    def delete_edge(self, u: int, v: int,
                    affected: dict[int, set[int]] | None = None) -> None:
        for s, aff in self.route(affected if affected is not None else {v: {u}}).items():
            self.dynamics[s].delete_edge(u, v, affected=aff)

    def add_node(self, u: int, in_neighbors: set[int],
                 out_readers: set[int]) -> None:
        # u's home shard tracks its write stream from day one (matching the
        # single-machine engine, where the writer window exists immediately);
        # other shards start u's window empty when a reader there follows u
        # later — cross-shard window backfill on new subscriptions is a known
        # gap (would need a state transfer, see ROADMAP).
        home = self._owner(u, allow_new=True)
        self.dynamics[home].b.add_writer(u)
        for s, aff in self.route({r: {u} for r in out_readers}).items():
            for r, delta in aff.items():
                self.dynamics[s].add_reader_inputs(r, delta)
        if in_neighbors:
            self.dynamics[home].add_reader_inputs(u, set(in_neighbors))

    def delete_node(self, u: int) -> None:
        for s, dyn in enumerate(self.dynamics):
            if u in dyn.b.writer_node or u in dyn.reader_node:
                dyn.delete_node(u)
        self.sharded.reader_shard.pop(int(u), None)

    # ----------------------------------------------------------------- apply
    def apply(self) -> list:
        """Drain every shard's delta and patch the owning plans, then restore
        the one-program-shape invariant. Returns per-shard ``PatchResult``
        (None for untouched shards). With a ``StackedShardedEngine`` each
        in-capacity patch swaps exactly one slice of the stacked pytree; any
        growth fallback realigns every shard and restacks the whole stack."""
        from repro_torch.core.plan_patch import patch_plan

        results = []
        built = dict(self.dynamics.built())
        for s in range(self.sharded.n_shards):
            delta = built[s].drain_delta() if s in built else None
            if delta is None or delta.empty:
                results.append(None)
                continue
            if self.stacked is not None:
                res = self.stacked.apply_delta(s, delta, growth=self.growth)
            elif self.engines is not None:
                res = self.engines[s].apply_delta(delta, growth=self.growth)
                self.sharded.shard_plans[s] = self.engines[s].plan
            else:
                res = patch_plan(self.sharded.shard_plans[s], delta,
                                 overlay=self.sharded.shards[s],
                                 growth=self.growth)
                self.sharded.shard_plans[s] = res.plan
            self.sharded.writer_rows[s] = res.plan.writer_row_of_base
            results.append(res)
        self.ensure_aligned()
        # in-capacity patches refreshed their own slice + owner maps inside
        # apply_delta; only a growth fallback leaves the stack to re-adopt
        if self.stacked is not None and self.stacked._needs_restack:
            self.stacked.restack()
        return results

    def readopt_decisions(self, decisions: list[np.ndarray | None]) -> bool:
        """Recompile shards whose push/pull decisions changed (§4.8 adaptive
        re-decision over a partitioned deployment) and re-establish the
        one-program-shape invariant. ``decisions[s]`` is the shard's new
        decision vector over its *current* (host-mirror) overlay, or None to
        keep the shard as-is. Padded dims are floored at the element-wise
        maximum of every shard's current and re-measured dims, so unchanged
        shards usually skip recompilation entirely. With a stacked engine the
        whole stack re-adopts (``adopt_shard_plans``); host-loop engines adopt
        per shard. Returns True if any shard was recompiled."""
        from repro_torch.core.plan_patch import carry_plan_bookkeeping

        if all(d is None for d in decisions):
            return False
        plans = self.sharded.shard_plans
        overlays = []
        dims = [plan_dims(p) for p in plans]
        for s, dec in enumerate(decisions):
            host = plans[s].host
            ov = host.export_overlay() if host is not None \
                else self.sharded.shards[s]
            overlays.append(ov)
            if dec is not None:
                dims.append(measure_plan(ov, np.asarray(dec, np.int64)))
        target = PlanPad(**{f: max(getattr(d, f) for d in dims)
                            for f in PlanPad.__dataclass_fields__})
        changed = False
        for s, dec in enumerate(decisions):
            p = plans[s]
            if dec is None and plan_dims(p) == target:
                continue
            dec = p.decision if dec is None else np.asarray(dec, np.int64)
            new = compile_plan(overlays[s], dec, pad=target,
                               device=p.arrays.decision.device)
            carry_plan_bookkeeping(new, p, overlays[s])
            plans[s] = new
            self.sharded.shard_decisions[s] = dec
            self.sharded.writer_rows[s] = new.writer_row_of_base
            changed = True
            if self.engines is not None:
                self.engines[s].adopt_plan(new)
            if self.stacked is not None:
                self.stacked._needs_restack = True
        if self.stacked is not None and self.stacked._needs_restack:
            self.stacked.adopt_shard_plans()
        return changed

    def ensure_aligned(self) -> bool:
        """Re-run the ``align_shard_plans`` dims check; recompile any shard
        whose padded dims diverged (a growth-headroom fallback) to the
        element-wise maximum so all shards share one program shape again.
        Returns True if a realign was needed."""
        from repro_torch.core.plan_patch import carry_plan_bookkeeping

        plans = self.sharded.shard_plans
        dims = [plan_dims(p) for p in plans]
        if all(d == dims[0] for d in dims[1:]):
            return False
        target = PlanPad(**{f: max(getattr(d, f) for d in dims)
                            for f in PlanPad.__dataclass_fields__})
        for s, p in enumerate(plans):
            if plan_dims(p) == target:
                continue
            host = p.host
            ov = host.export_overlay() if host is not None \
                else self.sharded.shards[s]
            new = compile_plan(ov, p.decision, pad=target,
                               device=p.arrays.decision.device)
            carry_plan_bookkeeping(new, p, ov)
            if self.engines is not None:
                self.engines[s].adopt_plan(new)
            # a stacked engine re-adopts every slice at once via restack()
            if self.stacked is not None:
                self.stacked._needs_restack = True
            plans[s] = new
            self.sharded.writer_rows[s] = new.writer_row_of_base
        return True


def host_loop_write(sharded: ShardedOverlay, engines: list,
                    base_ids: np.ndarray, values: np.ndarray) -> None:
    """The pre-stacking execution path, one dense step per shard — kept as
    the parity/benchmark baseline the stacked engine must match bit for
    bit. ``engines`` are per-shard ``EagrEngine``s over the aligned plans."""
    for eng, (rows, v, m) in zip(engines,
                                 shard_write_batch(sharded, base_ids, values)):
        v = np.where(m.reshape((-1,) + (1,) * (v.ndim - 1)), v, 0.0) \
            .astype(np.float32)
        eng.write_rows(rows, v, m, active=None)


def host_loop_read(sharded: ShardedOverlay, engines: list,
                   base_ids: np.ndarray) -> np.ndarray:
    """Per-shard host loop read, gathered host-side (each lane is owned by
    exactly one shard, so the masked sum is a gather)."""
    from repro_torch.core.engine import to_host

    acc = None
    for eng, (nodes, m) in zip(engines, shard_read_batch(sharded, base_ids)):
        ans, _ = eng._read_body(nodes, m, None)
        (ans,) = to_host(ans)
        part = np.where(m.reshape(m.shape + (1,) * (ans.ndim - 1)), ans, 0)
        acc = part if acc is None else acc + part
    return acc


def shard_write_batch(sharded: ShardedOverlay, base_ids: np.ndarray,
                      values: np.ndarray):
    """Route one global write batch to every shard that consumes the writer
    (host-side; the device-side equivalent is ``StackedShardedEngine``'s
    owner-map mask). Returns per-shard (rows, vals, mask) in
    *batch-lane order* — lane i stays lane i with ``mask[i]`` flagging
    ownership — so the host loop computes bit-identically to the stacked
    program, which sees the same masked layout."""
    B = len(base_ids)
    vals = np.asarray(values, np.float32)
    out = []
    for s in range(sharded.n_shards):
        rows = np.zeros(B, np.int32)
        mask = np.zeros(B, bool)
        wr = sharded.writer_rows[s]
        for i, b in enumerate(base_ids):
            row = wr.get(int(b))
            if row is not None:
                rows[i], mask[i] = row, True
        out.append((rows, vals, mask))
    return out


def shard_read_batch(sharded: ShardedOverlay, base_ids: np.ndarray):
    """Route reads to their unique owner shard, in batch-lane order (lane i
    answers base_ids[i] on the owning shard; mask elsewhere). A base id owned
    by no shard has no answer anywhere — raise instead of silently returning
    a masked lane."""
    def _unowned(b: int) -> bool:
        s = sharded.reader_shard.get(b)
        # a shard assignment without a compiled reader node (e.g. a pure
        # writer registered via add_node, or a pending delta) is unreadable
        return s is None or b not in sharded.shard_plans[s].reader_node_of_base

    unknown = [int(b) for b in base_ids if _unowned(int(b))]
    if unknown:
        raise ValueError(
            f"shard_read_batch: base ids {sorted(set(unknown))[:8]} are "
            f"owned by no shard (not readers of any shard overlay)")
    B = len(base_ids)
    out = []
    for s in range(sharded.n_shards):
        nodes = np.zeros(B, np.int32)
        mask = np.zeros(B, bool)
        plan = sharded.shard_plans[s]
        for i, b in enumerate(base_ids):
            if sharded.reader_shard.get(int(b)) == s:
                nodes[i] = plan.reader_node_of_base[int(b)]
                mask[i] = True
        out.append((nodes, mask))
    return out
