"""Incremental overlay maintenance under data-graph changes (paper §3.3).

Adopts any constructed overlay (VNM*/IOB) into an indexed, mutable form and
applies edge/node additions and deletions using the IOB machinery:

  add edge   — if |Δ(I(r))| > threshold, cover the delta with (possibly new)
               aggregation nodes; else add direct writer edges; a per-reader
               direct-edge counter triggers IOB restructuring past the threshold.
  delete edge— if few upstream nodes are affected, split them so the reader
               stops consuming the deleted writers; else drop the reader's
               inputs and re-cover with IOB.
  add node   — new writer node + IOB insertion of the new reader.
  delete node— remove v_w and v_r with all incident edges (sound for all
               downstream aggregates: a deleted node leaves every neighborhood).

Negative (subtraction) edges into readers are supported: adding a data-graph
edge whose writer already has a negative edge to the reader simply cancels the
negative edge; deletions never touch negative edges (they reference non-members).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from repro_torch.core.iob import IOBBuilder
from repro_torch.core.overlay import Overlay


class NodePatch(NamedTuple):
    """Post-mutation snapshot of one overlay node, as the patcher consumes it."""

    kind: str                           # effective kind ('W'|'I'|'R'; emptied
                                        # readers already demoted to 'I')
    origin: int
    edges: tuple[tuple[int, int], ...]  # current in-edges (src overlay node, sign)


@dataclasses.dataclass
class OverlayDelta:
    """Structured mutation log of one churn burst (paper §3.3).

    ``nodes`` snapshots every node whose in-edge list (or kind) changed,
    including all newly created nodes — enough for ``plan_patch`` to diff
    against the live plan's host mirror and patch the level tables in place.
    Per-level edge adds/removes are *derived* there (levels are a global
    property of the DAG, not something the mutation site can know).
    """

    nodes: dict[int, NodePatch]
    n_nodes_before: int
    n_nodes_after: int
    new_writer_nodes: list[int]         # ALL W-kind nodes created this epoch,
                                        # id order — every one claims a window
                                        # row so patched and recompiled plans
                                        # agree on row positions (W-kind nodes
                                        # own rows in id order on both paths,
                                        # even if deleted within the epoch)
    new_writers: dict[int, int]         # base id -> new overlay writer node
    new_readers: dict[int, int]         # base id -> new overlay reader node
    retired_writers: set[int]           # base ids whose writer role ended
    retired_readers: set[int]           # base ids whose reader role ended
    touched_readers: set[int]           # base reader ids affected (shard routing)

    @property
    def empty(self) -> bool:
        return not (self.nodes or self.retired_writers or self.retired_readers)

    def merge(self, later: "OverlayDelta") -> "OverlayDelta":
        """Coalesce two consecutive deltas (later snapshots win; a later
        retirement cancels an earlier addition and vice versa)."""
        nodes = dict(self.nodes)
        nodes.update(later.nodes)
        new_writers = {**self.new_writers, **later.new_writers}
        new_readers = {**self.new_readers, **later.new_readers}
        for b in later.retired_writers - set(later.new_writers):
            new_writers.pop(b, None)
        for b in later.retired_readers - set(later.new_readers):
            new_readers.pop(b, None)
        return OverlayDelta(
            nodes=nodes,
            n_nodes_before=self.n_nodes_before,
            n_nodes_after=later.n_nodes_after,
            new_writer_nodes=self.new_writer_nodes + later.new_writer_nodes,
            new_writers=new_writers,
            new_readers=new_readers,
            retired_writers=(self.retired_writers - set(later.new_writers))
            | later.retired_writers,
            retired_readers=(self.retired_readers - set(later.new_readers))
            | later.retired_readers,
            touched_readers=self.touched_readers | later.touched_readers,
        )


class DynamicOverlay:
    def __init__(self, builder: IOBBuilder, reader_node: dict[int, int],
                 neg_edges: dict[int, list[int]], reader_inputs: dict[int, set[int]],
                 threshold: int = 4, split_limit: int = 5):
        self.b = builder
        self.reader_node = reader_node          # base reader id -> overlay node
        self.neg_edges = neg_edges              # reader overlay node -> [writer overlay nodes]
        self.reader_inputs = reader_inputs      # base reader id -> set of base writers
        self.threshold = threshold
        self.split_limit = split_limit
        self.direct_writer_count: dict[int, int] = {}
        self.dup_insensitive = False
        # ------------------------------------------------------ mutation log
        self._dirty: set[int] = set()           # nodes whose inputs changed
        builder.journal = self._dirty
        self._delta_base = len(builder.kinds)   # first node id of this burst
        self._retired_writers: set[int] = set()
        self._retired_readers: set[int] = set()
        self._touched_readers: set[int] = set()

    # ------------------------------------------------------------ adoption
    @staticmethod
    def from_overlay(ov: Overlay, reader_inputs: dict[int, set[int]],
                     threshold: int = 4, split_limit: int = 5) -> "DynamicOverlay":
        b = IOBBuilder()
        neg: dict[int, list[int]] = {}
        # nodes adopt 1:1 (same ids); members computed from positive closure
        sets = ov.input_writer_sets()
        for v in range(ov.n_nodes):
            b.kinds.append(ov.kinds[v])
            b.origin.append(ov.origin[v])
            b.inputs.append([s for s, sign in ov.in_edges[v] if sign > 0])
            members = set(sets[v]) if ov.kinds[v] != "W" else {ov.origin[v]}
            b.members.append(members)
            for w in members:
                b.rev.setdefault(w, set()).add(v)
            if ov.kinds[v] == "W":
                b.writer_node[ov.origin[v]] = v
            negs = [s for s, sign in ov.in_edges[v] if sign < 0]
            if negs:
                neg[v] = negs
        reader_node = {ov.origin[v]: v for v in range(ov.n_nodes) if ov.kinds[v] == "R"}
        dyn = DynamicOverlay(b, reader_node, neg, {r: set(s) for r, s in reader_inputs.items()},
                             threshold=threshold, split_limit=split_limit)
        dyn.dup_insensitive = ov.dup_insensitive
        return dyn

    def fork(self) -> "DynamicOverlay":
        """Independent deep copy with the same node ids and the same internal
        counters, starting with a clean mutation journal.

        Two forks fed the same mutation sequence evolve identically (ids,
        restructuring thresholds, cover order), so a session can keep one
        journaling ``DynamicOverlay`` per engine group over a single overlay
        construction: each group drains its own delta against its own plan
        while all groups stay structurally in lockstep."""
        b = IOBBuilder()
        b.kinds = list(self.b.kinds)
        b.origin = list(self.b.origin)
        b.inputs = [list(ins) for ins in self.b.inputs]
        b.members = [set(m) for m in self.b.members]
        b.rev = {w: set(ns) for w, ns in self.b.rev.items()}
        b.writer_node = dict(self.b.writer_node)
        dyn = DynamicOverlay(
            b, dict(self.reader_node),
            {r: list(ws) for r, ws in self.neg_edges.items()},
            {r: set(ws) for r, ws in self.reader_inputs.items()},
            threshold=self.threshold, split_limit=self.split_limit)
        dyn.dup_insensitive = self.dup_insensitive
        dyn.direct_writer_count = dict(self.direct_writer_count)
        return dyn

    # ------------------------------------------------------------ helpers
    def _upstream_nodes(self, node: int) -> set[int]:
        seen = set()
        stack = [node]
        while stack:
            v = stack.pop()
            for s in self.b.inputs[v]:
                if s not in seen:
                    seen.add(s)
                    stack.append(s)
        return seen

    def _ensure_reader(self, r: int) -> int:
        if r in self.reader_node:
            return self.reader_node[r]
        nid = self.b.add_node("R", r, set())
        self.reader_node[r] = nid
        self.reader_inputs.setdefault(r, set())
        return nid

    # ------------------------------------------------------------ additions
    def add_reader_inputs(self, r: int, delta: set[int]) -> None:
        """Reader r's neighborhood gained the writers in ``delta`` (§3.3)."""
        delta = set(delta) - self.reader_inputs.get(r, set())
        if not delta:
            return
        rid = self._ensure_reader(r)
        self._dirty.add(rid)
        self._touched_readers.add(r)
        self.reader_inputs[r] |= delta
        # members/rev for the reader reflect its I-set
        self.b.members[rid] |= delta
        for w in delta:
            self.b.rev.setdefault(w, set()).add(rid)
        # cancel matching negative edges first
        negs = self.neg_edges.get(rid, [])
        cancelled = set()
        for wn in list(negs):
            wbase = self.b.origin[wn]
            if wbase in delta:
                negs.remove(wn)
                cancelled.add(wbase)
        delta -= cancelled
        if not delta:
            return
        if len(delta) > self.threshold:
            # cover the delta with aggregation nodes (best case: reuse one)
            self.b.cover_reader(rid, delta)
        else:
            for w in sorted(delta):
                self.b.inputs[rid].append(self.b.add_writer(w))
            cnt = self.direct_writer_count.get(rid, 0) + len(delta)
            self.direct_writer_count[rid] = cnt
            if cnt > self.threshold:
                self._restructure_direct_edges(rid)
                self.direct_writer_count[rid] = 0

    def _restructure_direct_edges(self, rid: int) -> None:
        """Re-cover the reader's direct writer edges through IOB (§3.3)."""
        direct = [d for d in self.b.inputs[rid] if self.b.kinds[d] == "W"]
        if len(direct) < 2:
            return
        keep = [d for d in self.b.inputs[rid] if self.b.kinds[d] != "W"]
        self.b.inputs[rid] = keep
        self._dirty.add(rid)
        self.b.cover_reader(rid, {self.b.origin[d] for d in direct})

    def add_edge(self, u: int, v: int, affected: dict[int, set[int]] | None = None) -> None:
        """Data-graph edge u -> v added. For 1-hop in-neighborhoods the affected
        reader is v with delta {u}; callers with other N() pass ``affected``
        explicitly as {reader: delta_writers}."""
        affected = affected if affected is not None else {v: {u}}
        for r, delta in affected.items():
            self.add_reader_inputs(r, delta)

    def add_node(self, u: int, in_neighbors: set[int], out_readers: set[int]) -> None:
        """New base node u: a writer feeding ``out_readers`` and a reader over
        ``in_neighbors`` (§3.3)."""
        self.b.add_writer(u)
        for r in out_readers:
            self.add_reader_inputs(r, {u})
        if in_neighbors:
            self.add_reader_inputs(u, set(in_neighbors))

    # ------------------------------------------------------------ deletions
    def remove_reader_inputs(self, r: int, delta: set[int]) -> None:
        delta = set(delta) & self.reader_inputs.get(r, set())
        if not delta:
            return
        rid = self.reader_node[r]
        self._dirty.add(rid)
        self._touched_readers.add(r)
        self.reader_inputs[r] -= delta
        self.b.members[rid] -= delta
        for w in delta:
            self.b.rev.get(w, set()).discard(rid)
        if self.neg_edges.get(rid):
            # negative edges pair with specific positive paths; untangling them
            # under deletion is not worth the bookkeeping — rebuild this reader.
            self.b.inputs[rid] = []
            self.neg_edges.pop(rid, None)
            self.b.cover_reader(rid, set(self.reader_inputs[r]))
            return
        affected = [d for d in self.b.inputs[rid] if self.b.members[d] & delta]
        if len(affected) <= self.split_limit:
            new_inputs = [d for d in self.b.inputs[rid] if d not in set(affected)]
            for d in affected:
                useful = (self.b.members[d] - delta) & self.reader_inputs[r]
                if not useful:
                    continue
                if self.b.kinds[d] == "W":
                    continue  # direct writer edge to a deleted member: just drop
                sub = self.b._split(d, useful)
                if sub is not None:
                    new_inputs.append(sub)
                    useful -= self.b.members[sub]
                if useful:
                    self.b.inputs[rid] = new_inputs
                    self.b.cover_reader(rid, useful)
                    new_inputs = self.b.inputs[rid]
            self.b.inputs[rid] = new_inputs
        else:
            # heavy change: drop all inputs and re-insert via IOB
            self.b.inputs[rid] = []
            self.neg_edges.pop(rid, None)
            self.b.cover_reader(rid, set(self.reader_inputs[r]))

    def delete_edge(self, u: int, v: int, affected: dict[int, set[int]] | None = None) -> None:
        affected = affected if affected is not None else {v: {u}}
        for r, delta in affected.items():
            if r in self.reader_node:
                self.remove_reader_inputs(r, delta)

    def delete_node(self, u: int) -> None:
        """Remove u_w and u_r and all incident edges (§3.3)."""
        b = self.b
        wid = b.writer_node.pop(u, None)
        if wid is not None:
            self._retired_writers.add(u)
            consumers = [n for n in range(len(b.kinds)) if wid in b.inputs[n]]
            for n in consumers:
                b.inputs[n] = [d for d in b.inputs[n] if d != wid]
                self._dirty.add(n)
            # u leaves every I-set and every reader's tracked input set
            for n in b.rev.get(u, set()).copy():
                b.members[n].discard(u)
                if b.kinds[n] == "R":
                    self.reader_inputs.get(b.origin[n], set()).discard(u)
                    self._touched_readers.add(b.origin[n])
                    self._dirty.add(n)  # may demote to 'I' if now empty
            b.rev.pop(u, None)
            for rid_neg, negs in self.neg_edges.items():
                while wid in negs:
                    negs.remove(wid)
                    self._dirty.add(rid_neg)
        rid = self.reader_node.pop(u, None)
        if rid is not None:
            self._retired_readers.add(u)
            self._touched_readers.add(u)
            b.inputs[rid] = []
            self._dirty.add(rid)
            self.neg_edges.pop(rid, None)
            self.reader_inputs.pop(u, None)
            for w in list(b.members[rid]):
                b.rev.get(w, set()).discard(rid)
            b.members[rid] = set()

    # ------------------------------------------------------------ delta log
    def _effective_kind(self, nid: int) -> str:
        """Node kind as exported: emptied/superseded readers demote to 'I'."""
        kind = self.b.kinds[nid]
        if kind == "R" and (
            self.reader_node.get(self.b.origin[nid]) != nid
            or not self.reader_inputs.get(self.b.origin[nid])
        ):
            return "I"
        return kind

    def _node_edges(self, nid: int) -> tuple[tuple[int, int], ...]:
        edges = [(s, 1) for s in self.b.inputs[nid]]
        edges += [(wn, -1) for wn in self.neg_edges.get(nid, [])]
        return tuple(edges)

    @property
    def pending_nodes(self) -> int:
        """Journal size: overlay nodes the next :meth:`drain_delta` will
        snapshot (dirtied existing nodes plus nodes born this burst)."""
        return len(set(self._dirty)
                   | set(range(self._delta_base, len(self.b.kinds))))

    def drain_delta(self) -> OverlayDelta:
        """Return the structured mutation log since the last drain (or since
        construction) and reset it. Feed the result to
        ``EagrEngine.apply_delta`` / ``plan_patch.patch_plan`` to patch a live
        plan instead of recompiling; ``to_overlay()`` remains the
        full-rebuild path."""
        b = self.b
        dirty = set(self._dirty) | set(range(self._delta_base, len(b.kinds)))
        nodes = {nid: NodePatch(self._effective_kind(nid), b.origin[nid],
                                self._node_edges(nid))
                 for nid in sorted(dirty)}
        new_writers = {b.origin[nid]: nid
                       for nid in range(self._delta_base, len(b.kinds))
                       if b.kinds[nid] == "W"
                       and b.writer_node.get(b.origin[nid]) == nid}
        new_readers = {b.origin[nid]: nid
                       for nid in range(self._delta_base, len(b.kinds))
                       if b.kinds[nid] == "R"
                       and self.reader_node.get(b.origin[nid]) == nid}
        delta = OverlayDelta(
            nodes=nodes,
            n_nodes_before=self._delta_base,
            n_nodes_after=len(b.kinds),
            new_writer_nodes=[nid for nid in range(self._delta_base, len(b.kinds))
                              if b.kinds[nid] == "W"],
            new_writers=new_writers,
            new_readers=new_readers,
            retired_writers=set(self._retired_writers),
            retired_readers=set(self._retired_readers),
            touched_readers=set(self._touched_readers),
        )
        self._dirty.clear()
        self._delta_base = len(b.kinds)
        self._retired_writers.clear()
        self._retired_readers.clear()
        self._touched_readers.clear()
        return delta

    # ------------------------------------------------------------ export
    def to_overlay(self, prune: bool = True) -> Overlay:
        """Full-rebuild export. ``prune=False`` keeps builder node ids stable
        (dead nodes linger edgeless) — the id space the patch path lives in,
        so a plan compiled from the unpruned export can later be patched by
        ``drain_delta`` deltas."""
        ov = Overlay(kinds=list(self.b.kinds), origin=list(self.b.origin),
                     in_edges=[[(s, 1) for s in ins] for ins in self.b.inputs],
                     dup_insensitive=self.dup_insensitive)
        for rid, negs in self.neg_edges.items():
            for wn in negs:
                ov.in_edges[rid].append((wn, -1))
        # deleted/superseded/emptied reader nodes linger: only the current node
        # for each base reader with a non-empty neighborhood keeps the 'R' label
        for v in range(ov.n_nodes):
            if ov.kinds[v] == "R" and (
                self.reader_node.get(ov.origin[v]) != v
                or not self.reader_inputs.get(ov.origin[v])
            ):
                ov.kinds[v] = "I"
        return ov.pruned() if prune else ov
