"""IOB — Incremental Overlay Building (paper §3.2.5).

Readers are added one at a time (shingle order). For each reader we greedily
cover its input list with the partial aggregates already in the overlay
(minimum exact set cover heuristic), restructuring the overlay — splitting an
existing node v1 into (v1' -> v1) — when only part of v1's aggregate is useful.

Maintains the paper's two indexes:
  reverse index: writer -> overlay nodes whose I() contains it,
  forward index: node -> direct input nodes.

Restructuring note (documented deviation): the paper reroutes *writers* in
A∩I(v1) from v1 to v1'. When v1's inputs are nested aggregates this is not
well-defined at writer granularity, so we reroute at the granularity of v1's
*direct inputs whose I-sets lie fully inside A* — identical behavior whenever
v1's inputs are raw writers (the common case, incl. the paper's Fig 4 example),
and always correctness-preserving.
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter

import numpy as np

from repro_torch.core.bipartite import Bipartite
from repro_torch.core.overlay import Overlay
from repro_torch.core.shingles import shingle_order
from repro_torch.core.vnm import ConstructionStats


class IOBBuilder:
    def __init__(self) -> None:
        self.kinds: list[str] = []
        self.origin: list[int] = []
        self.inputs: list[list[int]] = []    # forward index (direct inputs)
        self.members: list[set[int]] = []    # I(ovl): base writers aggregated
        self.rev: dict[int, set[int]] = {}   # reverse index
        self.writer_node: dict[int, int] = {}
        # Optional mutation journal: when set (by DynamicOverlay), every node
        # whose input list changes is recorded so structural churn can be
        # turned into an OverlayDelta instead of a full rebuild (§3.3).
        self.journal: set[int] | None = None

    # ---------------------------------------------------------------- nodes
    def add_node(self, kind: str, origin: int, members: set[int]) -> int:
        nid = len(self.kinds)
        self.kinds.append(kind)
        self.origin.append(origin)
        self.inputs.append([])
        self.members.append(members)
        for w in members:
            self.rev.setdefault(w, set()).add(nid)
        if self.journal is not None:
            self.journal.add(nid)
        return nid

    def add_writer(self, w: int) -> int:
        if w in self.writer_node:
            return self.writer_node[w]
        nid = self.add_node("W", w, {w})
        self.writer_node[w] = nid
        return nid

    def set_inputs(self, node: int, new_inputs: list[int]) -> None:
        self.inputs[node] = list(new_inputs)
        if self.journal is not None:
            self.journal.add(node)

    # ---------------------------------------------------------------- cover
    def _best_candidate(self, A: set[int], exclude: set[int]) -> int | None:
        score: Counter[int] = Counter()
        for w in A:
            for n in self.rev.get(w, ()):
                if n not in exclude:
                    score[n] += 1
        best = None
        best_key = None
        for n, s in score.items():
            if s < 2:
                continue
            key = (s, -len(self.members[n]))  # max overlap, then tightest I-set
            if best_key is None or key > best_key:
                best, best_key = n, key
        return best

    def _split(self, v1: int, A: set[int]) -> int | None:
        """Create v1' from v1's direct inputs whose I-sets lie inside A.
        Returns v1' (or None if no beneficial split exists)."""
        reroutable = [d for d in self.inputs[v1] if self.members[d] <= A]
        if len(reroutable) < 2:
            return None
        cov: set[int] = set()
        for d in reroutable:
            cov |= self.members[d]
        if len(cov) < 2:
            return None
        v1p = self.add_node("I", -1, cov)
        self.set_inputs(v1p, reroutable)
        remaining = [d for d in self.inputs[v1] if d not in set(reroutable)]
        self.set_inputs(v1, remaining + [v1p])
        return v1p

    def cover_reader(self, target: int, A: set[int], exclude: set[int] | None = None) -> list[int]:
        """Greedy exact-set-cover of A; returns the list of covering node ids and
        wires them as direct inputs of ``target``."""
        A = set(A)
        chosen: list[int] = []
        exclude = set(exclude or ())
        exclude.add(target)
        while A:
            cand = self._best_candidate(A, exclude)
            if cand is None:
                for w in sorted(A):
                    chosen.append(self.add_writer(w))
                A.clear()
                break
            B = self.members[cand]
            if B <= A and self.kinds[cand] != "R":
                chosen.append(cand)
                A -= B
            else:
                # partial overlap, or candidate is a reader (cannot feed anyone):
                # split out the useful part as a new shared aggregate node.
                v1p = self._split(cand, A)
                if v1p is None:
                    exclude.add(cand)
                    continue
                chosen.append(v1p)
                A -= self.members[v1p]
        self.set_inputs(target, self.inputs[target] + chosen)
        return chosen

    # ---------------------------------------------------------------- revisit
    def descendants(self, node: int) -> set[int]:
        out: dict[int, list[int]] = {}
        for n, ins in enumerate(self.inputs):
            for s in ins:
                out.setdefault(s, []).append(n)
        seen = {node}
        stack = [node]
        while stack:
            v = stack.pop()
            for d in out.get(v, ()):
                if d not in seen:
                    seen.add(d)
                    stack.append(d)
        return seen

    def revisit(self) -> int:
        """One improvement pass: re-cover each intermediate node's I-set with the
        (now larger) overlay; keep the new cover if it uses fewer edges."""
        improved = 0
        for n in range(len(self.kinds)):
            if self.kinds[n] != "I":
                continue
            old_inputs = self.inputs[n]
            if len(old_inputs) <= 2:
                continue
            exclude = self.descendants(n)
            exclude |= {m for m in range(len(self.kinds)) if self.kinds[m] == "R"}
            self.inputs[n] = []
            self.cover_reader(n, self.members[n], exclude=exclude)
            if len(self.inputs[n]) >= len(old_inputs):
                self.inputs[n] = old_inputs
            else:
                improved += 1
        return improved

    # ---------------------------------------------------------------- export
    def n_edges(self) -> int:
        return sum(len(i) for i in self.inputs)

    def to_overlay(self) -> Overlay:
        ov = Overlay(kinds=list(self.kinds), origin=list(self.origin),
                     in_edges=[[(s, 1) for s in ins] for ins in self.inputs])
        return ov


def construct_iob(
    bip: Bipartite,
    *,
    max_iterations: int = 3,
    seed: int = 0,
) -> tuple[Overlay, ConstructionStats]:
    stats = ConstructionStats(algorithm="iob")
    t0 = time.perf_counter()
    b = IOBBuilder()
    for w in bip.writers:
        b.add_writer(int(w))
    lists = {r: np.asarray(ins) for r, ins in bip.reader_inputs.items()}
    order = shingle_order(lists, seed=seed)
    for r in order:
        rid = b.add_node("R", int(r), set(map(int, bip.reader_inputs[r])))
        b.cover_reader(rid, set(map(int, bip.reader_inputs[r])))
    stats.iterations = 1
    stats.si_per_iteration.append(1.0 - b.n_edges() / max(1, bip.n_edges))
    for _ in range(max_iterations - 1):
        if b.revisit() == 0:
            break
        stats.iterations += 1
        stats.si_per_iteration.append(1.0 - b.n_edges() / max(1, bip.n_edges))
    stats.seconds = time.perf_counter() - t0
    stats.bicliques = sum(1 for k in b.kinds if k == "I")
    return b.to_overlay().pruned(), stats
