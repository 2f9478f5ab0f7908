"""FP-Tree construction and biclique mining (paper §3.2.1–§3.2.4).

Items are generic integer ids: base writers or virtual (partial-aggregation)
nodes — virtual items from earlier iterations participate in later trees, which
is how multi-level overlays arise.

Modes:
  'basic' — plain VNM FP-tree (one path per reader),
  'neg'   — VNM_N: readers may be added along up to k1 paths, introducing up to
            k2 negative entries per path (quasi-bicliques, §3.2.3),
  'dup'   — VNM_D: previously-mined (item, reader) edges may be reused; reuse is
            penalized in the benefit (§3.2.4). Duplicate-insensitive aggregates only.

The tree is maintained *incrementally* across the bicliques of one mining
group: the item order is frozen when the group is built (newly created virtual
items are appended at the end via ``register_item``), and after a biclique is
applied only its consumer readers are ``detach``ed and ``reinsert``ed with
their shrunk lists.  For 'basic'/'dup' the trie is insertion-order independent,
so this is exactly equivalent to a full rebuild under the frozen order — which
is what the vectorized row miner (``core.rowminer``) computes in array form.

Tie-breaks are canonical so independent implementations agree bit-for-bit:
``mine_best`` maximizes benefit and resolves ties toward the lexicographically
smallest rank sequence; the 'neg' path-candidate scan orders by
(-gain, rank sequence).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable


@dataclasses.dataclass
class ReaderRecord:
    reader: int
    active: set[int]                      # minable positive items
    frozen: list[tuple[int, int]]         # (item, sign) direct edges, never re-mined
    mined: set[int]                       # 'dup' mode: items covered by an earlier biclique


@dataclasses.dataclass
class Biclique:
    items: list[int]                      # the path P (virtual node inputs)
    readers: list[int]
    neg_items: dict[int, list[int]]       # reader -> items of P to subtract
    reused: dict[int, list[int]]          # reader -> items of P that were already mined
    benefit: int


class _Node:
    __slots__ = ("item", "parent", "children", "support", "neg", "mined", "depth")

    def __init__(self, item: int, parent: "_Node | None"):
        self.item = item
        self.parent = parent
        self.children: dict[int, _Node] = {}
        self.support: set[int] = set()
        self.neg: set[int] = set()     # readers with a negative entry AT this node
        self.mined: set[int] = set()   # readers whose (item->reader) edge is reused
        self.depth = 0 if parent is None else parent.depth + 1

    def path_items(self) -> list[int]:
        out = []
        n: _Node | None = self
        while n is not None and n.parent is not None:
            out.append(n.item)
            n = n.parent
        out.reverse()
        return out


def item_order(records: Iterable[ReaderRecord], mode: str = "basic") -> dict[int, int]:
    """Descending frequency of occurrence across reader insert lists (ties by
    id). In 'dup' mode mined items are inserted too, so they count as well.

    NOTE: paper §3.2.1 says "increasing order" but its own worked example is not
    monotone under that reading; descending frequency (the standard FP-tree
    ordering, which maximizes prefix sharing) is used here.
    """
    freq: dict[int, int] = {}
    for rec in records:
        items = rec.active | rec.mined if mode == "dup" else rec.active
        for it in items:
            freq[it] = freq.get(it, 0) + 1
    order = sorted(freq.keys(), key=lambda it: (-freq[it], it))
    return {it: i for i, it in enumerate(order)}


class FPTree:
    def __init__(self, mode: str = "basic", k1: int = 2, k2: int = 5):
        assert mode in ("basic", "neg", "dup")
        self.mode = mode
        self.k1 = k1
        self.k2 = k2
        self.root = _Node(-1, None)
        self.order: dict[int, int] = {}
        # reader -> deepest node of each chain its insertion touched
        self._chains: dict[int, list[_Node]] = {}

    # ---------------------------------------------------------------- build
    def build(self, records: list[ReaderRecord]) -> None:
        self.root = _Node(-1, None)
        self.order = item_order(records, self.mode)
        self._chains = {}
        for rec in records:
            self._insert(rec)

    def register_item(self, item: int) -> None:
        """Append a newly created virtual item at the end of the frozen order."""
        self.order[item] = len(self.order)

    def _rank_path(self, node: _Node) -> tuple[int, ...]:
        return tuple(self.order.get(it, 1 << 60) for it in node.path_items())

    def _sorted_items(self, items: set[int]) -> list[int]:
        return sorted(items, key=lambda it: self.order.get(it, 1 << 60))

    def _insert_along(self, items: list[int], rec: ReaderRecord) -> None:
        node = self.root
        for it in items:
            child = node.children.get(it)
            if child is None:
                child = _Node(it, node)
                node.children[it] = child
            child.support.add(rec.reader)
            if self.mode == "dup" and it in rec.mined:
                child.mined.add(rec.reader)
            node = child
        if node is not self.root:
            self._chains.setdefault(rec.reader, []).append(node)

    def _insert(self, rec: ReaderRecord) -> None:
        if self.mode == "dup":
            items = self._sorted_items(rec.active | rec.mined)
            self._insert_along(items, rec)
            return
        if self.mode == "basic":
            self._insert_along(self._sorted_items(rec.active), rec)
            return
        # mode == 'neg': pick up to k1 existing paths with positive gain, then
        # insert the leftover items as a standard branch.
        candidates: list[tuple[int, tuple[int, ...], _Node, set[int]]] = []
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            p_items = set(n.path_items())
            neg = p_items - rec.active
            if len(neg) > self.k2:
                continue  # prune: negatives only grow deeper
            gain = n.depth - 1 - len(neg)
            covered = p_items & rec.active
            if gain > 0 and covered:
                candidates.append((gain, self._rank_path(n), n, p_items))
            stack.extend(n.children.values())
        candidates.sort(key=lambda t: (-t[0], t[1]))

        covered_total: set[int] = set()
        picked = 0
        for _, _, node, p_items in candidates:
            if picked >= self.k1:
                break
            remaining = rec.active - covered_total
            newly = p_items & remaining
            if not newly:
                continue
            # anything on the path not in the *remaining* set must be subtracted
            neg_eff = p_items - remaining
            if len(neg_eff) > self.k2 or node.depth - 1 - len(neg_eff) <= 0:
                continue
            n: _Node | None = node
            while n is not None and n.parent is not None:
                n.support.add(rec.reader)
                if n.item in neg_eff:
                    n.neg.add(rec.reader)
                n = n.parent
            self._chains.setdefault(rec.reader, []).append(node)
            covered_total |= newly
            picked += 1
        leftover = rec.active - covered_total
        if leftover:
            self._insert_along(self._sorted_items(leftover), rec)

    # ------------------------------------------------------------ maintenance
    def detach(self, rec: ReaderRecord) -> None:
        """Remove a reader from every chain it supports, pruning nodes whose
        support empties (child support is a subset of its parent's, so an
        emptied node has no supported descendants)."""
        for node in self._chains.pop(rec.reader, []):
            n: _Node | None = node
            while n is not None and n.parent is not None:
                n.support.discard(rec.reader)
                n.neg.discard(rec.reader)
                n.mined.discard(rec.reader)
                if not n.support and n.parent.children.get(n.item) is n:
                    del n.parent.children[n.item]
                n = n.parent

    def reinsert(self, rec: ReaderRecord) -> None:
        self._insert(rec)

    # ---------------------------------------------------------------- mine
    def _all_nodes(self) -> list[_Node]:
        out: list[_Node] = []
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(n.children.values())
        return out

    def mine_best(self) -> Biclique | None:
        """Find the path maximizing
        benefit(P) = L|S| - L - |S| - #neg(P,S) - #reused(P,S)  (paper §3.2.1/3/4);
        ties resolve toward the lexicographically smallest rank sequence."""
        best: tuple[int, tuple[int, ...], _Node] | None = None
        for n in self._all_nodes():
            S = n.support
            if len(S) < 2 or n.depth < 2:
                continue  # benefit of a depth-1 path is always negative
            L = n.depth
            negs = 0
            reused = 0
            m: _Node | None = n
            while m is not None and m.parent is not None:
                if m.neg:
                    negs += len(m.neg & S)
                if m.mined:
                    reused += len(m.mined & S)
                m = m.parent
            benefit = L * len(S) - L - len(S) - negs - reused
            if benefit <= 0 or (best is not None and benefit < best[0]):
                continue
            rp = self._rank_path(n)
            if best is None or benefit > best[0] or rp < best[1]:
                best = (benefit, rp, n)
        if best is None:
            return None
        benefit, _, node = best
        S = sorted(node.support)
        items = node.path_items()
        neg_items: dict[int, list[int]] = {}
        reused_items: dict[int, list[int]] = {}
        m: _Node | None = node
        while m is not None and m.parent is not None:
            for r in m.neg & node.support:
                neg_items.setdefault(r, []).append(m.item)
            for r in m.mined & node.support:
                reused_items.setdefault(r, []).append(m.item)
            m = m.parent
        return Biclique(items=items, readers=S, neg_items=neg_items, reused=reused_items, benefit=benefit)
