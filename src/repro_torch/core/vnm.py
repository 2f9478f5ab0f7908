"""VNM-family overlay construction (paper §3.2.2–§3.2.4).

All four variants share one loop: shingle-order the readers, chunk them into
groups, FP-tree-mine each group for positive-benefit bicliques, replace each
biclique with a virtual (partial aggregation) node, and iterate on the rewritten
bipartite graph until no more benefit is found.

  vnm    — fixed chunk size (Buehrer & Chellapilla's algorithm, the baseline)
  vnm_a  — adaptive chunk-size schedule (§3.2.2)
  vnm_n  — negative / subtraction edges, quasi-bicliques (§3.2.3)
  vnm_d  — duplicate-insensitive overlays, overlapping groups + edge reuse (§3.2.4)

Two interchangeable engines drive the group mining:

  * the *vectorized* engine (default): per-reader item lists live in flat
    arrays, groups are mined by ``core.rowminer`` (rank-sorted rows, one
    lexicographic sort + LCP scan per round instead of a Python object tree),
    and the overlay is assembled from flat edge arrays. 'neg' mode keeps the
    object tree (per-reader path picking is sequential by nature) but still
    maintains it incrementally instead of rebuilding it per biclique.
  * the *reference* engine (``EAGR_CONSTRUCT_REFERENCE=1`` or
    ``reference=True``): the original object pipeline, kept as the parity
    oracle. Both engines implement identical semantics — frozen per-group item
    order, incremental detach/reinsert, canonical tie-breaks — and must
    produce bit-identical overlays (see tests/test_construct_vectorized.py).

Groups within an iteration share no state (for the non-overlapping variants),
so they could be fanned out to a process pool; the batched single-process loop
is used here because the group work is already array code and the dev/CI boxes
are single-core.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from repro_torch.core.bipartite import Bipartite
from repro_torch.core.fptree import FPTree, ReaderRecord
from repro_torch.core.overlay import Overlay, overlay_from_flat
from repro_torch.core.rowminer import mine_rows
from repro_torch.core.shingles import shingle_order_csr

PHASES = ("shingle", "chunk", "build", "mine", "apply", "assemble")


@dataclasses.dataclass
class ConstructionStats:
    algorithm: str
    iterations: int = 0
    bicliques: int = 0
    seconds: float = 0.0
    si_per_iteration: list[float] = dataclasses.field(default_factory=list)
    chunk_sizes: list[int] = dataclasses.field(default_factory=list)
    # wall-clock per construction phase (shingle/chunk/build/mine/apply/assemble)
    phase_seconds: dict[str, float] = dataclasses.field(default_factory=dict)


# =====================================================================
# shared helpers (both engines)
# =====================================================================

def _chunk(readers: list[int], chunk_size: int, overlap_pct: float) -> list[list[int]]:
    if not readers:
        return []
    step = max(1, int(round(chunk_size * (1.0 - overlap_pct / 100.0))))
    groups = []
    i = 0
    while i < len(readers):
        g = readers[i : i + chunk_size]
        if len(g) >= 2:
            groups.append(g)
        if i + chunk_size >= len(readers):
            break
        i += step
    return groups or [readers]


def _adaptive_next_chunk(benefit_hist: dict[int, int], c_i: int, frac: float = 0.9,
                         c_min: int = 8) -> int:
    """c_{i+1} = smallest c <= c_i with sum_{s<=c} B_s > frac * sum_{s<=c_i} B_s (§3.2.2)."""
    total = sum(b for s, b in benefit_hist.items() if s <= c_i)
    if total <= 0:
        return c_i
    acc = 0
    for c in sorted(benefit_hist.keys()):
        acc += benefit_hist[c]
        if acc > frac * total:
            return max(c_min, min(c, c_i))
    return c_i


def _shingle_order_of(lists: dict[int, np.ndarray], seed: int) -> list[int]:
    """Batched shingle ordering over a CSR view of the eligible readers."""
    rids = np.fromiter(lists.keys(), dtype=np.int64, count=len(lists))
    sizes = np.fromiter((lists[int(r)].size for r in rids), dtype=np.int64,
                        count=rids.size)
    indptr = np.zeros(rids.size + 1, dtype=np.int64)
    np.cumsum(sizes, out=indptr[1:])
    values = (np.concatenate([lists[int(r)] for r in rids]) if rids.size
              else np.zeros(0, dtype=np.int64))
    return [int(r) for r in shingle_order_csr(rids, indptr, values, seed=seed)]


# =====================================================================
# reference engine (object records + incremental FP-tree)
# =====================================================================

@dataclasses.dataclass
class _State:
    records: dict[int, ReaderRecord]
    virtual_members: dict[int, list[tuple[int, int]]]  # virtual item -> [(item, +1)]
    next_item: int
    n_active_edges: int = 0
    n_frozen_edges: int = 0
    n_virtual_edges: int = 0

    def current_edges(self) -> int:
        return self.n_active_edges + self.n_frozen_edges + self.n_virtual_edges


def _init_state(bip: Bipartite) -> _State:
    records = {
        r: ReaderRecord(reader=r, active=set(map(int, ins)), frozen=[], mined=set())
        for r, ins in bip.reader_inputs.items()
    }
    return _State(records=records, virtual_members={}, next_item=bip.n_base,
                  n_active_edges=sum(len(rec.active) for rec in records.values()))


def _apply_biclique(state: _State, bic, mode: str):
    """Replace the mined biclique with a virtual node. Returns the consumer
    records and the virtual item id, or ``([], None)`` when fewer than two
    readers would actually benefit (readers whose individual edge saving
    would be negative — possible with negative edges — are left untouched)."""
    items = set(bic.items)
    plan: list[tuple[ReaderRecord, set[int], list[int]]] = []
    for r in bic.readers:
        rec = state.records[r]
        covered = items & rec.active
        # Negatives for items the reader still held directly are duplicate-
        # compensation markers: this biclique covers them, so no subtraction
        # edge is needed; the rest are true subtraction edges.
        true_negs = [it for it in bic.neg_items.get(r, []) if it not in covered]
        if len(covered) - 1 - len(true_negs) < 0:
            continue  # this reader would lose edges; keep its direct edges
        plan.append((rec, covered, true_negs))
    if len(plan) < 2:
        return [], None
    vid = state.next_item
    state.next_item += 1
    state.virtual_members[vid] = [(it, 1) for it in bic.items]
    state.n_virtual_edges += len(bic.items)
    for rec, covered, true_negs in plan:
        rec.active -= covered
        if mode == "dup":
            rec.mined |= covered
        for it in true_negs:
            rec.frozen.append((it, -1))
        rec.active.add(vid)
        state.n_active_edges += 1 - len(covered)
        state.n_frozen_edges += len(true_negs)
    return [rec for rec, _, _ in plan], vid


def _mine_group_ref(state: _State, group: list[ReaderRecord], mode: str, k1: int,
                    k2: int, benefit_hist: dict[int, int],
                    phase: dict[str, float], max_bicliques: int = 64) -> int:
    t = time.perf_counter()
    tree = FPTree(mode=mode, k1=k1, k2=k2)
    tree.build(group)
    phase["build"] += time.perf_counter() - t
    found = 0
    while found < max_bicliques:
        t = time.perf_counter()
        bic = tree.mine_best()
        phase["mine"] += time.perf_counter() - t
        if bic is None:
            break
        t = time.perf_counter()
        touched, vid = _apply_biclique(state, bic, mode)
        if vid is None:
            phase["apply"] += time.perf_counter() - t
            break  # nothing changed; mining again would re-find the same biclique
        tree.register_item(vid)
        for rec in touched:
            tree.detach(rec)
        for rec in touched:
            tree.reinsert(rec)
        phase["apply"] += time.perf_counter() - t
        benefit_hist[len(bic.readers)] = benefit_hist.get(len(bic.readers), 0) + bic.benefit
        found += 1
    return found


def _assemble(state: _State, bip: Bipartite, dup_insensitive: bool) -> Overlay:
    ov = Overlay(kinds=[], origin=[], in_edges=[], dup_insensitive=dup_insensitive)
    item_to_node: dict[int, int] = {}
    for w in bip.writers:
        item_to_node[int(w)] = ov.add_node("W", int(w))
    # virtual items were created in increasing id order; members only reference
    # earlier items, so a single ordered pass suffices.
    for vid in sorted(state.virtual_members.keys()):
        node = ov.add_node("I", -1)
        item_to_node[vid] = node
        for it, sign in state.virtual_members[vid]:
            ov.add_edge(item_to_node[it], node, sign)
    for r, rec in state.records.items():
        node = ov.add_node("R", int(r))
        for it in sorted(rec.active):
            ov.add_edge(item_to_node[it], node, 1)
        for it, sign in rec.frozen:
            ov.add_edge(item_to_node[it], node, sign)
    return ov


def _construct_ref(bip: Bipartite, variant: str, mode: str, chunk_size: int,
                   max_iterations: int, k1: int, k2: int, overlap: float,
                   adapt_frac: float, seed: int,
                   stats: ConstructionStats) -> Overlay:
    state = _init_state(bip)
    base_edges = bip.n_edges
    phase = stats.phase_seconds
    c = chunk_size
    for it in range(max_iterations):
        t = time.perf_counter()
        active_lists = {
            r: np.array(sorted(rec.active), dtype=np.int64)
            for r, rec in state.records.items()
            if len(rec.active) >= 2
        }
        if not active_lists:
            break
        order = _shingle_order_of(active_lists, seed + it)
        phase["shingle"] += time.perf_counter() - t
        t = time.perf_counter()
        groups = _chunk(order, c, overlap)
        phase["chunk"] += time.perf_counter() - t
        benefit_hist: dict[int, int] = {}
        found = 0
        for g in groups:
            group_records = [state.records[r] for r in g]
            found += _mine_group_ref(state, group_records, mode, k1, k2,
                                     benefit_hist, phase)
        stats.iterations += 1
        stats.bicliques += found
        stats.chunk_sizes.append(c)
        stats.si_per_iteration.append(1.0 - state.current_edges() / max(1, base_edges))
        if found == 0:
            break
        if variant in ("vnm_a", "vnm_n", "vnm_d"):
            c = _adaptive_next_chunk(benefit_hist, c, frac=adapt_frac)
    t = time.perf_counter()
    overlay = _assemble(state, bip, dup_insensitive=(variant == "vnm_d")).pruned()
    phase["assemble"] += time.perf_counter() - t
    return overlay


# =====================================================================
# vectorized engine ('basic'/'dup' modes)
# =====================================================================

@dataclasses.dataclass
class _ArrayState:
    active: dict[int, np.ndarray]           # reader -> sorted item ids
    mined: dict[int, np.ndarray]            # 'dup' only; disjoint from active
    virtual_members: dict[int, np.ndarray]  # vid -> item ids in path order
    next_item: int
    n_active_edges: int = 0
    n_virtual_edges: int = 0

    def current_edges(self) -> int:
        return self.n_active_edges + self.n_virtual_edges


_EMPTY = np.zeros(0, dtype=np.int64)


def _init_array_state(bip: Bipartite) -> _ArrayState:
    active = {int(r): np.array(ins, dtype=np.int64)
              for r, ins in bip.reader_inputs.items()}
    return _ArrayState(active=active,
                       mined={r: _EMPTY for r in active},
                       virtual_members={}, next_item=bip.n_base,
                       n_active_edges=sum(a.size for a in active.values()))


def _mine_group_fast(st: _ArrayState, group: list[int], dup: bool,
                     benefit_hist: dict[int, int], phase: dict[str, float],
                     max_bicliques: int = 64) -> int:
    t = time.perf_counter()
    # frozen group item order: rank by (-frequency, item id) over insert lists
    if dup:
        per_reader = [np.concatenate([st.active[r], st.mined[r]]) for r in group]
    else:
        per_reader = [st.active[r] for r in group]
    uniq, counts = np.unique(np.concatenate(per_reader), return_counts=True)
    by_freq = np.argsort(-counts, kind="stable")  # uniq ascending -> ties by id
    rank_of = np.empty(uniq.size, dtype=np.int64)
    rank_of[by_freq] = np.arange(uniq.size)
    item_of = uniq[by_freq]

    rows: list[np.ndarray] = []
    flags: list[np.ndarray] | None = [] if dup else None
    for i, r in enumerate(group):
        ranks = rank_of[np.searchsorted(uniq, per_reader[i])]
        if dup:
            fl = np.zeros(ranks.size, dtype=bool)
            fl[st.active[r].size:] = True
            p = np.argsort(ranks, kind="stable")
            rows.append(ranks[p])
            flags.append(fl[p])
        else:
            rows.append(np.sort(ranks))
    phase["build"] += time.perf_counter() - t

    t = time.perf_counter()
    bics = mine_rows(rows, flags, dup, n_ranks=uniq.size,
                     max_bicliques=max_bicliques)
    phase["mine"] += time.perf_counter() - t

    t = time.perf_counter()
    changed: set[int] = set()
    new_vids = []
    for b in bics:
        new_vids.append(st.next_item)
        st.next_item += 1
        benefit_hist[b.support] = benefit_hist.get(b.support, 0) + b.benefit
        changed.update(int(i) for i in b.consumers)
    item_of_ext = np.concatenate([item_of, np.array(new_vids, dtype=np.int64)]) \
        if new_vids else item_of
    for vid, b in zip(new_vids, bics):
        members = item_of_ext[b.path]
        st.virtual_members[vid] = members
        st.n_virtual_edges += members.size
    for i in changed:
        r = group[i]
        ids = item_of_ext[rows[i]]
        if dup:
            fl = flags[i]
            n_act = int(rows[i].size - fl.sum())
            st.n_active_edges += n_act - st.active[r].size
            st.active[r] = np.sort(ids[~fl])
            st.mined[r] = np.sort(ids[fl])
        else:
            st.n_active_edges += rows[i].size - st.active[r].size
            st.active[r] = np.sort(ids)
    phase["apply"] += time.perf_counter() - t
    return len(bics)


def _assemble_fast(st: _ArrayState, bip: Bipartite, dup_insensitive: bool) -> Overlay:
    """Flat-array assembly + pruning: node order and per-node edge order are
    identical to ``_assemble(...).pruned()``."""
    writers = np.asarray(bip.writers, dtype=np.int64)
    n_w = writers.size
    vids = np.array(sorted(st.virtual_members), dtype=np.int64)
    n_v = vids.size
    readers = np.fromiter(st.active.keys(), dtype=np.int64, count=len(st.active))
    n_r = readers.size
    n_nodes = n_w + n_v + n_r

    def node_of(items: np.ndarray) -> np.ndarray:
        is_w = items < bip.n_base
        out = np.empty(items.size, dtype=np.int64)
        out[is_w] = np.searchsorted(writers, items[is_w])
        out[~is_w] = n_w + np.searchsorted(vids, items[~is_w])
        return out

    member_lists = [st.virtual_members[int(v)] for v in vids]
    active_lists = [st.active[int(r)] for r in readers]
    v_counts = np.array([m.size for m in member_lists], dtype=np.int64)
    r_counts = np.array([a.size for a in active_lists], dtype=np.int64)
    # edges generated grouped by destination node in ascending order, matching
    # the add_edge order of the object assembler
    dst = np.repeat(np.arange(n_nodes, dtype=np.int64)[n_w:],
                    np.concatenate([v_counts, r_counts]))
    src_items = (np.concatenate(member_lists + active_lists)
                 if member_lists or active_lists else _EMPTY)
    src = node_of(src_items)

    kinds = np.concatenate([np.full(n_w, "W"), np.full(n_v, "I"),
                            np.full(n_r, "R")])
    origin = np.concatenate([writers, np.full(n_v, -1, dtype=np.int64), readers])

    # prune: drop W/I nodes with no path to any reader (reverse reachability,
    # one pass per overlay level)
    useful = np.zeros(n_nodes, dtype=bool)
    useful[n_w + n_v:] = True
    while True:
        grow = src[useful[dst] & ~useful[src]]
        if grow.size == 0:
            break
        useful[grow] = True

    remap = np.cumsum(useful) - 1
    keep = useful[dst]  # src of a useful dst is useful by propagation
    src_k = remap[src[keep]].tolist()
    dst_k = remap[dst[keep]]
    n_new = int(useful.sum())
    counts = np.bincount(dst_k, minlength=n_new)
    indptr = np.zeros(n_new + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return overlay_from_flat(
        kinds=kinds[useful].tolist(),
        origin=origin[useful].tolist(),
        src=src_k,
        signs=None,  # 'basic'/'dup' never emit negative edges
        indptr=indptr,
        dup_insensitive=dup_insensitive,
    )


def _construct_fast(bip: Bipartite, variant: str, mode: str, chunk_size: int,
                    max_iterations: int, overlap: float, adapt_frac: float,
                    seed: int, stats: ConstructionStats) -> Overlay:
    dup = mode == "dup"
    st = _init_array_state(bip)
    base_edges = bip.n_edges
    phase = stats.phase_seconds
    c = chunk_size
    for it in range(max_iterations):
        t = time.perf_counter()
        active_lists = {r: a for r, a in st.active.items() if a.size >= 2}
        if not active_lists:
            break
        order = _shingle_order_of(active_lists, seed + it)
        phase["shingle"] += time.perf_counter() - t
        t = time.perf_counter()
        groups = _chunk(order, c, overlap)
        phase["chunk"] += time.perf_counter() - t
        benefit_hist: dict[int, int] = {}
        found = 0
        for g in groups:
            found += _mine_group_fast(st, g, dup, benefit_hist, phase)
        stats.iterations += 1
        stats.bicliques += found
        stats.chunk_sizes.append(c)
        stats.si_per_iteration.append(1.0 - st.current_edges() / max(1, base_edges))
        if found == 0:
            break
        if variant in ("vnm_a", "vnm_n", "vnm_d"):
            c = _adaptive_next_chunk(benefit_hist, c, frac=adapt_frac)
    t = time.perf_counter()
    overlay = _assemble_fast(st, bip, dup_insensitive=(variant == "vnm_d"))
    phase["assemble"] += time.perf_counter() - t
    return overlay


# =====================================================================
# front door
# =====================================================================

def construct_vnm(
    bip: Bipartite,
    *,
    variant: str = "vnm_a",
    chunk_size: int = 100,
    max_iterations: int = 10,
    k1: int = 2,
    k2: int = 5,
    overlap_pct: float = 25.0,
    adapt_frac: float = 0.9,
    seed: int = 0,
    reference: bool | None = None,
) -> tuple[Overlay, ConstructionStats]:
    """Construct a VNM-family overlay.

    ``reference=True`` (or ``EAGR_CONSTRUCT_REFERENCE=1``) forces the original
    object-based pipeline; the default vectorized engine produces a
    bit-identical overlay. 'neg' mode always runs on the (incrementally
    maintained) object tree — see the module docstring.
    """
    assert variant in ("vnm", "vnm_a", "vnm_n", "vnm_d")
    if reference is None:
        reference = os.environ.get("EAGR_CONSTRUCT_REFERENCE", "") not in ("", "0")
    mode = {"vnm": "basic", "vnm_a": "basic", "vnm_n": "neg", "vnm_d": "dup"}[variant]
    overlap = overlap_pct if variant == "vnm_d" else 0.0
    stats = ConstructionStats(algorithm=variant,
                              phase_seconds={p: 0.0 for p in PHASES})
    t0 = time.perf_counter()
    if reference or mode == "neg":
        overlay = _construct_ref(bip, variant, mode, chunk_size, max_iterations,
                                 k1, k2, overlap, adapt_frac, seed, stats)
    else:
        overlay = _construct_fast(bip, variant, mode, chunk_size, max_iterations,
                                  overlap, adapt_frac, seed, stats)
    stats.seconds = time.perf_counter() - t0
    return overlay, stats
