"""Frontier indices: per-writer reachable push blocks, per-reader demand
chunks — the host side of frontier-sparse steps (paper §3). Host numpy, the
same index as the JAX package's, over the port's own block size.

The dense write step sweeps every padded push block of every level per batch
(O(overlay nodes) regardless of batch size). The paper's premise is that an
update only traverses the overlay subgraph reachable from the updated node;
this module compiles that reachability into a *block-granular* index so a
batch can be expanded — entirely host-side, before dispatch — into the
per-level set of E_BLK edge blocks the device step actually needs:

  ``FrontierIndex``        writer row -> per level, the push blocks holding
                           any in-edge of any push node reachable from that
                           writer (its *closure*).
  ``ReaderFrontierIndex``  reader node -> the demand chunks + pull blocks its
                           demand down-set touches (the read-path twin).

Why this is exact (bit-identical to the dense sweep, not approximate): the
sum path propagates a delta that is zero outside the batch closure, so any
edge whose source carries a nonzero delta lies in an indexed block of some
batch writer (an omitted edge contributes ``sign * (+0.0)``, and a zero
delta is always ``+0.0``: scatter-add and cancellation both round to
positive zero, so omission never even flips a zero's sign); the extremal
path only overwrites destinations with a changed in-edge, and every in-edge
of every closure member is indexed. Extra blocks that ride along (block
sharing between neighbouring destinations, post-churn over-approximation)
are harmless for the same reason — a *superset* of the required blocks
computes identical state. ``verify`` checks exactly that superset invariant
against an independent per-writer graph walk.

Two flavors, matched to the two write bodies (``build(exact=...)``):

  exact=True   (sum) per-writer **source-exact** block entries: only blocks
               holding slots whose source is in the writer's closure. The
               delta-incremental sum never needs an untouched source's
               edges, and on power-law graphs this keeps a hub destination
               reached through one edge from dragging its whole (huge) slot
               span into every batch.
  exact=False  (extremal) per-writer **destination-span** ranges: a changed
               extremal row recomputes from *all* of its inputs — including
               edges from sources the batch never touched, whose PAOs are
               live values, not zeros — so each reached destination
               contributes its full (lo, hi) block range (slots are
               contiguous at build time: ``make_plan`` sorts by
               destination). One entry per (destination, reaching writer)
               pair bounds the extremal index against hub slot blowup.

Churn moves patched writers to exact per-level block *lists* in
``overrides`` (maintained incrementally by ``plan_patch`` using the
flavor-matched closure oracle; a level relayout or recompile invalidates
the whole index, which rebuilds lazily on next use).

Expansion packs a *ragged* per-level tuple, each level's active count
bucketed to its own power of two (``bucket_active``, same discipline as
``bucket_batch``, and the same tuples as the JAX package's) so a quiet level
never pays the busiest level's gather width and an empty level (shape
``(0,)``) is skipped; widths are sticky high-water marks per index, so
steady-state ingest converges on one shape tuple (and one set of scratch
sizes); pad entries carry the block count ``nb`` and are ignored on
device. A batch whose frontier exceeds the density
threshold returns ``None`` — the caller runs the dense step.

Env knobs (read per call so tests can flip them):
  EAGR_SPARSE_WRITE    auto (default) | 1 (force sparse) | 0 (force dense)
  EAGR_SPARSE_DENSITY  active-block fraction above which auto mode falls
                       back to the dense sweep (default 0.25)
  EAGR_SPARSE_ROWFRAC  touched-writer fraction above which auto mode skips
                       expansion entirely (default 0.05)
On the card ``auto`` decides from each plan's measured step costs instead
(``engine.StepCosts``); the two thresholds cap it there only where set.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from repro_torch.core.dataflow import PULL
from repro_torch.kernels.segment_agg.ops import E_BLK

__all__ = [
    "DEM_CHUNK",
    "FrontierIndex",
    "ReaderFrontierIndex",
    "bucket_active",
    "frontier_summary",
    "maintain_frontier",
    "sparse_mode",
    "sparse_density",
    "sparse_rowfrac",
]

DEM_CHUNK = 256          # demand slots per active chunk (d_pad is a multiple)
ACTIVE_FLOOR = 8         # smallest active-block bucket
_READER_BUILD_CAP = 20_000_000  # down-set entry budget before dense-only


def _host(t) -> np.ndarray:
    """A plan table as host numpy (one device-to-host copy)."""
    return t.cpu().numpy()


def sparse_mode() -> str:
    """'auto' | '1' | '0' — read per call."""
    v = os.environ.get("EAGR_SPARSE_WRITE", "auto").strip().lower()
    return v if v in ("auto", "1", "0") else "auto"


def sparse_density() -> float:
    try:
        return float(os.environ.get("EAGR_SPARSE_DENSITY", "0.25"))
    except ValueError:
        return 0.25


def sparse_rowfrac() -> float:
    try:
        return float(os.environ.get("EAGR_SPARSE_ROWFRAC", "0.05"))
    except ValueError:
        return 0.05


def frontier_summary(counts: list[int]) -> dict:
    """Frontier-size distribution from an engine's ``frontier_log``: each
    write step contributed its active-block capacity K (sparse) or ``-1``
    (dense fallback). Reports how sparse the write path actually ran plus
    p50/p99 of the active-block count over the sparse steps. Shared by the
    bench harness and ``EagrSession.stats()``."""
    sparse = sorted(k for k in counts if k >= 0)
    out = {
        "steps": len(counts),
        "dense_steps": sum(1 for k in counts if k < 0),
        "sparse_steps": len(sparse),
    }
    if sparse:
        out["p50_blocks"] = sparse[min(len(sparse) - 1,
                                       round(0.50 * (len(sparse) - 1)))]
        out["p99_blocks"] = sparse[min(len(sparse) - 1,
                                       round(0.99 * (len(sparse) - 1)))]
    return out


def bucket_active(n: int) -> int:
    """Power-of-two active-count bucketing (floor ACTIVE_FLOOR), same ladder
    discipline as ``bucket_batch``. A count of zero buckets to zero — the
    level is skipped, not padded."""
    if n <= 0:
        return 0
    return max(ACTIVE_FLOOR, 1 << (int(n) - 1).bit_length())


def _pack_active(keys: np.ndarray, n_levels: int, n_units: int,
                 density: float | None,
                 floors: np.ndarray | None = None) \
        -> tuple[np.ndarray, ...] | None:
    """Turn sorted composite keys ``level * n_units + unit`` into the ragged
    per-level active tuple the sparse bodies consume — one ascending
    ``(bucket_active(count_l),)`` int32 array per level — or ``None`` when
    the busiest level exceeds ``density * n_units`` (dense fallback).
    Per-level bucketing matters on skewed overlays: a quiet level no longer
    pays the busiest level's gather width, and an empty level packs to shape
    ``(0,)`` so the step bodies drop its sweep entirely. ``floors`` (the
    caller's per-level high-water marks, updated in place) makes the widths
    *sticky*: a level never shrinks below its past bucket, so successive
    batches converge on ONE shape tuple instead of changing every time a
    level count wobbles across a bucket boundary (the JAX package retraces
    on each new tuple; the port keeps the tuples equal to its). Pads carry
    ``n_units`` and sit at the END of each row, so the active blocks stay
    ascending — the kernel's revisit invariant."""
    l_arr = keys // n_units
    u_arr = keys % n_units
    counts = np.bincount(l_arr, minlength=n_levels)
    kmax = int(counts.max()) if counts.size else 0
    if density is not None and kmax > density * n_units:
        return None
    offs = np.cumsum(counts) - counts
    out = []
    for l in range(n_levels):
        c = int(counts[l])
        K = bucket_active(c)
        if floors is not None:
            K = max(K, int(floors[l]))
            floors[l] = K
        lvl = np.full(K, n_units, np.int32)
        lvl[:c] = u_arr[offs[l]: offs[l] + c]
        out.append(lvl)
    return tuple(out)


def _dest_spans(d_s: np.ndarray, b_s: np.ndarray):
    """Each destination's block span ``[lo, hi)`` over its slots: the
    sorted unique destinations of ``d_s`` and, per destination, the least
    and one past the greatest block ``b_s`` of its slots. A freshly laid-out
    level keeps a destination's slots contiguous, but churn claims free
    slots anywhere in the tile's range, so the span is the min and max over
    every slot, not the first and last slot in slot order."""
    uniq_d, inv = np.unique(d_s, return_inverse=True)
    lo = np.full(len(uniq_d), np.iinfo(np.int64).max, np.int64)
    hi = np.zeros(len(uniq_d), np.int64)
    np.minimum.at(lo, inv, b_s)
    np.maximum.at(hi, inv, b_s)
    return uniq_d, lo, hi + 1


def _gather_csr(indptr: np.ndarray, flat: np.ndarray,
                rows: np.ndarray) -> np.ndarray:
    """The concatenated CSR ranges of ``rows``, in one vectorized gather."""
    lens = indptr[rows + 1] - indptr[rows]
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    offs = np.repeat(indptr[rows] - (np.cumsum(lens) - lens), lens) \
        + np.arange(total, dtype=np.int64)
    return flat[offs]


@dataclasses.dataclass
class FrontierIndex:
    """Writer-row -> per-level push-block reachability (see module doc)."""

    n_levels: int                 # padded level count (meta.n_levels)
    n_blocks: int                 # per-level padded push block count
    n_base_rows: int              # writer rows covered by the range CSR
    w_indptr: np.ndarray          # (n_base_rows + 1,) int64
    w_lvl: np.ndarray             # (N,) int32 range levels
    w_lo: np.ndarray              # (N,) int32 inclusive first block
    w_hi: np.ndarray              # (N,) int32 exclusive last block
    row_of_node: dict[int, int]   # overlay node -> writer row
    # churn-patched writers: exact per-level block lists supersede the ranges
    overrides: dict[int, dict[int, np.ndarray]] = \
        dataclasses.field(default_factory=dict)
    # source-exact entries (sum path) vs full destination spans (extremal)
    exact: bool = False
    # sticky per-level width high-water marks (see _pack_active)
    k_floor: np.ndarray | None = dataclasses.field(default=None, repr=False)

    # ------------------------------------------------------------------ build
    @staticmethod
    def build(plan, *, exact: bool = False) -> "FrontierIndex":
        """Bulk-build from the plan's (current) push tables: one ascending
        pass propagates per-node writer reach-sets through the push levels,
        a second pass emits the block entries. All vectorized numpy; the only
        device read is the one-time pull of the routing tables.

        ``exact=False`` (extremal aggregates) records each reached
        destination's FULL block span: a changed extremal row recomputes
        from every in-edge, including edges whose sources the batch never
        touched, so all of its slots must be gathered. ``exact=True`` (sum)
        records only the blocks holding slots whose *source* is in the
        writer's closure: the sum step is delta-incremental and an
        untouched source's delta is exactly ``+0.0``, so its edges
        contribute nothing — on power-law graphs this shrinks a batch's
        frontier by the hub in-degree factor (a hub destination reached
        through one edge no longer drags in its whole span)."""
        seg = _host(plan.arrays.push.seg)
        src = _host(plan.arrays.push.src)
        L, e_pad = seg.shape
        nb = e_pad // E_BLK
        wn = np.asarray(plan.writer_node, np.int64)
        n_rows = len(wn)
        n_nodes = plan.meta.n_nodes

        # growing CSR of reach-sets (writer rows) per node; push destinations
        # are interior overlay nodes (never base writers), so each node's
        # entry is written at exactly one level and appends monotonically
        node_start = np.full(n_nodes, -1, np.int64)
        node_len = np.zeros(n_nodes, np.int64)
        real = np.flatnonzero((wn >= 0) & (wn < n_nodes))  # skip pad rows
        data = real.astype(np.int64)  # writers reach themselves
        node_start[wn[real]] = np.arange(len(real))
        node_len[wn[real]] = 1

        ent_w, ent_l, ent_lo, ent_hi = [], [], [], []
        depth = min(plan.depth, L)
        for l in range(depth):
            live = np.flatnonzero(seg[l] >= 0)
            if live.size == 0:
                continue
            d_s = seg[l][live].astype(np.int64)
            s_s = src[l][live].astype(np.int64)
            b_s = live // E_BLK
            lens = node_len[s_s]
            nz = lens > 0
            if not nz.any():
                continue
            # expand each slot into its source's reach-set members
            lens_nz = lens[nz]
            starts = node_start[s_s[nz]]
            total = int(lens_nz.sum())
            offs = np.repeat(starts - (np.cumsum(lens_nz) - lens_nz),
                             lens_nz) + np.arange(total, dtype=np.int64)
            w_flat = data[offs]
            d_flat = np.repeat(d_s[nz], lens_nz)
            key = np.unique(d_flat * n_rows + w_flat)
            d_u = key // n_rows
            w_u = key % n_rows
            if exact:
                # per (writer, slot-block): only blocks holding this
                # closure's own edge slots
                b_flat = np.repeat(b_s[nz], lens_nz)
                kb = np.unique(w_flat * np.int64(nb) + b_flat)
                lo_b = (kb % nb).astype(np.int32)
                ent_w.append(kb // nb)
                ent_l.append(np.full(len(kb), l, np.int32))
                ent_lo.append(lo_b)
                ent_hi.append(lo_b + 1)
            else:
                # per-destination block span at this level
                uniq_d, lo_of, hi_of = _dest_spans(d_s, b_s)
                pos = np.searchsorted(uniq_d, d_u)
                ent_w.append(w_u)
                ent_l.append(np.full(len(w_u), l, np.int32))
                ent_lo.append(lo_of[pos].astype(np.int32))
                ent_hi.append(hi_of[pos].astype(np.int32))
            # fold the new destinations into the reach CSR (key is sorted by
            # destination, then writer — already CSR order)
            d_new, d_first = np.unique(d_u, return_index=True)
            d_counts = np.concatenate([d_first[1:], [len(d_u)]]) - d_first
            node_start[d_new] = len(data) + d_first
            node_len[d_new] = d_counts
            data = np.concatenate([data, w_u])

        if ent_w:
            w_all = np.concatenate(ent_w)
            order = np.argsort(w_all, kind="stable")
            w_sorted = w_all[order]
            lvl = np.concatenate(ent_l)[order]
            lo = np.concatenate(ent_lo)[order]
            hi = np.concatenate(ent_hi)[order]
        else:
            w_sorted = np.zeros(0, np.int64)
            lvl = lo = hi = np.zeros(0, np.int32)
        indptr = np.zeros(n_rows + 1, np.int64)
        indptr[1:] = np.cumsum(np.bincount(w_sorted.astype(np.int64),
                                           minlength=n_rows))
        return FrontierIndex(
            n_levels=L, n_blocks=nb, n_base_rows=n_rows, w_indptr=indptr,
            w_lvl=lvl.astype(np.int32), w_lo=lo.astype(np.int32),
            w_hi=hi.astype(np.int32),
            row_of_node={int(wn[i]): int(i) for i in real}, exact=exact)

    # ----------------------------------------------------------------- expand
    def keys(self, rows: np.ndarray) -> np.ndarray | None:
        """The sorted unique ``level * n_blocks + block`` keys a batch's
        (unique, live) writer rows reach, or ``None`` for a row the index
        cannot bound. :meth:`expand` packs them."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        nb = self.n_blocks
        keys: list[np.ndarray] = []
        if self.overrides:
            ov_mask = np.fromiter((int(r) in self.overrides for r in rows),
                                  bool, len(rows))
        else:
            ov_mask = np.zeros(len(rows), bool)
        base_rows = rows[~ov_mask]
        if (base_rows >= self.n_base_rows).any():
            return None  # unindexed row (shouldn't happen; be safe)
        if base_rows.size:
            lens = self.w_indptr[base_rows + 1] - self.w_indptr[base_rows]
            total = int(lens.sum())
            if total:
                starts = self.w_indptr[base_rows]
                offs = np.repeat(starts - (np.cumsum(lens) - lens), lens) \
                    + np.arange(total, dtype=np.int64)
                lvl = self.w_lvl[offs].astype(np.int64)
                lo = self.w_lo[offs].astype(np.int64)
                hi = self.w_hi[offs].astype(np.int64)
                # dedupe ranges before expanding them to blocks — sibling
                # writers share destination ranges heavily
                rk = np.unique((lvl * (nb + 1) + lo) * (nb + 1) + hi)
                hi_u = rk % (nb + 1)
                lo_u = (rk // (nb + 1)) % (nb + 1)
                lvl_u = rk // ((nb + 1) * (nb + 1))
                spans = hi_u - lo_u
                tot_b = int(spans.sum())
                base = np.repeat(lvl_u * nb + lo_u, spans)
                step = np.arange(tot_b, dtype=np.int64) \
                    - np.repeat(np.cumsum(spans) - spans, spans)
                keys.append(base + step)
        for r in rows[ov_mask]:
            for l, blks in self.overrides[int(r)].items():
                if len(blks):
                    keys.append(l * nb + blks.astype(np.int64))
        return np.unique(np.concatenate(keys)) if keys \
            else np.zeros(0, np.int64)

    def expand(self, rows: np.ndarray,
               density: float | None = 0.25) \
            -> tuple[np.ndarray, ...] | None:
        """Expand a batch's (unique, live) writer rows into the ragged
        per-level active-block tuple (see ``_pack_active``), or ``None`` for
        dense fallback (frontier too dense, or a row the index cannot
        bound)."""
        keys = self.keys(rows)
        if keys is None:
            return None
        if self.k_floor is None:
            self.k_floor = np.zeros(self.n_levels, np.int64)
        return _pack_active(keys, self.n_levels, self.n_blocks, density,
                            floors=self.k_floor)

    # ------------------------------------------------------------ maintenance
    def set_override(self, row: int,
                     blocks: dict[int, np.ndarray]) -> None:
        self.overrides[int(row)] = {int(l): np.asarray(b, np.int32)
                                    for l, b in blocks.items()}

    def blocks_of(self, row: int) -> dict[int, set[int]]:
        """Materialized per-level block sets of one writer row (ranges or
        override), for the parity oracle."""
        out: dict[int, set[int]] = {}
        if int(row) in self.overrides:
            for l, arr in self.overrides[int(row)].items():
                out.setdefault(int(l), set()).update(int(b) for b in arr)
            return out
        if 0 <= row < self.n_base_rows:
            for i in range(int(self.w_indptr[row]),
                           int(self.w_indptr[row + 1])):
                out.setdefault(int(self.w_lvl[i]), set()).update(
                    range(int(self.w_lo[i]), int(self.w_hi[i])))
        return out

    # ----------------------------------------------------------------- parity
    def verify(self, plan, host) -> None:
        """Superset oracle (``EAGR_PATCH_PARITY``): every writer's indexed
        blocks must cover the blocks an independent walk of the host graph
        says its closure occupies — the invariant that makes the sparse step
        bit-identical to the dense one."""
        oracle = closure_src_blocks if self.exact else closure_blocks
        bad = []
        for node, row in self.row_of_node.items():
            want = oracle(host, node)
            have = self.blocks_of(row)
            for l, blks in want.items():
                missing = blks - have.get(l, set())
                if missing:
                    bad.append((row, l, sorted(missing)[:4]))
        if bad:
            raise AssertionError(
                f"frontier index under-covers writer closures: {bad[:5]}")


def closure_blocks(host, node: int) -> dict[int, set[int]]:
    """Exact per-level push blocks of one writer node's closure, from the
    ``PlanHost`` bookkeeping graph: forward walk over consumers, descending
    only through push destinations (a pull consumer breaks the delta chain),
    collecting every slot block of every member. The independent oracle for
    ``FrontierIndex.verify`` and the recompute behind churn overrides."""
    th = host.push
    per_level: dict[int, set[int]] = {}
    seen = {node}
    stack = [node]
    while stack:
        v = stack.pop()
        for c in host.out[v]:
            if c in seen:
                continue
            lv = th.level_of.get(c)
            if lv is None:
                continue  # not a push destination: nothing propagates past it
            seen.add(c)
            stack.append(c)
            blks = per_level.setdefault(int(lv), set())
            for slot, _, _ in th.slots_of[c]:
                blks.add(slot // E_BLK)
    return per_level


def closure_src_blocks(host, node: int) -> dict[int, set[int]]:
    """Source-exact per-level push blocks of one writer node's closure: the
    same forward walk as :func:`closure_blocks`, but a destination slot is
    collected only when its *source* is itself a closure member — the blocks
    the sum path's delta can actually reach. The ``exact=True`` twin of the
    extremal oracle."""
    th = host.push
    per_level: dict[int, set[int]] = {}
    seen = {node}
    stack = [node]
    while stack:
        v = stack.pop()
        for c in host.out[v]:
            if c in seen:
                continue
            if th.level_of.get(c) is None:
                continue  # not a push destination: the delta chain stops
            seen.add(c)
            stack.append(c)
    for c in seen - {node}:
        lv = th.level_of.get(c)
        if lv is None:
            continue
        blks = per_level.setdefault(int(lv), set())
        for slot, s, _ in th.slots_of.get(c, ()):
            if s in seen:
                blks.add(slot // E_BLK)
    return per_level


def maintain_frontier(fi: FrontierIndex, plan, host, seeds: set[int],
                      old_in: dict[int, list]) -> None:
    """Incremental maintenance after an in-capacity slot patch: find the
    writers whose closure block-map may have moved (reverse walk from every
    re-homed node, over the union of old and new in-edges so removed-edge
    ancestors are reached too) and recompute exact overrides for them. Level
    relayouts / recompiles invalidate the whole index instead (caller)."""
    # register rows appended by this patch (skip capacity-padding rows)
    wn = np.asarray(plan.writer_node)
    for r in range(fi.n_base_rows, len(wn)):
        node = int(wn[r])
        if 0 <= node < plan.meta.n_nodes and fi.row_of_node.get(node) != r:
            fi.row_of_node[node] = r
            fi.overrides.setdefault(r, {})
    visited = set(seeds)
    stack = list(seeds)
    while stack:
        v = stack.pop()
        parents = {s for s, _ in host.in_edges[v]}
        if v in old_in:
            parents |= {s for s, _ in old_in[v]}
        for s in parents:
            if s not in visited:
                visited.add(s)
                stack.append(s)
    oracle = closure_src_blocks if fi.exact else closure_blocks
    for node in visited:
        row = fi.row_of_node.get(int(node))
        if row is None:
            continue
        fi.set_override(row, {
            l: np.fromiter(sorted(b), np.int32, len(b))
            for l, b in oracle(host, int(node)).items()})


# ---------------------------------------------------------------- read side
def _csr(keys: dict[int, set[int]], rows: np.ndarray) -> tuple:
    """``(indptr, flat)`` of the sorted key sets of ``rows`` (in order);
    a row absent from ``keys`` gets an empty range."""
    lens = np.fromiter((len(keys.get(int(v), ())) for v in rows), np.int64,
                       len(rows))
    indptr = np.zeros(len(rows) + 1, np.int64)
    indptr[1:] = np.cumsum(lens)
    flat = np.empty(int(indptr[-1]), np.int64)
    for i, v in enumerate(rows):
        k = keys.get(int(v))
        if k:
            flat[indptr[i]: indptr[i + 1]] = sorted(k)
    return indptr, flat


@dataclasses.dataclass
class ReaderFrontierIndex:
    """Reader node -> (demand chunks, pull blocks) of its demand down-set.

    Built by one full descending propagation of ``above``-sets (which
    potential readers demand each pull node) over the demand pairs, then an
    emission pass: a demand pair's chunk is needed by every reader demanding
    its destination; a pull destination's whole slot block range is needed by
    every reader demanding it. Push readers get (correctly) empty entries —
    their answer is a PAO gather. ``dense_only`` marks graphs whose down-sets
    exceeded the build budget.

    The keys are stored as CSR over index rows (``row_of_node`` maps an
    overlay node to its row, -1 for a node with no key), so ``expand`` is
    one vectorized gather per side plus ``np.unique``, with no Python work
    per reader. ``dem_keys``/``pull_keys`` give the dict view (node -> sorted
    keys) the JAX package stores."""

    n_levels: int
    n_chunks: int                  # d_pad // DEM_CHUNK
    n_blocks: int                  # per-level padded pull block count
    row_of_node: np.ndarray        # (n_nodes,) int64 index row, -1 = none
    dem_indptr: np.ndarray         # (rows + 1,) int64
    dem_flat: np.ndarray           # sorted level*n_chunks+chunk per row
    pull_indptr: np.ndarray        # (rows + 1,) int64
    pull_flat: np.ndarray          # sorted level*n_blocks+block per row
    dense_only: bool = False
    # sticky per-level width high-water marks (see _pack_active)
    dem_floor: np.ndarray | None = dataclasses.field(default=None, repr=False)
    pull_floor: np.ndarray | None = dataclasses.field(default=None,
                                                      repr=False)

    @staticmethod
    def _from_sets(L: int, n_chunks: int, nb: int, n_nodes: int,
                   dem: dict[int, set[int]], pull: dict[int, set[int]],
                   dense_only: bool = False) -> "ReaderFrontierIndex":
        nodes = np.array(sorted(set(dem) | set(pull)), np.int64)
        row_of = np.full(n_nodes, -1, np.int64)
        row_of[nodes] = np.arange(len(nodes))
        di, df = _csr(dem, nodes)
        pi, pf = _csr(pull, nodes)
        return ReaderFrontierIndex(L, n_chunks, nb, row_of, di, df, pi, pf,
                                   dense_only=dense_only)

    @staticmethod
    def build(plan) -> "ReaderFrontierIndex":
        seg = _host(plan.arrays.pull.seg)
        dd = _host(plan.arrays.demand_dst)
        ds = _host(plan.arrays.demand_src)
        L, e_pad = seg.shape
        nb = e_pad // E_BLK
        n_chunks = dd.shape[1] // DEM_CHUNK
        n = plan.meta.n_nodes
        dec = np.asarray(plan.decision)
        pull_nodes = np.flatnonzero(dec == PULL)

        above: dict[int, set[int]] = {int(p): {int(p)} for p in pull_nodes}
        total = len(above)
        depth = min(plan.depth, L)
        # full descending propagation first (a node's demand settles only
        # once every higher level ran), then emit
        for l in range(depth - 1, -1, -1):
            live = dd[l] < n
            for d, s in zip(dd[l][live], ds[l][live]):
                src_set = above.setdefault(int(s), set())
                add = above.get(int(d), set()) - src_set
                if add:
                    src_set |= add
                    total += len(add)
                    if total > _READER_BUILD_CAP:
                        return ReaderFrontierIndex._from_sets(
                            L, n_chunks, nb, n, {}, {}, dense_only=True)
        dem: dict[int, set[int]] = {}
        pull: dict[int, set[int]] = {}
        for l in range(depth):
            live = np.flatnonzero(dd[l] < n)
            for i in live:
                d = int(dd[l, i])
                key = l * n_chunks + int(i) // DEM_CHUNK
                for v in above.get(d, ()):
                    dem.setdefault(v, set()).add(key)
            sl = np.flatnonzero(seg[l] >= 0)
            if sl.size == 0:
                continue
            d_s = seg[l][sl].astype(np.int64)
            b_s = sl // E_BLK
            for d, lo, hi in zip(*_dest_spans(d_s, b_s)):
                for v in above.get(int(d), ()):
                    pull.setdefault(v, set()).update(
                        l * nb + b for b in range(int(lo), int(hi)))
        return ReaderFrontierIndex._from_sets(L, n_chunks, nb, n, dem, pull)

    def _view(self, indptr, flat) -> dict[int, np.ndarray]:
        nodes = np.flatnonzero(self.row_of_node >= 0)
        rows = self.row_of_node[nodes]
        return {int(v): flat[indptr[r]: indptr[r + 1]]
                for v, r in zip(nodes, rows) if indptr[r + 1] > indptr[r]}

    @property
    def dem_keys(self) -> dict[int, np.ndarray]:
        """node -> sorted level*n_chunks+chunk keys (nodes with any)."""
        return self._view(self.dem_indptr, self.dem_flat)

    @property
    def pull_keys(self) -> dict[int, np.ndarray]:
        """node -> sorted level*n_blocks+block keys (nodes with any)."""
        return self._view(self.pull_indptr, self.pull_flat)

    def expand(self, nodes: np.ndarray, density: float | None = 0.25):
        """(dem_active, pull_active) for a batch of reader nodes, or ``None``
        for dense fallback."""
        if self.dense_only:
            return None
        nodes = np.asarray(nodes, np.int64).reshape(-1)
        rows = self.row_of_node[nodes]
        rows = rows[rows >= 0]
        dem_keys = np.unique(_gather_csr(self.dem_indptr, self.dem_flat,
                                         rows))
        pull_keys = np.unique(_gather_csr(self.pull_indptr, self.pull_flat,
                                          rows))
        if self.dem_floor is None:
            self.dem_floor = np.zeros(self.n_levels, np.int64)
            self.pull_floor = np.zeros(self.n_levels, np.int64)
        dem = _pack_active(dem_keys, self.n_levels, self.n_chunks, density,
                           floors=self.dem_floor)
        pull = _pack_active(pull_keys, self.n_levels, self.n_blocks, density,
                            floors=self.pull_floor)
        if dem is None or pull is None:
            return None
        return dem, pull
