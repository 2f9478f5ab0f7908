"""Stacked execution of reader-partitioned EAGr shards (paper §7), on one
card or one shard per rank of a ``torch.distributed`` group.

``eagr_shard.partition_overlay`` + ``align_shard_plans`` force every shard's
``ExecPlan`` onto one table shape. This module takes the remaining step: all
shards' ``PlanArrays``, window state and PAOs are stacked along a leading
shard axis of one device's tensors, and write/read run every shard at once —

  * the incoming batch is replicated to every shard (the write replication
    the paper describes: each shard's slice reads the same staged batch),
  * each shard masks the batch to its owned writer rows through a
    device-resident owner map (base id -> local writer row, -1 elsewhere),
  * reads run shard-local and the answers come back by a gather by owner
    (each reader lives on exactly one shard, so this equals the JAX
    package's cross-shard sum of answers masked to zero).

The step bodies are the engine's ``*_stacked`` twins of the single-engine
bodies: each level is one launch of the segment kernel's stacked entry for
all S shards, and per shard the arithmetic is the single engine's, so the
stack equals the per-shard host loop (``eagr_shard.host_loop_write`` /
``host_loop_read``) bit for bit. Without a mesh the JAX package's ``vmap``
fallback is what runs, with the shard axis a tensor dimension.

On a mesh (``mesh="auto"`` inside a group of one rank per shard,
``launch.mesh.make_shard_mesh``) the same bodies run SPMD, the counterpart
of the JAX package's ``shard_map`` path: rank r holds only shard r's slice,
as a stack of one (its ``PlanArrays``, windows, PAOs, clock and its own row
of the owner maps; ``local == [r]``), and runs the segment kernel's stacked
entries at S = 1. Input and output are replicated: every rank calls
``write_batch`` / ``read_batch`` with the same global batch.

  * Writes need no collective: each rank routes the batch through its own
    owner map (the write replication the JAX body does by all-gather) and
    chooses sparse or dense for its own shard (sparse equals dense bit for
    bit, so the choice never changes an answer).
  * Reads run shard-local; the answers come back by one all-gather of the
    ranks' answers and a pick by owner, so every rank returns the whole
    batch's answers, bit-equal to the one-card stack (no sum: the JAX
    ``psum`` turns ``-0.0 + 0.0`` into ``+0.0``).
  * Alerts: each rank evaluates its own readers' columns; the batch's fired
    total is one all-reduce, and the fired buffers come back by all-gather
    when something fired (``streams.alerts.AlertSet``).
  * Churn: every rank applies every shard's delta. The owning rank patches
    its slice in place; every other rank replays the patch on its host copy
    of that shard's plan (the other shards' plans stay on the CPU). The
    patch bookkeeping is deterministic, so every rank replays every shard's
    host bookkeeping and reaches the same growth-fallback and ``restack``
    decision with no collective.

Structural churn patches one shard's slice in place: each shard plan's
tables are views of the stack, so ``plan_patch.patch_plan`` on a shard
writes its edits straight into the stacked tables (no table is reallocated
or copied), and owner-map rows are scattered in place. A growth fallback
(a patch that outgrew the padded shape) realigns every shard and restacks.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.aggregates import Aggregate
from repro_torch.core.engine import (
    EngineState,
    plan_arrays_shard,
    read_step_stacked,
    refresh_pao_step,
    stack_plan_arrays,
    stage,
    to_host,
    write_step_extremal_stacked,
    write_step_sum_stacked,
)
from repro_torch.core.window import (
    WindowSpec,
    init_windows,
    pad_window_rows,
    place_window_shard,
    reset_window_rows,
    stack_windows,
    window_shard,
)
from repro_torch.distributed.eagr_shard import keep_local_shard

BASE_BUCKET = 256  # owner maps grow in power-of-two multiples of this


def _bucket_base_cap(n: int) -> int:
    """Owner-map capacity bucket: power-of-two multiples of BASE_BUCKET so a
    growing base-id space rarely reallocates the maps."""
    k = -(-max(1, int(n)) // BASE_BUCKET)
    return BASE_BUCKET * (1 << (k - 1).bit_length())


def _stacked_meta(plans):
    """The one ``PlanMeta`` the stack runs: the shards' common padded shape,
    iterated to the deepest shard's real depth (a shallower shard's extra
    levels hold no edge and touch no row)."""
    metas = {dataclasses.replace(p.meta, depth=0) for p in plans}
    if len(metas) != 1:
        raise ValueError(
            "shard plans are not aligned to one PlanMeta — build the "
            f"ShardedOverlay through align_shard_plans (got {metas})")
    return dataclasses.replace(plans[0].meta,
                               depth=max(p.meta.depth for p in plans))


class StackedShardedEngine:
    """N reader-partitioned shards stacked on one device, or one shard per
    rank of a mesh.

    Owns the stacked runtime state of a ``ShardedOverlay`` whose plans were
    aligned by ``align_shard_plans``:

      arrays   PlanArrays, every leaf (S, ...); each shard plan's
               ``arrays`` are views of its slice
      state    EngineState — windows (S, n_writers, cap), pao (S, n_nodes,
               d), now (S,)
      maps     writer_map / reader_map (S, base_cap) int32 on the device,
               -1 = not owned

    ``local`` lists the shards this process holds: all S on one card, the
    rank's own on a mesh, where each of the tensors above has a leading
    axis of 1. ``write_batch`` / ``read_batch`` take *global* batches of
    base ids and route them on the device through the owner maps.
    Structural churn patches one shard slice at a time (``apply_delta``); a
    growth fallback on any shard triggers a stack-wide realign +
    ``restack``.

    ``mesh="auto"`` takes ``make_shard_mesh(n_shards, device=device)``: a
    group of exactly ``n_shards`` ranks runs one shard per rank, anything
    less runs the stack on one device (``device``, else the plans').
    """

    def __init__(self, sharded, aggregate: Aggregate,
                 window: WindowSpec | None = None, *, mesh="auto",
                 device=None, base_capacity: int | None = None):
        from repro_torch.launch.mesh import make_shard_mesh

        self.sharded = sharded
        self.agg = aggregate
        self.spec = window or WindowSpec(kind="tuple", size=1)
        self.n_shards = sharded.n_shards
        self.meta = _stacked_meta(sharded.shard_plans)
        self.mesh = make_shard_mesh(self.n_shards, device=device) \
            if mesh == "auto" else mesh
        if self.mesh is not None:
            self.device = self.mesh.device
            self.local = [self.mesh.rank]
        else:
            self.device = torch.device(device) if device is not None \
                else sharded.shard_plans[0].arrays.decision.device
            self.local = list(range(self.n_shards))
        self._adopt_arrays()
        self.state = self.init_state()
        self._base_cap = _bucket_base_cap(base_capacity or 1)
        self._reader_owner: dict[int, int] = {}
        self._pending_retired: dict[int, list[int]] = {}
        self._needs_restack = False
        self.alerts = None  # streams.alerts.AlertSet (attach_alerts)
        self.pin_push = False  # continuous groups: churn-added nodes stay PUSH
        # host clocks mirror EagrEngine's; `now` advances in lockstep (every
        # global batch runs on every shard) but the last PAO-eval instant is
        # per shard — a slice patch refreshes one shard's PAOs only. Every
        # process keeps every shard's instant.
        self._now_host = 0.0
        self._last_eval_now = np.zeros(self.n_shards, np.float32)
        self.refresh_owner_maps()

    @property
    def shard_plans(self):
        """Aligned per-shard ``ExecPlan`` list (the seam ``AlertSet.sync``
        resolves reader rows against)."""
        return self.sharded.shard_plans

    def _adopt_arrays(self) -> None:
        """Stack the held shard plans' tables and point each at its slice
        of the stack (views), so patching a plan patches the stack."""
        plans = self.sharded.shard_plans
        if self.mesh is not None:
            keep_local_shard(self.sharded, self.mesh.rank, self.device)
        self.arrays = stack_plan_arrays([plans[s].arrays for s in self.local])
        for i, s in enumerate(self.local):
            plans[s].arrays = plan_arrays_shard(self.arrays, i)

    def gather_shards(self, t: torch.Tensor) -> torch.Tensor:
        """A tensor over this process's shards, ``(len(local), ...)``, as
        the whole stack's ``(S, ...)``: itself on one card, the all-gather
        of every rank's slice on a mesh (a collective: every rank calls
        it)."""
        if self.mesh is None:
            return t
        return self.mesh.all_gather(t).flatten(0, 1)

    def attach_alerts(self, alerts) -> None:
        """Attach an ``AlertSet`` over the stack: rows resolve to (owner
        shard, node) and every subsequent global batch evaluates them after
        its step, with per-shard disjoint fired buffers."""
        self.alerts = alerts
        try:
            alerts.sync(self)
        except Exception:
            self.alerts = None
            raise

    # ------------------------------------------------------------------ state
    def init_state(self) -> EngineState:
        S, dev = len(self.local), self.device
        windows = stack_windows([init_windows(self.meta.n_writers, self.spec,
                                              device=dev) for _ in range(S)])
        pao = torch.stack([self.agg.init_pao(self.meta.n_nodes, device=dev)
                           for _ in range(S)])
        return EngineState(windows, pao,
                           torch.zeros((S,), dtype=torch.float32, device=dev))

    def adopt_state(self, state: EngineState, *, now_host: float,
                    last_eval_now) -> None:
        """Adopt a stacked ``EngineState`` of the held shards plus the host
        clock mirror and every shard's last-PAO-eval instant (checkpoint
        restore), verbatim: no PAO refresh, so restored reads equal the
        saved session's bit for bit."""
        lev = np.asarray(last_eval_now, np.float32).reshape(-1).copy()
        if len(lev) != self.n_shards:
            raise ValueError(f"last_eval_now has {len(lev)} shards, engine "
                             f"has {self.n_shards}")
        self.state = state
        self._now_host = float(now_host)
        self._last_eval_now = lev

    def global_state_host(self) -> EngineState:
        """Every shard's state as host arrays, (S, ...) leaves: on a mesh
        one all-gather of the ranks' states (a collective)."""
        st = self.state
        leaves = to_host(*st.windows, st.pao, st.now)
        if self.mesh is not None:
            parts = self.mesh.all_gather_object(leaves)
            leaves = [np.concatenate(xs) for xs in zip(*parts)]
        return EngineState(type(st.windows)(*leaves[:-2]), *leaves[-2:])

    def refresh_owner_maps(self) -> None:
        """Rebuild the device-resident base-id routing maps from the host
        plans (after construction and after a restack). Capacity grows in
        buckets."""
        plans = self.sharded.shard_plans
        top = 0
        for p in plans:
            for m in (p.writer_row_of_base, p.reader_node_of_base):
                if m:
                    top = max(top, max(m) + 1)
        self._base_cap = max(self._base_cap, _bucket_base_cap(top))
        wmap = np.full((self.n_shards, self._base_cap), -1, np.int32)
        rmap = np.full((self.n_shards, self._base_cap), -1, np.int32)
        self._reader_owner = {}
        for s, p in enumerate(plans):
            wm, rm = p.writer_row_of_base, p.reader_node_of_base
            if wm:
                b = np.fromiter(wm.keys(), np.int64, len(wm))
                wmap[s, b] = np.fromiter(wm.values(), np.int64, len(wm))
            if rm:
                b = np.fromiter(rm.keys(), np.int64, len(rm))
                rmap[s, b] = np.fromiter(rm.values(), np.int64, len(rm))
                self._reader_owner.update((int(x), s) for x in b)
        # dense host twin of "some shard owns this base id": the read path's
        # unknown-id check is one vectorized gather against it
        self._reader_known = (rmap >= 0).any(axis=0)
        # every shard's reader map on the host: a mesh read picks each
        # lane's answer by owner from it
        self._rmap_host = rmap
        # fresh tensors (a later patch scatters into them in place)
        self.writer_map, self.reader_map = (
            t.clone() for t in stage([(wmap[self.local], np.int32),
                                      (rmap[self.local], np.int32)],
                                     self.device))

    def _chunk(self, ids: np.ndarray, vals: np.ndarray | None,
               batch_size: int | None):
        """Pad a global batch to a multiple of n_shards (the JAX package's
        per-shard chunks, reassembled by its all-gather) with a validity
        mask; ids at or past the owner maps' capacity are owned by no shard
        and are clipped so the device gather stays in range."""
        B = batch_size or max(1, len(ids))
        if B < len(ids):
            raise ValueError(f"batch_size={B} < batch of {len(ids)}")
        S = self.n_shards
        Bp = -(-B // S) * S
        ids64 = np.asarray(ids, np.int64).reshape(-1)
        valid = np.zeros(Bp, bool)
        valid[: len(ids64)] = (ids64 >= 0) & (ids64 < self._base_cap)
        idp = np.zeros(Bp, np.int32)
        idp[: len(ids64)] = np.where(valid[: len(ids64)], ids64, 0)
        out = [(idp, np.int32), (valid, bool)]
        if vals is not None:
            vp = np.zeros((Bp,) + vals.shape[1:], np.float32)
            vp[: len(ids64)] = vals
            out.append((vp, np.float32))
        return out

    # -------------------------------------------------------------- execution
    def _frontier_active(self, base_ids: np.ndarray):
        """Per-shard frontier expansion of the held shards for one global
        batch: a per-level tuple of (len(local), K_l) active-block arrays,
        each shard's list padded with the level's block count to the widest
        shard's bucketed width, or ``None`` for the dense stacked sweep.
        The held shards go sparse together or none does (one step runs
        them all); on a mesh each rank decides for its own shard. Extremal
        time windows stay dense: the stack keeps no expiry bookkeeping to
        bound the stale set. ``auto`` uses the JAX package's rule (a large
        batch or a frontier past the density threshold goes dense)."""
        from repro_torch.core import frontier as F

        mode = F.sparse_mode()
        if mode == "0":
            return None
        if self.agg.combine != "sum" and self.spec.kind == "time":
            return None
        ids = np.asarray(base_ids, np.int64).reshape(-1)
        exact = self.agg.combine == "sum"
        acts = []
        for s in self.local:
            p = self.sharded.shard_plans[s]
            rows, mask = p.routes.writer_rows(ids)
            density = None
            if mode == "auto":
                nb = p.arrays.push.tile_of_block.shape[1]
                n_live = int(np.count_nonzero(mask))
                if nb < 8 or n_live > F.sparse_rowfrac() * p.meta.n_writers:
                    return None
                density = F.sparse_density()
            if p.frontier is None or p.frontier.exact != exact:
                p.frontier = F.FrontierIndex.build(p, exact=exact)
            act = p.frontier.expand(np.unique(rows[mask]), density=density)
            if act is None:
                return None
            acts.append(act)
        nb = self.arrays.push.tile_of_block.shape[2]
        out = []
        for l in range(max(len(a) for a in acts)):
            cols = [a[l] if l < len(a) else np.zeros(0, np.int32)
                    for a in acts]
            K = max(c.shape[0] for c in cols)
            out.append(np.stack([
                np.pad(c, (0, K - c.shape[0]), constant_values=nb)
                for c in cols]).astype(np.int32))
        return tuple(out)

    def write_batch(self, base_ids: np.ndarray, values: np.ndarray,
                    batch_size: int | None = None) -> None:
        """Apply one *global* write batch. Every shard sees the whole batch
        (the paper's write replication) and keeps the writes it consumes;
        writes owned by no shard are dropped on the device, like the single
        engine drops writes that feed no reader. When every held shard's
        batch frontier expands (``EAGR_SPARSE_WRITE``), the level sweeps run
        over the stacked active-block lists. The batch, its mask and the
        active lists travel as one copy; the step is queued and the call
        returns without waiting for it (on a mesh with alerts attached, the
        fired total's all-reduce is the one collective)."""
        base_ids = np.asarray(base_ids)
        values = np.asarray(values, np.float32)
        active = self._frontier_active(base_ids)
        host = self._chunk(base_ids, values, batch_size)
        extremal = self.agg.combine != "sum"
        if extremal:
            host.append((self._last_eval_now[self.local], np.float32))
            # rebound, never mutated: the staged copy may still be reading
            self._last_eval_now = np.full(self.n_shards, self._now_host,
                                          np.float32)
        if active is not None:
            host.extend((a, np.int32) for a in active)
        staged = stage(host, self.device)
        ids_d, valid_d, vals_d = staged[:3]
        rest = staged[3:]
        rows = self.writer_map.index_select(1, ids_d.to(torch.int64))
        mask = valid_d[None, :] & (rows >= 0)
        rows = torch.clamp(rows, min=0)
        args = (self.meta, self.agg, self.spec, self.arrays, self.state,
                rows, vals_d, mask)
        if extremal:
            prev, rest = rest[0], rest[1:]
            ns = write_step_extremal_stacked(
                *args, prev, active=None if active is None else tuple(rest))
        else:
            ns = write_step_sum_stacked(
                *args, active=None if active is None else tuple(rest))
        self.state = ns
        al = self.alerts
        if al is not None and al.enabled and al.n_placed:
            from repro_torch.streams.alerts import alert_eval_stacked

            out = alert_eval_stacked(self.agg, al.state, ns.pao,
                                     ns.now - 1.0, al.cap)
            if self.mesh is not None:
                # the batch's fired total over every rank's readers
                count = out[0]
                total = self.mesh.all_reduce_sum(count[:1])
                out = (torch.cat([total, count[1:]]),) + tuple(out[1:])
            al.push_pending(self._now_host, *out)
        self._now_host += 1.0

    def read_batch(self, base_ids: np.ndarray,
                   batch_size: int | None = None) -> np.ndarray:
        """Answer one global read batch: shard-local pull sweeps, then the
        gather by owner (on a mesh, over one all-gather of the ranks'
        answers). Raises on the host for base ids no shard owns."""
        base_ids = np.asarray(base_ids)
        ids64 = base_ids.astype(np.int64).reshape(-1)
        known = np.zeros(len(ids64), bool)
        inb = (ids64 >= 0) & (ids64 < len(self._reader_known))
        known[inb] = self._reader_known[ids64[inb]]
        if not known.all():
            raise ValueError(
                f"read_batch: base ids "
                f"{sorted(set(map(int, ids64[~known])))[:8]} are owned "
                f"by no shard (not readers of any shard overlay)")
        chunk = self._chunk(base_ids, None, batch_size)
        ids_d, valid_d = stage(chunk, self.device)
        nodes = self.reader_map.index_select(1, ids_d.to(torch.int64))
        own = valid_d[None, :] & (nodes >= 0)
        fin, _ = read_step_stacked(self.meta, self.agg, self.arrays,
                                   self.state, torch.clamp(nodes, min=0), own)
        if self.mesh is None:
            (out,) = to_host(fin)
            return out[: len(base_ids)]
        # every rank's answers, then each lane's from the shard that owns
        # it (as read_step_stacked picks on one card)
        (every,) = to_host(self.mesh.all_gather(fin))
        idp, valid = chunk[0][0], chunk[1][0]
        owns = valid[None, :] & (self._rmap_host[:, idp] >= 0)
        owner = (owns * np.arange(self.n_shards)[:, None]).sum(0)
        out = every[owner, np.arange(len(idp))]
        return out[: len(base_ids)]

    # ----------------------------------------------------- structural updates
    def apply_delta(self, s: int, delta, *, growth: float = 2.0):
        """Patch shard ``s``'s plan (§3.3). Its tables are views of the
        stack, so an in-capacity patch writes its edits into exactly that
        slice of the stacked tables in place (the storage is kept; the
        other shards' tables, windows and PAOs are untouched); owner-map
        rows are scattered in place the same way. On a mesh the rank that
        holds shard ``s`` does that; every other rank replays the patch on
        its host copy of the plan and its host owner bookkeeping. A growth
        fallback defers to ``restack``."""
        from repro_torch.core.plan_patch import patch_plan

        plan = self.sharded.shard_plans[s]
        wm_before = dict(plan.writer_row_of_base)
        rm_before = dict(plan.reader_node_of_base)
        res = patch_plan(plan, delta, overlay=self.sharded.shards[s],
                         growth=growth, pin_push=self.pin_push)
        if res.reason == "empty delta":
            return res
        self.sharded.shard_plans[s] = res.plan
        self.sharded.writer_rows[s] = res.plan.writer_row_of_base
        if res.recompiled or self._needs_restack:
            # shapes moved (here or on an earlier shard of this flush): the
            # caller realigns every shard to the new padded dims
            # (ShardedDynamic.ensure_aligned) and restacks, which re-adopts
            # this shard's patched tables and resets its retired rows
            self._pending_retired.setdefault(s, []).extend(
                res.retired_writer_rows)
            self._needs_restack = True
            return res
        self.meta = _stacked_meta(self.sharded.shard_plans)
        self._refresh_shard_state(s, res.retired_writer_rows)
        self._patch_owner_maps(s, wm_before, rm_before, res.plan)
        if self.alerts is not None:
            self.alerts.sync(self, retired=res.retired_reader_bases)
        return res

    def _patch_owner_maps(self, s: int, wm_before: dict, rm_before: dict,
                          plan) -> None:
        """Scatter only shard ``s``'s changed owner-map rows into the device
        maps (where this process holds shard ``s``) and their host twins,
        in place. A base id past the current capacity bucket falls back to
        the full rebuild."""
        wm, rm = plan.writer_row_of_base, plan.reader_node_of_base
        w_edits = [(b, r) for b, r in wm.items() if wm_before.get(b) != r]
        w_edits += [(b, -1) for b in wm_before if b not in wm]
        r_edits = [(b, n) for b, n in rm.items() if rm_before.get(b) != n]
        r_edits += [(b, -1) for b in rm_before if b not in rm]
        if not (w_edits or r_edits):
            return
        if max(b for b, _ in w_edits + r_edits) >= self._base_cap:
            self.refresh_owner_maps()
            return
        for b, n in r_edits:
            self._rmap_host[s, int(b)] = n
            if n >= 0:
                self._reader_owner[int(b)] = s
                self._reader_known[int(b)] = True
            elif self._reader_owner.get(int(b)) == s:
                # only the still-owning shard may unregister: a reader that
                # MOVED shards may have been claimed by its new home already
                self._reader_owner.pop(int(b), None)
                self._reader_known[int(b)] = False
        if s not in self.local:
            return
        i = self.local.index(s)
        for m, edits in ((self.writer_map, w_edits),
                         (self.reader_map, r_edits)):
            if edits:
                e = np.asarray(edits, np.int64).reshape(-1, 2)
                base, val = stage([(e[:, 0], np.int64), (e[:, 1], np.int32)],
                                  self.device)
                m[i].index_copy_(0, base, val)

    def _refresh_shard_state(self, s: int, retired_rows) -> None:
        """Migrate one shard's window/PAO slice after an in-capacity patch,
        in place (where this process holds it): retired writer rows are
        zeroed and the slice's PAOs recomputed through its (patched) push
        tables. Every process records the shard's new last-eval instant."""
        lev = self._last_eval_now.copy()
        lev[s] = self._now_host
        self._last_eval_now = lev
        if s not in self.local:
            return
        i = self.local.index(s)
        plan = self.sharded.shard_plans[s]
        win_s = window_shard(self.state.windows, i)
        if retired_rows:
            win_s = reset_window_rows(win_s, retired_rows)
            place_window_shard(self.state.windows, i, win_s)
        pao_s = refresh_pao_step(plan.meta, self.agg, self.spec, plan.arrays,
                                 win_s, self.state.now[i])
        self.state.pao[i].copy_(pao_s)

    def adopt_shard_plans(self) -> None:
        """Re-adopt the whole stack from ``sharded.shard_plans`` (a decision
        re-adoption or an out-of-band realign): the overlay structure is
        unchanged on this path, so windows survive by position."""
        self._needs_restack = True
        self.restack()

    def restack(self) -> None:
        """Re-adopt every shard plan after a stack-wide realignment (a
        growth fallback on any shard): new meta, re-stacked arrays, window
        rows padded per shard, all held PAO slices refreshed, owner maps
        rebuilt."""
        plans = self.sharded.shard_plans
        self.meta = _stacked_meta(plans)
        self._adopt_arrays()
        wins, paos = [], []
        for i, s in enumerate(self.local):
            w = pad_window_rows(window_shard(self.state.windows, i),
                                self.meta.n_writers)
            retired = self._pending_retired.get(s)
            if retired:
                w = reset_window_rows(w, retired)
            wins.append(w)
            paos.append(refresh_pao_step(plans[s].meta, self.agg, self.spec,
                                         plans[s].arrays, w,
                                         self.state.now[i]))
        self._pending_retired.clear()
        self.state = EngineState(stack_windows(wins), torch.stack(paos),
                                 self.state.now)
        self._last_eval_now = np.full(self.n_shards, self._now_host,
                                      np.float32)
        self._needs_restack = False
        self.refresh_owner_maps()
        if self.alerts is not None:
            self.alerts.sync(self)
