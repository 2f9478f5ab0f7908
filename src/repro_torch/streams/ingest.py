"""Double-buffered streaming ingest over a ring of pinned host slots.

The synchronous write path pays, per arrival batch: host routing, the
uploads, one O(n_nodes) device step, and the Python gap between batches.
:class:`IngestPipeline` restructures that into a pipeline over a small ring
of pre-allocated power-of-two slots:

  * arriving events accumulate into the current ring slot (vectorized
    copies into the slot's pinned host tensors, through numpy views — no
    per-event Python anywhere on this path);
  * when a slot reaches ``device_batch`` events it is routed (one
    ``BaseRoutes`` table lookup per engine) and dispatched through
    ``EagrEngine.write_rows``: the slot's values go to the device straight
    from pinned memory by one non-blocking copy, the routed rows and mask
    (and an active tuple) by one more per engine, and the step is queued —
    the host fills and routes slot N+1 while the device still runs slot N;
  * a ``torch.cuda.Event`` recorded after a slot's last step is its token.
    Backpressure is explicit: the only steady-state wait is
    ``event.synchronize()`` at the ring boundary (timed into
    ``stats.stall_s``) — a slot's pinned buffers are refilled only once the
    copies and steps that read them finished. On CPU tensors the steps run
    as they are called, the token is ``None`` and the ring degenerates to
    the synchronous path;
  * :meth:`flush` dispatches the partial slot and waits for every token — a
    full pipeline barrier. ``EagrSession.flush`` runs it *before* draining
    churn journals, so structural patches keep their ordering with respect
    to writes. :meth:`drain` dispatches without waiting: a later read is
    queued on the same stream, after every dispatched step.

Coalescing — ``device_batch`` larger than the arrival batch — is where the
sustained-throughput win comes from: the device step sweeps O(n_nodes +
E_push) state per batch regardless of batch size, so folding k arrival
batches into one device batch amortizes that sweep k ways. The logical
clock consequently ticks once per *device* batch, not once per ``submit``;
for time windows pick ``device_batch`` so one tick still means what the
window size expects. Pipelined and synchronous paths are bit-equal whenever
the synchronous driver uses the same batch boundaries
(``write_batch(ids, vals, batch_size=device_batch)`` per full slot).

Standing alerts: each dispatch marks every engine's ``AlertSet`` with its
dispatch sequence number; when the ring frees a slot (its token done), the
fired sets of the steps up to that mark are read back — the steps' compact
buffers were copied to pinned host memory behind them, so the readback
waits for nothing.

``IngestStats`` is the counter block: events in/dispatched/dropped,
batches, stall and barrier time, ring occupancy high-water.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.engine import bucket_batch, not_ported

__all__ = ["IngestPipeline", "IngestStats"]


@dataclasses.dataclass
class IngestStats:
    """Ingest counters; ``events_in`` minus ``events_dispatched`` is the
    current fill of the accumulating slot."""

    events_in: int = 0          # events submitted to the pipeline
    events_dispatched: int = 0  # events handed to the device (incl. masked)
    events_dropped: int = 0     # lanes no engine routed (unknown writers)
    batches: int = 0            # device batches dispatched
    partial_batches: int = 0    # dispatches below device_batch (flush/drain)
    flushes: int = 0            # full pipeline barriers
    stall_s: float = 0.0        # time blocked on ring backpressure
    barrier_s: float = 0.0      # time blocked inside flush()
    max_in_flight: int = 0      # ring occupancy high-water mark

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class IngestPipeline:
    """Double-buffered ingest ring over one or more engines sharing a write
    stream (an ``EagrSession``'s engine groups, or hand-assembled engines).

    Parameters
    ----------
    engines : list
        ``EagrEngine`` instances on one device; each dispatches through the
        pre-routed ``write_rows`` entry. Stacked shard engines are not
        ported yet and raise ``NotImplementedError``.
    depth : int
        Ring slots (>= 1). ``depth=1`` degenerates to synchronous-but-
        coalesced; ``depth=2`` is classic double buffering.
    device_batch : int
        Events per device step; bucketed to a power of two. This is the
        coalescing factor — and the logical-clock granularity.
    value_dim : int | None
        Raw write arity; defaults to the first engine's window spec.
    """

    def __init__(self, engines, *, depth: int = 2, device_batch: int = 8192,
                 value_dim: int | None = None,
                 stats: "IngestStats | None" = None):
        if not engines:
            raise ValueError("IngestPipeline needs at least one engine")
        for eng in engines:
            if getattr(getattr(eng, "plan", None), "routes", None) is None:
                raise not_ported("stacked shard engines in the ingest ring",
                                 "10")
        self.engines = list(engines)
        self.device = self.engines[0].device
        self.depth = max(1, int(depth))
        self.device_batch = bucket_batch(int(device_batch))
        if value_dim is None:
            value_dim = self.engines[0].spec.value_dim
        self.value_dim = int(value_dim)
        B = self.device_batch
        vshape = (B,) if self.value_dim == 1 else (B, self.value_dim)
        pin = self.device.type == "cuda"
        # each slot: a pinned host tensor of values (the device copy reads
        # it) with a numpy view that submit fills; ids stay host-only
        self._vals_t = [torch.zeros(vshape, dtype=torch.float32,
                                    pin_memory=pin)
                        for _ in range(self.depth)]
        self._vals = [t.numpy() for t in self._vals_t]
        self._ids = [np.zeros(B, np.int64) for _ in range(self.depth)]
        self._tokens: list = [None] * self.depth
        self._busy = [False] * self.depth
        # per-slot fired-set readback marks: [(AlertSet, seq)] recorded at
        # dispatch, collected once the slot's token proves those steps done
        self._alert_marks: list = [None] * self.depth
        self._slot = 0
        self._fill = 0
        self.stats = stats if stats is not None else IngestStats()

    # ------------------------------------------------------------------ intake
    def submit(self, ids, values=None) -> None:
        """Feed a batch of events (any size) into the ring. Dispatches each
        slot the moment it fills; waits only on ring backpressure."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if values is None:
            values = np.ones(len(ids), np.float32)
        vals = np.asarray(values, np.float32)
        want = (len(ids),) if self.value_dim == 1 \
            else (len(ids), self.value_dim)
        if vals.shape != want:
            raise ValueError(f"submit values shape {vals.shape} != {want} "
                             f"(pipeline value_dim={self.value_dim})")
        self.stats.events_in += len(ids)
        B, off = self.device_batch, 0
        while off < len(ids):
            take = min(B - self._fill, len(ids) - off)
            s, f = self._slot, self._fill
            self._ids[s][f: f + take] = ids[off: off + take]
            self._vals[s][f: f + take] = vals[off: off + take]
            self._fill += take
            off += take
            if self._fill == B:
                self._dispatch(B)

    # ---------------------------------------------------------------- dispatch
    def _dispatch(self, n: int) -> None:
        s, B = self._slot, self.device_batch
        ids, vals = self._ids[s], self._vals[s]
        if n < B:
            # partial slot (flush/drain): poison the tail so routing masks it
            ids[n:] = -1
            vals[n:] = 0.0
            self.stats.partial_batches += 1
        # the slot's values reach the device once, straight from pinned
        # memory; each engine zeroes its own dead lanes there
        vals_d = self._vals_t[s].to(self.device, non_blocking=True)
        dropped = n
        for eng in self.engines:
            rows, mask = eng.plan.routes.writer_rows(ids)
            n_live = int(np.count_nonzero(mask))
            dropped = min(dropped, n - n_live)
            # expand this coalesced device batch's frontier here (host side,
            # before dispatch): the sparse-vs-dense decision and the
            # active-block bucket are pinned per batch, not per event
            act = eng.frontier_active(rows, mask, n_live=n_live)
            eng.write_rows(rows, vals_d, mask, n_live=n_live, active=act)
        self.stats.events_dispatched += n
        self.stats.events_dropped += dropped
        self.stats.batches += 1
        # the token: recorded after every engine's step for slot s (and the
        # alert buffers' copies behind them), so its completion frees the
        # slot's pinned values and proves those steps done
        if self.device.type == "cuda":
            tok = torch.cuda.Event()
            tok.record()
            self._tokens[s] = tok
        self._busy[s] = True
        marks = [(al, al.seq) for al in
                 (getattr(eng, "alerts", None) for eng in self.engines)
                 if al is not None]
        self._alert_marks[s] = marks or None
        self.stats.max_in_flight = max(self.stats.max_in_flight,
                                       sum(self._busy))
        # advance the ring; the next slot's buffers may still back an
        # in-flight step — the pipeline's only steady-state wait
        self._slot = (self._slot + 1) % self.depth
        self._fill = 0
        if self._busy[self._slot]:
            t0 = time.perf_counter()
            self._release(self._slot)
            self.stats.stall_s += time.perf_counter() - t0

    def _release(self, slot: int) -> None:
        """Wait for a slot's token, then collect the fired sets of the steps
        it proves done."""
        tok = self._tokens[slot]
        if tok is not None:
            tok.synchronize()
            self._tokens[slot] = None
        self._busy[slot] = False
        marks = self._alert_marks[slot]
        if marks is not None:
            self._alert_marks[slot] = None
            for al, upto in marks:
                al.collect_upto(upto)

    # ----------------------------------------------------------------- control
    def drain(self) -> None:
        """Dispatch the partial slot without waiting: a read issued next is
        queued after every submitted event's step."""
        if self._fill:
            self._dispatch(self._fill)

    def flush(self) -> None:
        """Pipeline barrier: dispatch the partial slot, then wait until
        every in-flight device step completed. Run before structural churn
        lands (``EagrSession.flush`` does)."""
        self.drain()
        t0 = time.perf_counter()
        for i in range(self.depth):
            if self._busy[i]:
                self._release(i)
        self.stats.barrier_s += time.perf_counter() - t0
        self.stats.flushes += 1

    @property
    def in_flight(self) -> int:
        return sum(self._busy)

    @property
    def pending(self) -> int:
        """Events accumulated in the current slot, not yet dispatched."""
        return self._fill
