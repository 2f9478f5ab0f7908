"""Fault tolerance: checkpoint/restart drivers and straggler detection.

``FaultTolerantRunner`` wraps any ``(state, batch) -> (state, metrics)``
step function over a tree of tensors (nested dicts, tuples, NamedTuples:
a training state ``(params, opt_state)``):
  * periodic async checkpoints (:class:`CheckpointManager`),
  * on a step failure (a lost device surfaces as an exception), restore the
    latest checkpoint and REPLAY the data stream deterministically (the data
    iterator is seeded by step index, so skipping to the restored step
    reproduces the exact batch sequence),
  * per-step wall-time tracking with a robust z-score straggler detector —
    it flags and records slow steps.

``SessionRecoveryDriver`` is the same loop over a durable
:class:`repro_torch.session.EagrSession`.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable

import numpy as np

from repro_torch.distributed.checkpoint import CheckpointManager


@dataclasses.dataclass
class StragglerDetector:
    """Flags steps slower than median + z * MAD over a sliding window."""

    window: int = 64
    z: float = 4.0
    times: deque = dataclasses.field(default_factory=lambda: deque(maxlen=64))
    flagged: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        ts = np.array(self.times) if self.times else np.array([seconds])
        med = float(np.median(ts))
        mad = float(np.median(np.abs(ts - med))) + 1e-9
        is_straggler = len(self.times) >= 8 and \
            seconds > med + self.z * 1.4826 * mad
        if is_straggler:
            self.flagged.append((step, seconds, med))
        self.times.append(seconds)
        return is_straggler


@dataclasses.dataclass
class RunReport:
    steps_run: int = 0
    restarts: int = 0
    checkpoints: int = 0
    stragglers: list = dataclasses.field(default_factory=list)
    losses: list = dataclasses.field(default_factory=list)


class FaultTolerantRunner:
    """Drives a step loop with checkpoint/restart semantics over a tree of
    tensors (see :meth:`CheckpointManager.save`).

    ``make_batch(step)`` must be deterministic in ``step`` — that is what
    makes replay-after-restore exact.
    """

    def __init__(self, step_fn: Callable, make_batch: Callable[[int], Any],
                 ckpt: CheckpointManager, *, ckpt_every: int = 50,
                 max_restarts: int = 3):
        self.step_fn = step_fn
        self.make_batch = make_batch
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.detector = StragglerDetector()

    def run(self, state, n_steps: int, *, start_step: int = 0,
            fail_at: set[int] | None = None) -> tuple[Any, RunReport]:
        """``fail_at``: steps at which to inject a simulated node failure
        (tests)."""
        report = RunReport()
        step = start_step
        restarts = 0
        while step < n_steps:
            try:
                if fail_at and step in fail_at:
                    fail_at.discard(step)
                    raise RuntimeError(f"injected node failure at step {step}")
                t0 = time.perf_counter()
                batch = self.make_batch(step)
                state, metrics = self.step_fn(state, batch)
                dt = time.perf_counter() - t0
                if self.detector.observe(step, dt):
                    report.stragglers.append(step)
                if metrics is not None and "loss" in metrics:
                    report.losses.append(float(metrics["loss"]))
                step += 1
                report.steps_run += 1
                if step % self.ckpt_every == 0:
                    self.ckpt.save(step, state, blocking=False)
                    report.checkpoints += 1
            except Exception:
                restarts += 1
                report.restarts += 1
                if restarts > self.max_restarts:
                    raise
                self.ckpt.wait()
                restored = self.ckpt.latest_step()
                if restored is None:
                    step = start_step  # restart from scratch
                    continue
                state, _ = self.ckpt.restore(state, restored)
                step = restored      # deterministic data replay from here
        self.ckpt.wait()
        return state, report


class SessionRecoveryDriver:
    """Crash-recovery loop over a durable
    :class:`repro_torch.session.EagrSession`.

    The session's update-batch sequence number (``session._seq``, the step
    a checkpoint commits under) is the authoritative stream position:
    ``make_batch(seq)`` must be deterministic in ``seq``, and after a crash
    the driver restores the latest committed checkpoint and replays from
    its recorded sequence number — the restored engine state plus the
    replayed suffix reproduces the uninterrupted run bit for bit.

    ``make_session()`` builds the cold session (on first start, and when a
    crash precedes the first committed checkpoint); restores land on
    ``device`` (CUDA unless the caller names another).
    """

    def __init__(self, make_session: Callable[[], Any],
                 make_batch: Callable[[int], Any], directory: str, *,
                 ckpt_every: int = 16, max_restarts: int = 3, device=None):
        self.make_session = make_session
        self.make_batch = make_batch
        self.directory = directory
        self.ckpt_every = max(1, int(ckpt_every))
        self.max_restarts = max_restarts
        self.device = device
        self.report = RunReport()

    def _boot(self):
        mgr = CheckpointManager(self.directory)
        if mgr.latest_step() is None:
            return self.make_session()
        from repro_torch.session import EagrSession
        return EagrSession.restore(self.directory, device=self.device)

    def run(self, n_batches: int, *,
            fail_at: "set[int] | None" = None) -> Any:
        """Feed batches 0..n_batches-1 through the session with periodic
        checkpoints; on a failure (injected via ``fail_at`` step indices, or
        any exception out of the update path) restore and replay. Returns
        the live session positioned at ``_seq == n_batches``."""
        session = self._boot()
        restarts = 0
        while session._seq < n_batches:
            try:
                seq = session._seq
                if fail_at and seq in fail_at:
                    fail_at.discard(seq)
                    raise RuntimeError(
                        f"injected node failure at batch {seq}")
                ids, values = self.make_batch(seq)
                session.update(ids, values)
                self.report.steps_run += 1
                if session._seq % self.ckpt_every == 0:
                    session.save(self.directory, blocking=False)
                    self.report.checkpoints += 1
            except Exception:
                restarts += 1
                self.report.restarts += 1
                if restarts > self.max_restarts:
                    raise
                session.wait_for_checkpoint()
                session = self._boot()  # replay resumes at the saved _seq
        session.wait_for_checkpoint()
        return session
