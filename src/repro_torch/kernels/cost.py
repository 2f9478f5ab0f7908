"""Each kernel's work: the operations and bytes of one call, the card's
peaks they are held to, and the counters every wrapper adds its calls to.

The cost functions of ``kernels/*/ops.py`` give one call's ``Work`` from
its shapes (and, where the work depends on the data, from the counts a
caller passes): every input read once, every output written once, and the
operations on them at the rate of their type. ``bound_ms`` is the least
time the card could take: the larger of the bytes over the memory rate and
the operations over the peak rate. The peaks are one H100 SXM5's, from
NVIDIA's data sheet: 3.35 TB/s of HBM3, 67 TFLOP/s fp32 on the CUDA cores,
989.4 TFLOP/s dense bf16 on the tensor cores.

Each wrapper adds its call's work to its module's ``WORK`` counter
(``WorkCounter``, keyed as the module's ``LAUNCHES``) while ``counting()``
is on, on either path, the kernel on the card or the plain version on the
CPU, with the counts its shapes give (it reads no tensor back to the host
for them). It then runs its body with the dispatch modes popped: a counting
mode above it (the dry run's ``FlopCounterMode``) sees the wrapper's
formula and not the plain version's own matmuls a second time. With
counting off (every path but the dry run's counted step) a wrapper runs
its body and nothing else.
"""
from __future__ import annotations

import contextlib
import dataclasses

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989.4e12
RATES = {"fp32": FP32_OPS_PER_S, "bf16": BF16_OPS_PER_S}


@dataclasses.dataclass(frozen=True)
class Work:
    """One call's operations (at the rate of ``rate``) and bytes moved."""

    ops: int
    bytes: int
    rate: str = "fp32"

    def __add__(self, other: Work) -> Work:
        if other.rate != self.rate:
            raise ValueError(f"adding {self.rate} and {other.rate} work")
        return Work(self.ops + other.ops, self.bytes + other.bytes, self.rate)


def bound_ms(work: Work) -> tuple[float, str]:
    """The least time of ``work`` on the card, in ms, and what bounds it
    (``"bytes"`` or ``"operations"``)."""
    t_bytes = work.bytes / HBM_BYTES_PER_S * 1e3
    t_ops = work.ops / RATES[work.rate] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


class WorkCounter:
    """Calls, operations and bytes per entry since the last reset, on
    either path (plain Python ints)."""

    def __init__(self, keys):
        self.keys = tuple(keys)
        self.reset()

    def reset(self) -> None:
        self.calls = dict.fromkeys(self.keys, 0)
        self.ops = dict.fromkeys(self.keys, 0)
        self.bytes = dict.fromkeys(self.keys, 0)

    def add(self, key: str, work: Work) -> None:
        self.calls[key] += 1
        self.ops[key] += work.ops
        self.bytes[key] += work.bytes

    def snapshot(self) -> dict:
        """``{key: {"calls", "ops", "bytes"}}`` of every entry called."""
        return {k: dict(calls=self.calls[k], ops=self.ops[k],
                        bytes=self.bytes[k])
                for k in self.keys if self.calls[k]}


def counters() -> dict:
    """Every kernel module's ``WORK`` counter, by module name."""
    from repro_torch.kernels.embedding_bag import ops as bag
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.segment_agg import ops as seg

    return {"segment_agg": seg.WORK, "flash_attention": flash.WORK,
            "embedding_bag": bag.WORK}


def reset_all() -> None:
    for c in counters().values():
        c.reset()


def snapshot_all() -> dict:
    """``{module: {key: {"calls", "ops", "bytes"}}}`` of every entry
    called since the last reset."""
    return {name: snap for name, c in counters().items()
            if (snap := c.snapshot())}


_COUNTING = [False]


@contextlib.contextmanager
def counting():
    """Turn the wrappers' ``WORK`` counters on for the block."""
    was = _COUNTING[0]
    _COUNTING[0] = True
    try:
        yield
    finally:
        _COUNTING[0] = was


def counted(counter: WorkCounter, work, run, *args):
    """A wrapper's body: ``run(*args)``. While ``counting()`` is on it runs
    with every dispatch mode popped (pushed back after) and ``work()``, the
    call's ``(key, Work)``, is added to ``counter``."""
    if not _COUNTING[0]:
        return run(*args)
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        out = run(*args)
    counter.add(*work())
    return out
