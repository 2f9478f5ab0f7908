"""Read/write trace generation and playback (paper §5.1), host numpy.

The paper drives experiments with Zipfian read/write frequencies (event rates
in Twitter/Yahoo! follow Zipf [Breslau et al.; Silberstein et al.]) plus real
HTTP packet traces. Offline here, we generate Zipfian traces with a
configurable write:read ratio and linear read~write correlation, plus a
``shift_workload`` transform reproducing the §5.3 adaptivity experiment
(read frequencies of the worst-latency nodes are boosted mid-trace).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

WRITE, READ = 0, 1


@dataclasses.dataclass
class Trace:
    kind: np.ndarray    # (n_events,) 0=write 1=read
    node: np.ndarray    # (n_events,) base node id
    value: np.ndarray   # (n_events,) fp32 payload (writes; topic id for TOP-K)
    write_freq: np.ndarray  # per-base-node expected write frequency
    read_freq: np.ndarray   # per-base-node expected read frequency

    @property
    def n_events(self) -> int:
        return int(self.kind.size)


def zipf_frequencies(n: int, alpha: float = 1.0, seed: int = 0) -> np.ndarray:
    """Normalized Zipf(alpha) frequencies randomly assigned to n nodes."""
    rng = np.random.default_rng(seed)
    ranks = rng.permutation(n) + 1
    f = 1.0 / np.power(ranks.astype(np.float64), alpha)
    return f / f.sum()


def generate_trace(
    writers: np.ndarray,
    readers: np.ndarray,
    n_events: int,
    *,
    write_read_ratio: float = 1.0,
    alpha: float = 1.0,
    value_domain: int = 64,
    seed: int = 0,
    n_base: int | None = None,
    value_dim: int = 1,
) -> Trace:
    """Zipfian trace over the given writer/reader id sets. Read frequency of a
    node is linearly related to its write frequency (paper §5.1).
    ``value_dim > 1`` emits vector payloads (n_events, value_dim) — e.g.
    topic-distribution writes for vector-PAO workloads."""
    rng = np.random.default_rng(seed)
    n_base = n_base or int(max(writers.max(initial=0), readers.max(initial=0))) + 1

    wf = np.zeros(n_base)
    wf[writers] = zipf_frequencies(len(writers), alpha, seed)
    rf = np.zeros(n_base)
    # linear read~write correlation where both roles exist; fresh Zipf otherwise
    common = np.intersect1d(writers, readers)
    rf[common] = wf[common]
    only_read = np.setdiff1d(readers, common)
    if only_read.size:
        rf[only_read] = zipf_frequencies(len(only_read), alpha, seed + 1) * wf.sum() * 0.1
    rf = rf / max(rf.sum(), 1e-12)

    p_write = write_read_ratio / (1.0 + write_read_ratio)
    kind = (rng.random(n_events) >= p_write).astype(np.int8)
    node = np.empty(n_events, dtype=np.int64)
    n_w = int((kind == WRITE).sum())
    node[kind == WRITE] = rng.choice(writers, size=n_w, p=wf[writers] / wf[writers].sum())
    node[kind == READ] = rng.choice(readers, size=n_events - n_w,
                                    p=rf[readers] / rf[readers].sum())
    vshape = (n_events,) if value_dim == 1 else (n_events, value_dim)
    value = rng.integers(0, value_domain, size=vshape).astype(np.float32)
    scale = n_events / max(1.0, 1.0 + write_read_ratio)
    return Trace(kind=kind, node=node, value=value,
                 write_freq=wf * write_read_ratio * scale, read_freq=rf * scale)


def shift_workload(trace: Trace, boost_nodes: np.ndarray, factor: float = 10.0,
                   seed: int = 0) -> Trace:
    """§5.3 adaptivity experiment: boost read frequencies of ``boost_nodes``
    and resample the read events accordingly."""
    rng = np.random.default_rng(seed)
    rf = trace.read_freq.copy()
    rf[boost_nodes] *= factor
    readers = np.flatnonzero(rf > 0)
    node = trace.node.copy()
    rmask = trace.kind == READ
    node[rmask] = rng.choice(readers, size=int(rmask.sum()), p=rf[readers] / rf[readers].sum())
    return Trace(kind=trace.kind.copy(), node=node, value=trace.value.copy(),
                 write_freq=trace.write_freq.copy(), read_freq=rf)


def batched_playback(trace: Trace, batch: int, pad: bool = False) -> Iterator[tuple]:
    """Play the trace back as homogeneous batches: consecutive events of the
    same kind are grouped (up to ``batch``), matching the engine's batched
    write/read entry points while preserving global order across kinds.

    With ``pad=True`` every yielded batch has exactly ``batch`` rows and an
    extra ``n_live`` count: (kind, ids, vals, n_live). Padding rows repeat the
    run's last event id (so padded ids stay valid for their kind) with zeroed
    values; consumers must mask or slice by ``n_live`` — e.g. slice before
    ``write_batch``, or ignore answer rows past ``n_live`` after a read.
    Fixed shapes mean downstream batch routers never see ragged tails."""
    i = 0
    n = trace.n_events
    while i < n:
        k = trace.kind[i]
        j = i
        while j < n and j - i < batch and trace.kind[j] == k:
            j += 1
        ids = trace.node[i:j]
        vals = trace.value[i:j]
        if pad:
            n_live = j - i
            ids = np.concatenate(
                [ids, np.full(batch - n_live, ids[-1], ids.dtype)])
            vals = np.concatenate(
                [vals, np.zeros((batch - n_live,) + vals.shape[1:], vals.dtype)])
            yield ("write" if k == WRITE else "read", ids, vals, n_live)
        else:
            yield ("write" if k == WRITE else "read", ids, vals)
        i = j
