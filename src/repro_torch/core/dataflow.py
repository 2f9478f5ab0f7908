"""Dataflow (push/pull pre-computation) decisions (paper §4).

Pipeline: read/write frequencies -> push/pull frequencies f_h/f_l (§4.1) ->
node weights w(v) = PULL(v) - PUSH(v) (§4.3) -> P1/P2 pruning (§4.5) ->
min s-t cut per connected component (§4.4, optimal) or greedy (§4.6) ->
optional node splitting for partial pre-computation (§4.7) and adaptive
re-decision at the push/pull frontier (§4.8).
"""
from __future__ import annotations

import dataclasses
import math
import sys
from typing import Callable

import numpy as np

from repro_torch.core.maxflow import Dinic, INF
from repro_torch.core.overlay import Overlay

PUSH, PULL = 0, 1


@dataclasses.dataclass
class CostModel:
    """H(k) = avg cost of one push into a k-input node; L(k) = one pull (§4.2)."""

    H: Callable[[int], float]
    L: Callable[[int], float]
    name: str = "custom"


def cost_model_for(aggregate: str, window: int = 1) -> CostModel:
    a = aggregate.lower()
    if a in ("sum", "count", "avg", "topk", "top-k"):
        # incremental update is O(1); on-demand merge is O(k)
        return CostModel(H=lambda k: 1.0, L=lambda k: float(max(1, k)), name=a)
    if a in ("max", "min"):
        # priority-queue style incremental update: H ∝ log2 k (§4.2)
        return CostModel(H=lambda k: math.log2(max(2, k)), L=lambda k: float(max(1, k)), name=a)
    raise ValueError(f"unknown aggregate {aggregate}")


def calibrate_cost_model(aggregate, pao_dim: int = 1, sizes=(1, 2, 4, 8, 16, 32),
                         device=None) -> CostModel:
    """Paper §4.2: learn H()/L() by timing the aggregate implementation.
    ``aggregate`` is a repro_torch.core.aggregates.Aggregate. Fits L(k)=a*k+b, H const.
    Times ``segment_merge`` on ``device`` (CUDA unless the caller names
    another); CUDA work is synchronized around each call so the host clock
    sees the device time."""
    import time

    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    pulls = []
    for k in sizes:
        x = torch.ones((k, pao_dim), dtype=torch.float32, device=dev)
        seg = torch.zeros((k,), dtype=torch.int64, device=dev)
        aggregate.segment_merge(x, seg, 1)
        sync()
        t0 = time.perf_counter()
        for _ in range(20):
            aggregate.segment_merge(x, seg, 1)
            sync()
        pulls.append((k, (time.perf_counter() - t0) / 20))
    ks = np.array([k for k, _ in pulls], dtype=np.float64)
    ts = np.array([t for _, t in pulls], dtype=np.float64)
    a, b = np.polyfit(ks, ts, 1)
    h = float(ts[0])  # one-input update cost
    scale = max(h, 1e-12)
    return CostModel(H=lambda k: 1.0, L=lambda k: max(1.0, (a * k + b) / scale), name="calibrated")


# ---------------------------------------------------------------------- freqs
def compute_frequencies(
    overlay: Overlay, write_freq: np.ndarray, read_freq: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """f_h (push) and f_l (pull) frequencies per overlay node (§4.1).
    write_freq/read_freq are indexed by *base* node id."""
    n = overlay.n_nodes
    f_h = np.zeros(n, dtype=np.float64)
    f_l = np.zeros(n, dtype=np.float64)
    order = overlay.toposort()
    for v in order:
        if overlay.kinds[v] == "W":
            f_h[v] = float(write_freq[overlay.origin[v]])
        else:
            f_h[v] = sum(f_h[src] for src, _ in overlay.in_edges[v])
    out = overlay.out_edges()
    for v in reversed(order):
        if overlay.kinds[v] == "R":
            f_l[v] = float(read_freq[overlay.origin[v]])
        else:
            f_l[v] = sum(f_l[dst] for dst, _ in out[v])
    return f_h, f_l


def node_weights(
    overlay: Overlay,
    f_h: np.ndarray,
    f_l: np.ndarray,
    cost: CostModel,
    *,
    window: int = 1,
    writers_always_push: bool = True,
) -> np.ndarray:
    """w(v) = PULL(v) - PUSH(v); positive weight favors push (§4.3)."""
    n = overlay.n_nodes
    w = np.zeros(n, dtype=np.float64)
    for v in range(n):
        k = overlay.in_degree(v)
        if overlay.kinds[v] == "W":
            if writers_always_push:
                w[v] = INF  # §2.2.1: writer nodes are always annotated push
                continue
            k = window  # §4.2: writers implicitly aggregate their window
        w[v] = f_l[v] * cost.L(k) - f_h[v] * cost.H(k)
    return w


def push_pull_costs(overlay: Overlay, f_h, f_l, cost: CostModel, window: int = 1):
    n = overlay.n_nodes
    push = np.zeros(n)
    pull = np.zeros(n)
    for v in range(n):
        k = window if overlay.kinds[v] == "W" else overlay.in_degree(v)
        push[v] = f_h[v] * cost.H(max(1, k))
        pull[v] = f_l[v] * cost.L(max(1, k))
    return push, pull


def total_cost(overlay: Overlay, decisions: np.ndarray, f_h, f_l, cost: CostModel,
               window: int = 1) -> float:
    push, pull = push_pull_costs(overlay, f_h, f_l, cost, window)
    return float(np.where(decisions == PUSH, push, pull).sum())


# ---------------------------------------------------------------------- prune
@dataclasses.dataclass
class DecisionStats:
    n_nodes: int = 0
    n_pruned: int = 0
    n_components: int = 0
    largest_component: int = 0
    maxflow_nodes: int = 0

    @property
    def pruned_fraction(self) -> float:
        return self.n_pruned / max(1, self.n_nodes)


def _prune(overlay: Overlay, w: np.ndarray):
    """P1/P2 (§4.5): returns (decisions or -1, alive mask). Optimality-preserving
    (Theorem 4.2)."""
    n = overlay.n_nodes
    out = overlay.out_edges()
    indeg = np.array([overlay.in_degree(v) for v in range(n)], dtype=np.int64)
    outdeg = np.array([len(out[v]) for v in range(n)], dtype=np.int64)
    decided = np.full(n, -1, dtype=np.int64)
    alive = np.ones(n, dtype=bool)
    stack = list(range(n))
    while stack:
        v = stack.pop()
        if not alive[v]:
            continue
        if w[v] > 0 and indeg[v] == 0:
            decided[v] = PUSH
        elif w[v] < 0 and outdeg[v] == 0:
            decided[v] = PULL
        else:
            continue
        alive[v] = False
        for dst, _ in out[v]:
            if alive[dst]:
                indeg[dst] -= 1
                stack.append(dst)
        for src, _ in overlay.in_edges[v]:
            if alive[src]:
                outdeg[src] -= 1
                stack.append(src)
    return decided, alive


def _components(overlay: Overlay, alive: np.ndarray) -> list[list[int]]:
    n = overlay.n_nodes
    out = overlay.out_edges()
    seen = np.zeros(n, dtype=bool)
    comps = []
    for v in range(n):
        if not alive[v] or seen[v]:
            continue
        comp = []
        stack = [v]
        seen[v] = True
        while stack:
            u = stack.pop()
            comp.append(u)
            for x, _ in overlay.in_edges[u]:
                if alive[x] and not seen[x]:
                    seen[x] = True
                    stack.append(x)
            for x, _ in out[u]:
                if alive[x] and not seen[x]:
                    seen[x] = True
                    stack.append(x)
        comps.append(comp)
    return comps


def _mincut_component(overlay: Overlay, comp: list[int], w: np.ndarray) -> dict[int, int]:
    """Optimal (X, Y) partition of one component via s-t min cut (Theorem 4.1)."""
    idx = {v: i for i, v in enumerate(comp)}
    n = len(comp)
    d = Dinic(n + 2)
    s, t = n, n + 1
    for v in comp:
        if w[v] < 0:
            d.add_edge(s, idx[v], -w[v])
        elif w[v] > 0:
            d.add_edge(idx[v], t, w[v])
    for v in comp:
        for src, _ in overlay.in_edges[v]:
            if src in idx:
                d.add_edge(idx[src], idx[v], INF)
    d.max_flow(s, t)
    reach = d.reachable_from(s)
    return {v: (PULL if reach[idx[v]] else PUSH) for v in comp}


def decide_mincut(
    overlay: Overlay,
    write_freq: np.ndarray,
    read_freq: np.ndarray,
    cost: CostModel,
    *,
    window: int = 1,
    writers_always_push: bool = True,
) -> tuple[np.ndarray, DecisionStats]:
    """The paper's optimal polynomial-time algorithm: prune, then min-cut per
    remaining connected component."""
    sys.setrecursionlimit(max(sys.getrecursionlimit(), 10000))
    f_h, f_l = compute_frequencies(overlay, write_freq, read_freq)
    w = node_weights(overlay, f_h, f_l, cost, window=window,
                     writers_always_push=writers_always_push)
    decided, alive = _prune(overlay, w)
    stats = DecisionStats(n_nodes=overlay.n_nodes, n_pruned=int((~alive).sum()))
    comps = _components(overlay, alive)
    stats.n_components = len(comps)
    stats.largest_component = max((len(c) for c in comps), default=0)
    stats.maxflow_nodes = int(alive.sum())
    for comp in comps:
        for v, dec in _mincut_component(overlay, comp, w).items():
            decided[v] = dec
    # w == 0 nodes pruned neither way: either side is optimal; default push.
    decided[decided < 0] = PUSH
    return decided.astype(np.int64), stats


# ---------------------------------------------------------------------- greedy
def decide_greedy(
    overlay: Overlay,
    write_freq: np.ndarray,
    read_freq: np.ndarray,
    cost: CostModel,
    *,
    window: int = 1,
    writers_always_push: bool = True,
) -> np.ndarray:
    """Linear-time greedy alternative (§4.6). Valid but not always optimal."""
    TENT = 2
    f_h, f_l = compute_frequencies(overlay, write_freq, read_freq)
    push_c, pull_c = push_pull_costs(overlay, f_h, f_l, cost, window)
    dec = np.full(overlay.n_nodes, -1, dtype=np.int64)
    for v in overlay.toposort():
        if overlay.kinds[v] == "W":
            if writers_always_push or push_c[v] <= pull_c[v]:
                dec[v] = PUSH
            else:
                dec[v] = TENT
            continue
        ins = [src for src, _ in overlay.in_edges[v]]
        wants_pull = push_c[v] > pull_c[v]
        if any(dec[i] == PULL for i in ins):
            dec[v] = PULL
            for i in ins:
                if dec[i] == TENT:
                    dec[i] = PULL
        elif wants_pull and any(dec[i] == TENT for i in ins):
            dec[v] = PULL
            for i in ins:
                if dec[i] == TENT:
                    dec[i] = PULL
        elif wants_pull:
            dec[v] = TENT
        elif all(dec[i] == PUSH for i in ins):
            dec[v] = PUSH
        else:
            tent = [i for i in ins if dec[i] == TENT]
            cost_push = push_c[v] + sum(push_c[i] for i in tent)
            cost_pull = pull_c[v] + sum(pull_c[i] for i in tent)
            if cost_push <= cost_pull:
                dec[v] = PUSH
                for i in tent:
                    dec[i] = PUSH
            else:
                dec[v] = PULL
                for i in tent:
                    dec[i] = PULL
    dec[dec == TENT] = PULL
    return dec


# ---------------------------------------------------------------------- split
def split_nodes(
    overlay: Overlay,
    decisions: np.ndarray,
    write_freq: np.ndarray,
    read_freq: np.ndarray,
    cost: CostModel,
    *,
    window: int = 1,
) -> tuple[Overlay, np.ndarray, int]:
    """Partial pre-computation by splitting (§4.7): for each *pull* node v with
    pull frequency f and input push frequencies f_1<=...<=f_k, find l minimizing
        sum_{i<=l} f_i*H(l) + f*L(k-l+1)
    and split inputs 1..l into a pushed partial aggregate v'.

    (Documented deviation: the paper prints f*L(l) for the second term, under
    which l=0 is always optimal — a typo; the on-demand merge at v is over the
    k-l remaining inputs plus v', hence L(k-l+1).)
    """
    n0 = overlay.n_nodes
    f_h, f_l = compute_frequencies(overlay, write_freq, read_freq)
    new_dec = list(decisions)
    n_split = 0
    for v in range(n0):
        if decisions[v] != PULL or overlay.kinds[v] == "W":
            continue
        ins = list(overlay.in_edges[v])
        k = len(ins)
        if k < 3:
            continue
        # the pushed prefix may only contain inputs that are themselves push
        # (a push node's inputs must all be push, §2.2.1)
        pushable = sorted((e for e in ins if decisions[e[0]] == PUSH), key=lambda e: f_h[e[0]])
        others = [e for e in ins if decisions[e[0]] != PUSH]
        if len(pushable) < 2:
            continue
        freqs = [f_h[src] for src, _ in pushable]
        f = f_l[v]
        best_l, best_cost = 0, f * cost.L(k)
        prefix = 0.0
        for l in range(1, len(pushable)):
            prefix += freqs[l - 1]
            c = prefix * cost.H(l) + f * cost.L(k - l + 1)
            if c < best_cost:
                best_l, best_cost = l, c
        if best_l == 0:
            continue
        vp = overlay.add_node("I", -1)
        overlay.in_edges[vp] = pushable[:best_l]
        overlay.in_edges[v] = pushable[best_l:] + others + [(vp, 1)]
        new_dec.append(PUSH)
        n_split += 1
    return overlay, np.array(new_dec, dtype=np.int64), n_split


# ---------------------------------------------------------------------- adapt
def frontier_nodes(overlay: Overlay, decisions: np.ndarray) -> list[int]:
    """The push/pull frontier (§4.8): pull nodes whose inputs are all push, and
    push nodes whose consumers are all pull."""
    out = overlay.out_edges()
    res = []
    for v in range(overlay.n_nodes):
        ins = [s for s, _ in overlay.in_edges[v]]
        outs = [d for d, _ in out[v]]
        if decisions[v] == PULL and ins and all(decisions[i] == PUSH for i in ins):
            res.append(v)
        elif decisions[v] == PUSH and outs and all(decisions[o] == PULL for o in outs):
            if overlay.kinds[v] != "W":
                res.append(v)
    return res


def adapt_decisions(
    overlay: Overlay,
    decisions: np.ndarray,
    observed_write: np.ndarray,
    observed_read: np.ndarray,
    cost: CostModel,
    *,
    window: int = 1,
    rounds: int = 4,
) -> tuple[np.ndarray, int]:
    """Unilaterally flip frontier nodes whose observed-frequency costs favor the
    other decision (§4.8). Each flip may expose new frontier nodes."""
    dec = decisions.copy()
    f_h, f_l = compute_frequencies(overlay, observed_write, observed_read)
    push_c, pull_c = push_pull_costs(overlay, f_h, f_l, cost, window)
    n_flips = 0
    for _ in range(rounds):
        flipped = 0
        for v in frontier_nodes(overlay, dec):
            if dec[v] == PULL and push_c[v] < pull_c[v]:
                dec[v] = PUSH
                flipped += 1
            elif dec[v] == PUSH and pull_c[v] < push_c[v]:
                dec[v] = PULL
                flipped += 1
        n_flips += flipped
        if flipped == 0:
            break
    return dec, n_flips
