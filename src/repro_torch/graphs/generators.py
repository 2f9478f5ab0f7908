"""Synthetic graph generators.

The paper evaluates on LiveJournal / Google+ / web graphs. Those are not available
offline, so benchmarks use R-MAT graphs (the standard synthetic stand-in with
power-law degree distributions matching social/web graphs) plus small fixtures.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import CSRGraph


def rmat_graph(
    n_nodes: int,
    n_edges: int,
    *,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    symmetric: bool = False,
) -> CSRGraph:
    """R-MAT (Chakrabarti et al.) power-law graph. Defaults mimic social graphs."""
    rng = np.random.default_rng(seed)
    scale = max(1, int(np.ceil(np.log2(max(2, n_nodes)))))
    # Oversample to compensate for dedup + self-loop removal.
    m = int(n_edges * 1.15) + 16
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab = a + b
    abc = a + b + c
    for level in range(scale):
        r = rng.random(m)
        go_right = (r >= a) & (r < ab) | (r >= abc)
        go_down = r >= ab
        bit = np.int64(1) << (scale - 1 - level)
        src += bit * go_down
        dst += bit * go_right
    src %= n_nodes
    dst %= n_nodes
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if symmetric:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    src, dst = src[: n_edges * (2 if symmetric else 1)], dst[: n_edges * (2 if symmetric else 1)]
    return CSRGraph.from_edges(src, dst, n_nodes)


def powerlaw_graph(n_nodes: int, n_edges: int, *, beta: float = 0.75,
                   sharing: float = 0.0, group: int = 16,
                   seed: int = 0) -> CSRGraph:
    """Memory-lean power-law graph for million-node benches.

    Edge destinations are drawn by inverse-CDF from a rank-weighted
    distribution w_rank ∝ rank^-beta over a random node permutation (tail
    exponent of the in-degree distribution ≈ 1 + 1/beta ≈ 2.3 at the default,
    the social/web-graph regime); sources are uniform. Everything stays in
    flat int32/float64 arrays — no Python edge lists — so peak memory is a
    few hundred MB at 10M edges instead of the GBs a list-of-tuples costs.

    ``sharing`` (0..1) routes that fraction of each reader's in-edges to a
    writer set shared by its group of ``group`` consecutive readers — the
    vectorized analogue of ``copying_graph``'s shared-adjacency structure,
    i.e. the compressible regime where the paper reports high sharing
    indices. 0 keeps pure i.i.d. power-law edges (SI ~ 0).
    """
    rng = np.random.default_rng(seed)
    w = np.arange(1, n_nodes + 1, dtype=np.float64) ** (-beta)
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    perm = rng.permutation(n_nodes).astype(np.int32)

    def powerlaw_nodes(k: int) -> np.ndarray:
        return perm[np.searchsorted(cdf, rng.random(k)).astype(np.int32)]

    n_shared = int(round(n_edges / n_nodes * sharing)) if sharing > 0 else 0
    parts_src, parts_dst = [], []
    if n_shared:
        n_groups = (n_nodes + group - 1) // group
        proto = powerlaw_nodes(n_groups * n_shared).reshape(n_groups, n_shared)
        readers = np.arange(n_nodes, dtype=np.int32)
        parts_src.append(proto[readers // group].ravel())
        parts_dst.append(np.repeat(readers, n_shared))
    m = int((n_edges - n_shared * n_nodes) * 1.08) + 16  # dedup/self-loop slack
    parts_src.append(rng.integers(0, n_nodes, m, dtype=np.int32))
    parts_dst.append(powerlaw_nodes(m))
    src = np.concatenate(parts_src)
    dst = np.concatenate(parts_dst)
    keep = src != dst
    src, dst = src[keep][:n_edges], dst[keep][:n_edges]
    return CSRGraph.from_edges(src, dst, n_nodes)


def copying_graph(n_nodes: int, out_degree: int = 8, copy_p: float = 0.7,
                  seed: int = 0) -> CSRGraph:
    """Kleinberg/Kumar 'copying model' web graph: each new node copies a
    random fraction of a prototype's out-links. Produces the shared-adjacency
    structure that makes real web graphs highly compressible — the regime
    where the paper reports SI ~0.7-0.8 (vs ~0.1 for social graphs)."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    adj: list[np.ndarray] = [np.zeros(0, dtype=np.int64)]
    for v in range(1, n_nodes):
        proto = int(rng.integers(0, v))
        proto_links = adj[proto]
        links = []
        for j in range(out_degree):
            if proto_links.size and rng.random() < copy_p:
                links.append(int(proto_links[j % proto_links.size]))
            else:
                links.append(int(rng.integers(0, v)))
        links = np.unique(np.array(links, dtype=np.int64))
        links = links[links != v]
        adj.append(links)
        src.extend([v] * links.size)
        dst.extend(links.tolist())
    return CSRGraph.from_edges(np.array(src), np.array(dst), n_nodes)


def erdos_graph(n_nodes: int, n_edges: int, seed: int = 0) -> CSRGraph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges * 2)
    dst = rng.integers(0, n_nodes, n_edges * 2)
    keep = src != dst
    return CSRGraph.from_edges(src[keep][:n_edges], dst[keep][:n_edges], n_nodes)


def cora_like_graph(
    n_nodes: int = 2708, n_edges: int = 10556, d_feat: int = 1433, n_classes: int = 7, seed: int = 0
):
    """Citation-network stand-in with Cora's statistics: returns (graph, features, labels)."""
    g = rmat_graph(n_nodes, n_edges // 2, seed=seed, symmetric=True)
    rng = np.random.default_rng(seed + 1)
    feats = (rng.random((n_nodes, d_feat)) < 0.012).astype(np.float32)  # sparse bag-of-words
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    return g, feats, labels


def small_example_graph() -> CSRGraph:
    """The paper's running example (Figure 1a).

    Nodes a..g = 0..6. N(x) = {y | y -> x}; edges encoded so that the bipartite
    construction reproduces Figure 1(b):
      N(a)={c,d,e,f}, N(b)={c,d,e,f}, N(c)={a,b,d,e,f}, N(d)={a,b,c},
      N(e)={a,b,c,d}, N(f)={a,b,c,d,e}, N(g)={a,b,c,d,e,f}
    """
    N = {
        0: [2, 3, 4, 5],
        1: [2, 3, 4, 5],
        2: [0, 1, 3, 4, 5],
        3: [0, 1, 2],
        4: [0, 1, 2, 3],
        5: [0, 1, 2, 3, 4],
        6: [0, 1, 2, 3, 4, 5],
    }
    src, dst = [], []
    for reader, writers in N.items():
        for w in writers:
            src.append(w)
            dst.append(reader)
    return CSRGraph.from_edges(np.array(src), np.array(dst), 7)
