"""Vectorized FP-tree biclique mining over rank-sorted rows ('basic'/'dup').

With the item order frozen for a mining group, each reader's transaction is an
ascending *rank sequence* (its row), and the group's FP-tree is exactly the
trie of those rows. That gives an array representation of everything
``FPTree.mine_best`` computes:

  * every trie node is a prefix P shared by >= 1 rows, and the rows sharing P
    form one lexicographically contiguous block — so sorting the rows once
    (bytes memcmp == tuple order for equal-width big-endian ranks) and taking
    longest-common-prefix lengths between neighbours enumerates all candidate
    (prefix, support) pairs without building a single node object;
  * a mined path is always a full prefix of its supporting rows, so applying a
    biclique is a shift-and-append on those rows: ``row[d:] + [vid_rank]``
    ('basic') or flag-prefix-as-mined-and-append ('dup'). New virtual items
    take the next rank, so rows stay rank-ascending with no re-sort.

Tie-breaks mirror ``FPTree.mine_best``: maximum benefit, then the
lexicographically smallest rank sequence. 'neg' mode stays on the object tree
(path picking is inherently sequential per reader).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RowBiclique:
    path: np.ndarray       # rank sequence; ranks >= the initial count are group-local vids
    support: int           # |S| — all rows sharing the prefix
    consumers: np.ndarray  # row indices whose rows were rewritten
    benefit: int


def _lcp(a: np.ndarray, b: np.ndarray) -> int:
    m = min(a.size, b.size)
    if m == 0:
        return 0
    neq = a[:m] != b[:m]
    i = int(neq.argmax())
    return m if not neq[i] else i


def _key(row: np.ndarray) -> bytes:
    # big-endian u4 bytes: memcmp order == tuple order for non-negative ranks,
    # including prefix < extension.
    return row.astype(">u4").tobytes()


def mine_rows(rows: list[np.ndarray], flags: list[np.ndarray] | None,
              dup: bool, n_ranks: int,
              max_bicliques: int = 64) -> list[RowBiclique]:
    """Mine up to ``max_bicliques`` positive-benefit bicliques from rank rows.

    ``rows`` (and ``flags`` when ``dup``) are mutated in place to their
    post-mining state. Returns the applied bicliques in application order;
    the j-th biclique's virtual item has rank ``n_ranks + j``.
    """
    n = len(rows)
    out: list[RowBiclique] = []
    if n < 2:
        return out
    keys = [_key(r) for r in rows]
    cums = [np.cumsum(f, dtype=np.int64) for f in flags] if dup else None
    next_rank = n_ranks

    while len(out) < max_bicliques:
        perm = sorted(range(n), key=keys.__getitem__)
        srows = [rows[i] for i in perm]
        lcp = np.fromiter((_lcp(srows[i], srows[i + 1]) for i in range(n - 1)),
                          dtype=np.int64, count=n - 1)
        maxd = int(lcp.max()) if lcp.size else 0
        if maxd < 2:
            break
        if dup:
            depths = range(2, maxd + 1)  # reuse penalty is not monotone in d
        else:
            # benefit strictly grows with d at fixed support, so only the
            # largest d yielding each support partition can win
            depths = [int(v) for v in np.unique(lcp) if v >= 2]

        best = None  # (benefit, path_tuple, d, sorted_start, support)
        for d in depths:
            idx = np.flatnonzero(lcp >= d)
            if idx.size == 0:
                continue
            splits = np.flatnonzero(np.diff(idx) > 1)
            starts = np.concatenate([[0], splits + 1])
            ends = np.concatenate([splits, [idx.size - 1]])
            for a, b in zip(starts, ends):
                lo = int(idx[a])
                s = int(idx[b]) - lo + 2
                benefit = d * s - d - s
                if dup:
                    benefit -= sum(int(cums[perm[i]][d - 1])
                                   for i in range(lo, lo + s))
                if benefit <= 0 or (best is not None and benefit < best[0]):
                    continue
                pt = tuple(int(x) for x in srows[lo][:d])
                if best is None or benefit > best[0] or pt < best[1]:
                    best = (benefit, pt, d, lo, s)
        if best is None:
            break

        benefit, _, d, lo, s = best
        members = [perm[i] for i in range(lo, lo + s)]
        if dup:
            # a supporter consumes only if the prefix still covers >= 1 of its
            # active (unmined) items; all-mined supporters keep their edges
            consumers = [i for i in members if d - int(cums[i][d - 1]) >= 1]
        else:
            consumers = members
        if len(consumers) < 2:
            break  # matches _apply_biclique: < 2 consumers -> no rewrite

        path = rows[members[0]][:d].copy()
        vid_rank = next_rank
        next_rank += 1
        for i in consumers:
            if dup:
                flags[i][:d] = True
                rows[i] = np.append(rows[i], vid_rank)
                flags[i] = np.append(flags[i], False)
                cums[i] = np.cumsum(flags[i], dtype=np.int64)
            else:
                rows[i] = np.append(rows[i][d:], vid_rank)
            keys[i] = _key(rows[i])
        out.append(RowBiclique(path=path, support=s,
                               consumers=np.array(sorted(consumers),
                                                  dtype=np.int64),
                               benefit=benefit))
    return out
