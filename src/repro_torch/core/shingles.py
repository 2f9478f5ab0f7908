"""Min-hash shingle ordering of readers (paper §3.2.1, after Buehrer et al. /
Chierichetti et al.). Readers with similar input lists get similar shingle
tuples, so a lexicographic sort clusters biclique candidates together.

Two entry points:
  * ``shingle_order`` — the historical dict API (reader -> item array),
  * ``shingle_order_csr`` — the batched path: one ``np.minimum.reduceat`` per
    hash over a CSR view of *all* reader lists, no per-reader Python work.
Both produce identical orderings (readers sorted by shingle tuple, ties by id).
"""
from __future__ import annotations

import numpy as np

_MIX = np.uint64(0x9E3779B97F4A7C15)
_MASK64 = (1 << 64) - 1


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + _MIX).astype(np.uint64)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def seed_mix(seed: int) -> int:
    """splitmix64 of the seed as a plain int — the per-hash constant that
    ``shingle_value`` used to recompute (with a fresh 1-element array) on
    every call. Python-int arithmetic: numpy uint64 *scalars* warn on
    wraparound, arrays don't."""
    x = (int(seed) + 0x9E3779B97F4A7C15) & _MASK64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _MASK64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _MASK64
    x ^= x >> 31
    return x


def hash_items(items: np.ndarray, premix: int) -> np.ndarray:
    """Element-wise splitmix64 of ``items`` under a premixed seed constant."""
    return _splitmix64(items.astype(np.uint64) ^ np.uint64(premix))


def shingle_value(items: np.ndarray, seed: int) -> int:
    """min-hash of an item set under hash seed ``seed``."""
    if items.size == 0:
        return 0
    return int(hash_items(np.asarray(items), seed_mix(seed)).min())


def min_hashes_csr(indptr: np.ndarray, values: np.ndarray, n_hashes: int,
                   seed: int) -> np.ndarray:
    """(n_rows, n_hashes) min-hash matrix over a CSR item array: one
    vectorized hash + one ``np.minimum.reduceat`` per hash function.
    Empty rows hash to 0 (matching ``shingle_value`` on an empty array)."""
    n_rows = indptr.size - 1
    out = np.zeros((n_rows, n_hashes), dtype=np.uint64)
    if values.size == 0:
        return out
    sizes = np.diff(indptr)
    nonempty = sizes > 0
    # reduceat over the non-empty rows only: their start offsets are exactly
    # the segment boundaries (empty rows contribute no values in between);
    # empty rows keep the 0 fill.
    starts = indptr[:-1][nonempty].astype(np.int64)
    vals = np.asarray(values)
    for i in range(n_hashes):
        h = hash_items(vals, seed_mix(seed + i))
        out[nonempty, i] = np.minimum.reduceat(h, starts)
    return out


def shingle_order_csr(row_ids: np.ndarray, indptr: np.ndarray,
                      values: np.ndarray, n_hashes: int = 2,
                      seed: int = 0) -> np.ndarray:
    """Row ids sorted lexicographically by shingle tuple, ties by id."""
    mh = min_hashes_csr(indptr, values, n_hashes, seed)
    keys = tuple(mh[:, i] for i in reversed(range(n_hashes))) + ()
    order = np.lexsort((row_ids,) + keys)
    return np.asarray(row_ids)[order]


def shingle_order(input_lists: dict[int, np.ndarray], n_hashes: int = 2,
                  seed: int = 0) -> list[int]:
    """Return reader ids sorted lexicographically by their shingle tuples."""
    if not input_lists:
        return []
    rids = np.fromiter(input_lists.keys(), dtype=np.int64,
                       count=len(input_lists))
    arrays = [np.asarray(input_lists[int(r)]) for r in rids]
    sizes = np.array([a.size for a in arrays], dtype=np.int64)
    indptr = np.zeros(rids.size + 1, dtype=np.int64)
    np.cumsum(sizes, out=indptr[1:])
    values = (np.concatenate(arrays) if indptr[-1]
              else np.zeros(0, dtype=np.int64))
    return [int(r) for r in shingle_order_csr(rids, indptr, values,
                                              n_hashes=n_hashes, seed=seed)]
