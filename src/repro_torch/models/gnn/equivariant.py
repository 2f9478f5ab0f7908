"""O(3)-equivariant substrate for NequIP: real spherical harmonics, numeric
Wigner-D matrices, and Clebsch-Gordan intertwiners.

Convention-free construction: instead of importing a CG table in somebody
else's basis convention, we (a) define explicit real spherical harmonics
Y_l (l <= 3), (b) obtain D_l(R) numerically from the defining property
Y_l(R r) = D_l(R) Y_l(r) by least squares over sample points, and (c) solve
for the unique (up to scale) intertwiner T: l1 (x) l2 -> l3 as the null space
of the equivariance constraints D3 T = T (D1 (x) D2) stacked over random
rotations. Everything is exact to float64 precision and *self-validating* —
if any formula were inconsistent, the null space would be empty. Computed
once on the host at model-build time; the model takes them as constant
tensors.

The JAX package's ``repro.models.gnn.equivariant``, copied (pure numpy, its
own ``default_rng(1234)``), with one change: an intertwiner's sign is fixed
by its first entry that is not structurally zero, where the JAX package's
rule (largest entry positive) depends, for paths whose largest entries tie,
on the rotations drawn and so on the order of first use. An intertwiner is
unique up to sign and norm, so the port's equal the JAX package's up to
that sign, to fp64 rounding, whatever order they are asked for in.
"""
from __future__ import annotations

import functools

import numpy as np

_rng = np.random.default_rng(1234)


# ------------------------------------------------------- spherical harmonics
def real_sph_harm(l: int, r: np.ndarray) -> np.ndarray:
    """Real solid harmonics of degree l on unit vectors r (..., 3) ->
    (..., 2l+1). Component normalization is `norm`alized so |Y_l(u)| = 1 on
    average over the sphere (the constant factor is absorbed by the radial
    weights; only the rotation behaviour matters)."""
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    if l == 0:
        return np.ones(r.shape[:-1] + (1,))
    if l == 1:
        return np.stack([x, y, z], axis=-1)
    if l == 2:
        return np.stack(
            [
                x * y,
                y * z,
                (2 * z * z - x * x - y * y) / (2 * np.sqrt(3.0)),
                x * z,
                (x * x - y * y) / 2.0,
            ],
            axis=-1,
        ) * np.sqrt(3.0)
    if l == 3:
        return np.stack(
            [
                np.sqrt(2.5) * y * (3 * x * x - y * y) / 2,
                np.sqrt(15.0) * x * y * z,
                np.sqrt(1.5) * y * (4 * z * z - x * x - y * y) / 2,
                z * (2 * z * z - 3 * x * x - 3 * y * y) / 2,
                np.sqrt(1.5) * x * (4 * z * z - x * x - y * y) / 2,
                np.sqrt(15.0) * z * (x * x - y * y) / 2,
                np.sqrt(2.5) * x * (x * x - 3 * y * y) / 2,
            ],
            axis=-1,
        )
    raise NotImplementedError(f"l={l}")


def random_rotation(rng=None) -> np.ndarray:
    """Haar-ish random SO(3) matrix via QR."""
    rng = rng or _rng
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def wigner_d(l: int, R: np.ndarray) -> np.ndarray:
    """D_l(R) with Y_l(R r) = D_l(R) @ Y_l(r), solved by least squares over
    sample directions (exact: Y_l spans an irreducible representation)."""
    if l == 0:
        return np.ones((1, 1))
    pts = _rng.normal(size=(max(64, 4 * (2 * l + 1)), 3))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    A = real_sph_harm(l, pts)             # (P, 2l+1)
    B = real_sph_harm(l, pts @ R.T)       # (P, 2l+1)
    D, *_ = np.linalg.lstsq(A, B, rcond=None)
    return D.T                            # B^T = D @ A^T


@functools.lru_cache(maxsize=None)
def intertwiner(l1: int, l2: int, l3: int) -> np.ndarray | None:
    """The (unique up to sign) equivariant map T[(m3), (m1), (m2)] with
    (u (x) v)_{m3} = sum T[m3, m1, m2] u_{m1} v_{m2}, normalized to
    ||T||_F = 1. None if l3 not in |l1-l2| .. l1+l2 (no intertwiner)."""
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return None
    if l1 == l2 == l3 == 0:
        return np.ones((1, 1, 1))
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    rows = []
    for _ in range(4):
        R = random_rotation()
        D1, D2, D3 = wigner_d(l1, R), wigner_d(l2, R), wigner_d(l3, R)
        # constraint: D3 @ T_mat = T_mat @ (D1 (x) D2), T_mat is (d3, d1*d2)
        K = np.kron(D1, D2)
        # vec(D3 T - T K) = (I (x) D3 - K^T (x) I) vec(T)
        rows.append(np.kron(np.eye(d1 * d2), D3) - np.kron(K.T, np.eye(d3)))
    M = np.concatenate(rows, axis=0)
    _, s, vt = np.linalg.svd(M)
    # null space should be exactly 1-dimensional for l3 in the CG range
    null = vt[s.size - 1 :]
    assert s[-1] < 1e-8 and s[-2] > 1e-4, (l1, l2, l3, s[-3:])
    T = null[0].reshape(d1 * d2, d3).T.reshape(d3, d1, d2)
    T /= np.linalg.norm(T)
    # fix the sign: the first entry (in (m3, m1, m2) order) that is not
    # structurally zero is positive. The JAX package makes its largest-|.|
    # entry positive, which for paths whose largest entries tie in
    # magnitude (e.g. 1 x 1 -> 1) picks by fp64 noise that depends on the
    # rotations drawn, so on the order the intertwiners are asked for;
    # this rule gives one sign in any order
    flat = T.ravel()
    T = T * np.sign(flat[np.flatnonzero(np.abs(flat) > 1e-6 * np.abs(
        flat).max())[0]])
    return T


def tp_paths(l_in: tuple[int, ...], l_edge: tuple[int, ...],
             l_out: tuple[int, ...]):
    """All (l1, l2, l3) with nonzero intertwiner — the tensor-product paths."""
    return [
        (l1, l2, l3)
        for l1 in l_in
        for l2 in l_edge
        for l3 in l_out
        if abs(l1 - l2) <= l3 <= l1 + l2
    ]
