"""The port's segment_agg layer against the JAX package's: plan builders bit
for bit, and the wrapper's plain PyTorch version (what a CPU tensor runs)
against the JAX oracle and the interpret-mode Pallas kernel, across the
shape sweep of ``tests/test_kernels.py``, and the fused active entry's
plain version against the JAX package's frontier-sparse level (gather,
sign, reduce, row mask). Inputs are made with numpy from a seed and handed
to both sides."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.segment_agg import ops as R  # noqa: E402
from repro.kernels.segment_agg.ref import segment_agg_ref as jax_ref  # noqa: E402
from repro_torch.kernels.segment_agg import ops as T  # noqa: E402
from repro_torch.kernels.segment_agg.ref import (  # noqa: E402
    segment_agg_level_ref,
    segment_agg_ref,
)

SWEEP = [(100, 8, 17), (1000, 64, 300), (37, 5, 10), (4096, 128, 128),
         (513, 200, 77), (1, 1, 1), (2000, 96, 1000)]


def _inputs(E, F, n_rows, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_rows, E),
            rng.normal(size=(E, F)).astype(np.float32))


@pytest.mark.parametrize("E,F,n_rows", SWEEP)
def test_make_plan_bit_equal(E, F, n_rows):
    seg, _ = _inputs(E, F, n_rows)
    a, b = R.make_plan(seg, n_rows), T.make_plan(seg, n_rows)
    for f in ("perm", "seg_padded", "tile_of_block", "first_of_tile"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert (a.n_rows, a.n_row_tiles, a.e_pad) == (b.n_rows, b.n_row_tiles,
                                                  b.e_pad)
    assert T.count_blocks(seg) == R.count_blocks(seg)


@pytest.mark.parametrize("pad", [None, (8, 64)])
def test_leveled_plan_bit_equal(pad):
    rng = np.random.default_rng(1)
    n_rows = 700
    segs = [rng.integers(0, n_rows, n) for n in (900, 0, 300, 2500, 17)]
    kw = {} if pad is None else dict(pad_levels=pad[0], pad_blocks=pad[1])
    a = R.make_leveled_plan(segs, n_rows, **kw)
    b = T.make_leveled_plan(segs, n_rows, **kw)
    for f in ("seg", "tile_of_block", "first_of_tile", "tile_slots"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype
    assert len(a.perms) == len(b.perms)
    for x, y in zip(a.perms, b.perms):
        np.testing.assert_array_equal(x, y)
    vals = rng.integers(0, 50, 2500).astype(np.int32)
    np.testing.assert_array_equal(a.layout(3, vals), b.layout(3, vals))
    assert T.leveled_plan_blocks(segs) == R.leveled_plan_blocks(segs)
    for l in range(a.n_levels):
        np.testing.assert_array_equal(
            R.tile_slot_ranges(a.tile_of_block[l], a.n_row_tiles),
            T.tile_slot_ranges(b.tile_of_block[l], b.n_row_tiles))


@pytest.mark.parametrize("n_blocks", [4, 16])
def test_relayout_level_bit_equal(n_blocks):
    rng = np.random.default_rng(2)
    dst = rng.integers(0, 300, 400)
    src = rng.integers(0, 300, 400)
    sign = rng.choice([-1.0, 1.0], 400).astype(np.float32)
    a = R.relayout_level(dst, src, sign, 300, n_blocks, n_blocks * R.E_BLK)
    b = T.relayout_level(dst, src, sign, 300, n_blocks, n_blocks * T.E_BLK)
    assert (a is None) == (b is None)
    if a is not None:
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("E,F,n_rows", SWEEP)
@pytest.mark.parametrize("op", ["sum", "max"])
def test_plain_version_matches_jax_oracle(E, F, n_rows, op):
    """The wrapper on CPU tensors (the plain version) against
    ``repro.kernels.segment_agg.ref.segment_agg_ref``, to 1e-5."""
    seg, x = _inputs(E, F, n_rows)
    plan = T.make_plan(seg, n_rows)
    got = T.segment_agg(torch.as_tensor(x), plan, op=op).numpy()
    want = np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(seg), n_rows, op=op))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    direct = segment_agg_ref(torch.as_tensor(x), torch.as_tensor(seg),
                             n_rows, op).numpy()
    np.testing.assert_allclose(direct, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("E,F,n_rows", [(100, 8, 17), (1000, 64, 300),
                                        (513, 200, 77), (1, 1, 1)])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_plain_version_matches_pallas_interpret(E, F, n_rows, op):
    """The level wrapper against the Pallas kernel run in interpret mode on
    the same padded level, on the rows some slot routes to."""
    seg, x = _inputs(E, F, n_rows, seed=3)
    plan = R.make_plan(seg, n_rows)
    xp = np.zeros((plan.e_pad, F), np.float32)
    xp[plan.perm] = x
    want = np.asarray(R.segment_agg_level(
        jnp.asarray(xp), jnp.asarray(plan.seg_padded),
        jnp.asarray(plan.tile_of_block), jnp.asarray(plan.first_of_tile),
        n_rows=n_rows, n_row_tiles=plan.n_row_tiles, op=op, interpret=True))
    got = T.segment_agg_level(
        torch.as_tensor(xp), torch.as_tensor(plan.seg_padded),
        torch.as_tensor(plan.tile_of_block),
        torch.as_tensor(plan.first_of_tile),
        n_rows=n_rows, n_row_tiles=plan.n_row_tiles, op=op).numpy()
    hit = np.zeros(n_rows, bool)
    hit[seg] = True
    np.testing.assert_allclose(got[hit], want[hit], rtol=1e-5, atol=1e-5)
    # visited rows without a slot hold the op's identity, as on the TPU
    ident = 0.0 if op == "sum" else -3.0e38
    tiles = set(plan.tile_of_block.tolist())
    idle = [r for r in range(n_rows) if not hit[r] and r // T.R_BLK in tiles]
    np.testing.assert_array_equal(got[idle], np.full((len(idle), F), ident,
                                                     np.float32))


def test_empty_rows_read_zero():
    plan = T.make_plan(np.array([5, 5, 5]), 10)
    out = T.segment_agg(torch.ones((3, 4)), plan, op="max").numpy()
    assert np.allclose(out[5], 1.0) and np.allclose(out[0], 0.0)


def _level(F=3):
    plan = T.make_plan(np.array([0, 1, 1, 4]), 6)
    return (torch.zeros((plan.e_pad, F)), torch.as_tensor(plan.seg_padded),
            torch.as_tensor(plan.tile_of_block),
            torch.as_tensor(plan.first_of_tile), plan)


def test_cpu_path_counts_no_launch():
    x, seg, tob, fot, plan = _level()
    before = dict(T.LAUNCHES)
    T.segment_agg_level(x, seg, tob, fot, n_rows=6, n_row_tiles=1, op="sum")
    T.segment_agg_level(x, seg, tob, fot, n_rows=6, n_row_tiles=1, op="max")
    assert T.LAUNCHES == before


@pytest.mark.parametrize("case", ["dtype", "seg_dtype", "shape", "op",
                                  "contiguous", "device", "rows"])
def test_level_wrapper_rejects_bad_inputs(case):
    x, seg, tob, fot, plan = _level()
    kw = dict(n_rows=6, n_row_tiles=1, op="sum")
    if case == "dtype":
        x = x.to(torch.float64)
    elif case == "seg_dtype":
        seg = seg.to(torch.int64)
    elif case == "shape":
        x = x[:-1]
    elif case == "op":
        kw["op"] = "mean"
    elif case == "contiguous":
        x = torch.zeros((x.shape[1], x.shape[0])).t()
    elif case == "device":
        x = x.to("meta")
    elif case == "rows":
        kw["n_rows"] = 200
    with pytest.raises((TypeError, ValueError)):
        T.segment_agg_level(x, seg, tob, fot, **kw)


def test_level_ref_identity_and_padding():
    x = torch.tensor([[1.0], [2.0], [5.0], [7.0]])
    seg = torch.tensor([1, -1, 1, 0], dtype=torch.int32)
    s = segment_agg_level_ref(x, seg, 3, "sum")
    m = segment_agg_level_ref(x, seg, 3, "max")
    assert s.flatten().tolist() == [7.0, 6.0, 0.0]
    assert m.flatten().tolist() == [7.0, 5.0, np.float32(-3.0e38)]


def _windowed_reduce(x, seg, tob, fot, n_rows, n_row_tiles, op):
    """The CUDA kernel's cut and combine order in numpy (fp32): windows of
    ``T.run_chunk(n_blocks, F)`` blocks; in each, every block reduced on its own
    (slots in order), a run's piece folding its live blocks in block
    order; a run inside one window written at once, a longer run's live
    pieces combined in window order, dead pieces (no live slot) skipped.
    Returns (n_rows, F) with the rows of visited tiles."""
    win, R, E = T.run_chunk(tob.size, x.shape[1]), T.R_BLK, T.E_BLK
    F, nb = x.shape[1], tob.size
    ident = np.float32(0.0 if op == "sum" else -3.0e38)
    comb = np.add if op == "sum" else np.maximum
    out = np.full((n_row_tiles * R, F), np.nan, np.float32)
    part = {}

    def in_run(b, tile):
        return b < nb and fot[b] == 0 and tob[b] == tile

    for w0 in range(0, nb, win):
        w1, p0 = min(w0 + win, nb), w0
        while p0 < w1:
            tile, p1 = tob[p0], p0 + 1
            while p1 < w1 and in_run(p1, tile):
                p1 += 1
            starts = fot[p0] == 1
            if (starts or p0 == w0) and 0 <= tile < n_row_tiles:
                v = np.full((R, F), ident, np.float32)
                live = False
                for b in range(p0, p1):
                    loc = seg[b * E:(b + 1) * E] - tile * R
                    ok = (seg[b * E:(b + 1) * E] >= 0) & (loc >= 0) & (loc < R)
                    if ok.any():
                        live = True
                        copy = np.full((R, F), ident, np.float32)
                        comb.at(copy, loc[ok], x[b * E:(b + 1) * E][ok])
                        v = comb(v, copy)
                if starts and not (p1 == w1 and in_run(w1, tile)):
                    out[tile * R:(tile + 1) * R] = v
                else:
                    part[(w0 // win, 0 if p0 == w0 else 1)] = v if live \
                        else None
            p0 = p1
    for w0 in range(0, nb, win):          # the combine pass
        w1 = min(w0 + win, nb)
        firsts = [b for b in range(w0, w1) if fot[b] == 1]
        if not firsts:
            continue
        s = firsts[-1]
        tile = tob[s]
        if any(tob[b] != tile for b in range(s, w1)) or not in_run(w1, tile):
            continue
        e = w1
        while in_run(e, tile):
            e += 1
        pieces = [(w0 // win, 0 if s == w0 else 1)] + [
            (w, 0) for w in range(w0 // win + 1, (e - 1) // win + 1)]
        acc = np.full((R, F), ident, np.float32)
        for p in pieces:
            if part[p] is not None:
                acc = comb(acc, part[p])
        out[tile * R:(tile + 1) * R] = acc
    return out[:n_rows]


def _hub_level(rng, F, dead_between, shuffle, hub_blocks=1000):
    """One tile holding ``hub_blocks`` live blocks, most slots on 3 rows;
    other tiles small; dead blocks mixed into the hub's run (its blocks
    permuted) and trailing padding blocks on the last run; optionally slots
    shuffled inside each tile's run. Returns x, seg, tob, fot, n_rows."""
    R, E = T.R_BLK, T.E_BLK
    n_hub = hub_blocks * E - 31
    hub = 2 * R + np.where(rng.random(n_hub) < 0.8, rng.integers(0, 3, n_hub),
                           rng.integers(0, R, n_hub))
    seg = np.concatenate([rng.integers(0, R, 300), hub,
                          rng.integers(3 * R, 4 * R, 900)])
    plan = T.make_plan(seg, 4 * R)
    blocks = list(plan.seg_padded.reshape(-1, E))
    tob = list(plan.tile_of_block)
    if dead_between:
        hub_idx = [i for i, t in enumerate(tob) if t == 2]
        mine = [blocks[i] for i in hub_idx] + [np.full(E, -1, np.int32)] * 90
        mine = [mine[i] for i in rng.permutation(len(mine))]
        blocks = blocks[:hub_idx[0]] + mine + blocks[hub_idx[-1] + 1:]
        tob = tob[:hub_idx[0]] + [2] * len(mine) + tob[hub_idx[-1] + 1:]
    blocks += [np.full(E, -1, np.int32)] * 45
    tob = np.asarray(tob + [tob[-1]] * 45, np.int32)
    fot = np.r_[1, tob[1:] != tob[:-1]].astype(np.int32)
    seg_p = np.concatenate(blocks).astype(np.int32)
    x = rng.normal(size=(seg_p.size, F)).astype(np.float32)
    if shuffle:
        for t in np.unique(tob):
            idx = np.flatnonzero(tob == t)
            lo, hi = idx[0] * E, (idx[-1] + 1) * E
            p = lo + rng.permutation(hi - lo)
            seg_p[lo:hi], x[lo:hi] = seg_p[p], x[p]
    return x, seg_p, tob, fot, 4 * R


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("F", [2, 6])
@pytest.mark.parametrize("dead_between,shuffle", [(True, False),
                                                  (False, True),
                                                  (True, True)])
def test_windowed_run_reduce_matches_plain_version(op, dead_between,
                                                   shuffle, F):
    """The kernel's chunked run reduce (``_windowed_reduce``) on a hub tile
    of 1,000 live blocks crossing many windows (F = 2: slot lanes, F = 6:
    feature lanes, with other windows), with dead blocks among the
    live ones, slots shuffled inside runs and trailing padding: bit-equal to
    the plain version on integer-valued x (sums of small integers are exact
    in any order) and max on any x. Sums of normal x: a hub row adds ~10^5
    values, where two summation orders differ by more than 1e-5, so they
    are held to the bound of a reordered sum of n values,
    n * 2^-24 * sum|x| per row."""
    rng = np.random.default_rng(7)
    x, seg, tob, fot, n_rows = _hub_level(rng, F, dead_between, shuffle)
    assert (tob == 2).sum() > 30 * T.run_chunk(tob.size, F)
    hit = np.zeros(n_rows + 1, bool)
    hit[np.where(seg >= 0, seg, n_rows)] = True
    hit = hit[:n_rows]
    for vals, exact in ((np.round(x * 4), True), (x, op == "max")):
        got = _windowed_reduce(vals, seg, tob, fot, n_rows, 4, op)
        want = segment_agg_level_ref(torch.from_numpy(vals),
                                     torch.from_numpy(seg), n_rows,
                                     op).numpy()
        if exact:
            np.testing.assert_array_equal(got[hit], want[hit])
        else:
            n = np.bincount(seg[seg >= 0], minlength=n_rows)[:, None]
            sabs = segment_agg_level_ref(torch.from_numpy(np.abs(vals)),
                                         torch.from_numpy(seg), n_rows,
                                         "sum").numpy()
            lim = n * 2.0 ** -24 * sabs
            assert (np.abs(got - want) <= lim)[hit].all()


def test_windowed_run_reduce_on_a_leveled_plan():
    """Every level of a leveled plan (padding blocks routed to the last
    tile, a dummy level), sum and max, F = 3: the windowed reduce equals the
    plain version exactly on integer values."""
    rng = np.random.default_rng(3)
    n_rows = 900
    segs = [rng.integers(0, n_rows, n) for n in (4000, 0, 50, 9000)]
    lp = T.make_leveled_plan(segs, n_rows)
    for l in range(lp.n_levels):
        seg = lp.seg[l]
        x = rng.integers(-9, 10, (seg.size, 3)).astype(np.float32)
        hit = np.zeros(n_rows + 1, bool)
        hit[np.where(seg >= 0, seg, n_rows)] = True
        for op in ("sum", "max"):
            got = _windowed_reduce(x, seg, lp.tile_of_block[l],
                                   lp.first_of_tile[l], n_rows,
                                   lp.n_row_tiles, op)
            want = segment_agg_level_ref(torch.from_numpy(x),
                                         torch.from_numpy(seg), n_rows,
                                         op).numpy()
            np.testing.assert_array_equal(got[hit[:n_rows]],
                                          want[hit[:n_rows]])


@pytest.mark.parametrize("F", [1, 2, 4, 5, 64])
def test_kernel_windows_follow_the_block_count(F):
    """The kernel's windows come from the level's block count and F alone
    (one per ``run_chunk(n_blocks, F)`` blocks, the last one partial), so
    the cut of a run never depends on which of its blocks are live; a
    window holds 4 to 16 blocks, within the kernel's table of 64."""
    for nb in (1, 15, 16, 17, 1024, 2048, 8192, 1 << 16):
        win = T.run_chunk(nb, F)
        assert 4 <= win <= 16
        assert T.n_windows(nb, F) == -(-nb // win)
        assert (T.n_windows(nb, F) - 1) * win < nb


# ------------------------------------------------ the fused active entry
def _active_level(rng, n_rows=700, n_val=500, n_act=11):
    """One level's tables with slots shuffled inside each tile's run, live
    slots' sources and signs (padding: source 0, sign 0), and an ascending
    active list padded with the block count."""
    plan = T.make_plan(rng.integers(0, n_rows, 9000), n_rows)
    nb = plan.tile_of_block.size
    seg = plan.seg_padded.copy()
    for t in np.unique(plan.tile_of_block):
        b = np.flatnonzero(plan.tile_of_block == t)
        lo, hi = b[0] * T.E_BLK, (b[-1] + 1) * T.E_BLK
        seg[lo:hi] = seg[lo + rng.permutation(hi - lo)]
    live = seg >= 0
    src = np.where(live, rng.integers(0, n_val, seg.size), 0).astype(np.int32)
    sign = np.where(live, rng.choice([-1.0, 1.0], seg.size),
                    0.0).astype(np.float32)
    a = np.full(16, nb, np.int32)
    a[:n_act] = np.sort(rng.choice(nb, n_act, replace=False))
    return plan, seg, src, sign, a


def _jax_active(plan, seg, src, sign, a, val, op):
    """The JAX package's frontier-sparse level with ``backend="xla"``:
    ``_gather_active``, ``_level_reduce_active`` and ``_row_active``."""
    from repro.core import engine as RE

    n_rows = plan.n_rows
    meta = RE.PlanMeta(n_nodes=n_rows, n_writers=1, n_levels=1,
                       unroll_levels=0, n_row_tiles=plan.n_row_tiles,
                       backend="xla", interpret=False)
    tables = RE.LevelTables(
        seg=jnp.asarray(seg[None]), src=jnp.asarray(src[None]),
        sign=jnp.asarray(sign[None]),
        tile_of_block=jnp.asarray(plan.tile_of_block[None]),
        first_of_tile=jnp.asarray(plan.first_of_tile[None]),
        touched=jnp.ones((1, n_rows), bool))
    seg_c, src_c, sign_c, tob_c = RE._gather_active(meta, tables, 0,
                                                    jnp.asarray(a))
    out = RE._level_reduce_active(meta, seg_c, src_c, sign_c, tob_c,
                                  jnp.asarray(val), op)
    return np.asarray(out), np.asarray(RE._row_active(meta, seg_c))


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("F", [1, 2, 40])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_active_plain_version_matches_jax_composition(op, F, integer):
    """The fused active entry's plain version (what a CPU tensor runs)
    against the JAX package's gather + sign + reduce of the same level's
    active blocks: its row mask equal to ``_row_active``'s, the values on
    those rows exact on integers and for max/min, sums of normal values
    within rtol/atol 1e-4 (another summation order)."""
    rng = np.random.default_rng(10 * F + integer)
    plan, seg, src, sign, a = _active_level(rng)
    val = (rng.integers(-8, 9, (500, F)) if integer
           else rng.normal(size=(500, F))).astype(np.float32)
    got, hit = T.segment_agg_active(
        *(torch.as_tensor(v) for v in (val, seg, src, sign,
                                       plan.tile_of_block,
                                       plan.first_of_tile, a)),
        n_rows=plan.n_rows, n_row_tiles=plan.n_row_tiles, op=op)
    want, want_hit = _jax_active(plan, seg, src, sign, a, val, op)
    np.testing.assert_array_equal(hit.numpy(), want_hit)
    assert want_hit.any()
    got, want = got.numpy()[want_hit], want[want_hit]
    if integer or op != "sum":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
