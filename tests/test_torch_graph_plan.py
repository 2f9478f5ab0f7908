"""The graph entry's plan tables (``segment_agg.ops.graph_tables``) and the
order in which its CUDA kernel (``csrc/segment_graph.cu``) adds a row's
values, on the CPU.

A numpy float32 emulation of the kernel's order, built from the new tables
alone, must equal bit for bit an emulation of the order of the route the
graph entry took before (the stacked dense entry of ``segment_agg.cu`` at
S = 1: per block, per window of blocks, then across windows), built from
the same plan's layout as that entry's ``seg``/``src``/``sign``/``tob``/
``fot`` (``chip_smoke.gnn_stacked_tables``); both are held to the plain
version (sums within n * 2^-24 * sum|x| of fp64, max exactly). The
kernel's room for unsettled partials is held to the most a lane group can
hold (``chip_smoke.pending_peak``). The kernel itself runs only on the card
(``chip_smoke.py`` phase 12 holds it bit-equal to the old route there)."""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.segment_agg import ops, ref  # noqa: E402

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))
import chip_smoke  # noqa: E402

E_BLK, R_BLK = ops.E_BLK, ops.R_BLK
MASK = (1 << ops.SRC_BITS) - 1


def _case(name: str):
    """(index, n_rows, mask) of one plan case."""
    rng = np.random.default_rng(len(name))
    if name == "empty":
        return np.zeros(0, np.int64), 50, None
    if name == "all_masked":
        return rng.integers(0, 40, 30), 40, np.zeros(30, bool)
    if name == "random":
        idx = rng.integers(0, 300, 1500)
        idx[rng.random(1500) < 0.03] = -1          # rows out of range
        idx[rng.random(1500) < 0.03] = 307
        return idx, 300, rng.random(1500) < 0.8
    if name == "hub":
        # row 5 takes 1,100 edges: 5 blocks of tile 0, across a window
        idx = np.concatenate([np.full(1100, 5), rng.integers(0, 400, 900)])
        return rng.permutation(idx), 400, None
    if name == "one_edge_tile":
        # tile 7 (rows 896..1023) holds one edge; tile 2 none
        idx = np.concatenate([rng.integers(0, 256, 700), [1000],
                              rng.integers(384, 512, 300)])
        return rng.permutation(idx), 1100, rng.random(1001) < 0.95
    if name == "pending":
        # 8 tiles of a 510-edge row, a 3-edge row and a few single edges:
        # a lane group streaming 3 or 4 tasks holds 4 partials unsettled
        idx = chip_smoke.gnn_pending_index(8)
        return rng.permutation(idx), 8 * R_BLK, None
    raise KeyError(name)


CASES = ["random", "hub", "one_edge_tile", "empty", "all_masked", "pending"]
FS = [1, 3, 8, 70, 512]


def _plan(name: str):
    idx, n_rows, mask = _case(name)
    return ops.make_edge_plan(
        torch.as_tensor(idx), n_rows,
        None if mask is None else torch.as_tensor(mask)), idx, n_rows, mask


def _values(n_edges: int, F: int, seed: int) -> np.ndarray:
    """Normal values over six decades, so that any change in the order of
    a row's additions shows in its rounding."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_edges, F)) * 10.0 ** rng.uniform(
        -3, 3, (n_edges, 1))
    return x.astype(np.float32)


def _comb(op):
    return np.fmax if op == "max" else np.add


def _ident(op):
    return np.float32(-3e38 if op == "max" else 0.0)


# ------------------------------------------------------- the old route's order
def _feature_block(xs, loc, copy, comb):
    """segment_agg.cu's feature_block (F > 4): a row's stretch in a register
    from its first value, added into the block's copy when the row
    changes."""
    cur, acc = -1, None
    for s in range(E_BLK):
        li = loc[s]
        if li < 0:
            continue
        if li != cur:
            if cur >= 0:
                copy[cur] = comb(copy[cur], acc)
            cur, acc = li, xs[s].copy()
        else:
            acc = comb(acc, xs[s])
    if cur >= 0:
        copy[cur] = comb(copy[cur], acc)


def _slot_block(xs, loc, copy, comb, ident):
    """segment_agg.cu's slot_block_overlapped (F <= 4): per round of 32
    slots (lane = slot), each stretch of one row reduced by the shuffle
    tree, the stretch heads added into the copy in lane order."""
    lanes = np.arange(32)
    for r in range(E_BLK // 32):
        lc = loc[r * 32:(r + 1) * 32]
        valid = lc >= 0
        if not valid.any():
            continue
        v = np.where(valid[:, None], xs[r * 32:(r + 1) * 32], ident)
        nxt = np.append(lc[1:], -2)
        prv = np.insert(lc[:-1], 0, -2)
        tails = valid & ((lanes == 31) | (nxt != lc))
        end = np.array([lanes[l:][tails[l:]][0] if valid[l] else l
                        for l in range(32)])
        for o in (1, 2, 4, 8, 16):
            nv = v.copy()
            for l in range(32):
                if l + o <= end[l]:
                    nv[l] = comb(v[l], v[l + o])
            v = nv
        for l in np.flatnonzero(valid & ((lanes == 0) | (prv != lc))):
            copy[lc[l]] = comb(copy[lc[l]], v[l])


def old_route(x: np.ndarray, plan, op: str) -> np.ndarray:
    """The stacked dense entry at S = 1 over the plan's old tables, as
    segment_agg.cu computes it: blocks reduced into copies of their tile,
    each window's pieces folding their live blocks in block order, a run
    crossing windows combined in window order; rows of no live edge 0, as
    the old wrapper masked them."""
    tabs = chip_smoke.gnn_stacked_tables(torch, ops, plan)
    seg, src, sign, tob, fot = (tabs[k][0].numpy() for k in (
        "seg", "src", "sign", "tob", "fot"))
    F, nb, n_rt = x.shape[1], tob.size, tabs["n_row_tiles"]
    win = ops.run_chunk(nb, F)
    comb, ident = _comb(op), _ident(op)
    xs = (x[src] if x.shape[0] else np.zeros((seg.size, F), np.float32)) \
        * sign[:, None]
    out = np.full((n_rt * R_BLK, F), np.nan, np.float32)

    def copy_of(b):
        tile = tob[b]
        copy = np.full((R_BLK, F), ident, np.float32)
        if not 0 <= tile < n_rt:
            return copy, False
        s = seg[b * E_BLK:(b + 1) * E_BLK]
        d = s - tile * R_BLK
        loc = np.where((s >= 0) & (d >= 0) & (d < R_BLK), d, -1)
        if not (loc >= 0).any():
            return copy, False
        blk = xs[b * E_BLK:(b + 1) * E_BLK]
        if F > 4:
            _feature_block(blk, loc, copy, comb)
        else:
            _slot_block(blk, loc, copy, comb, ident)
        return copy, True

    runs = {}
    for w in range(-(-nb // win)):
        w0 = w * win
        nw = min(win, nb - w0)
        copies = [copy_of(w0 + i) for i in range(nw)]
        starts = [i for i in range(nw) if i == 0 or fot[w0 + i] == 1
                  or tob[w0 + i] != tob[w0 + i - 1]]
        for k, p0 in enumerate(starts):
            p1 = starts[k + 1] if k + 1 < len(starts) else nw
            tile, first = tob[w0 + p0], fot[w0 + p0] == 1
            nx = w0 + nw
            goes_on = p1 == nw and nx < nb and fot[nx] == 0 \
                and tob[nx] == tile
            if (not first and p0 != 0) or not 0 <= tile < n_rt:
                continue
            rows = slice(tile * R_BLK, (tile + 1) * R_BLK)
            live = [c for c, ok in copies[p0:p1] if ok]
            v = np.full((R_BLK, F), ident, np.float32)
            for c in live:
                v = comb(v, c)
            if first and not goes_on:
                out[rows] = v
                continue
            if first:
                runs[tile] = np.full((R_BLK, F), ident, np.float32)
            if live:
                runs[tile] = comb(runs[tile], v)
            if not goes_on:
                out[rows] = runs.pop(tile)
    out = out[:plan.n_rows]
    out[~tabs["hit"].numpy()] = 0.0
    return out


# ---------------------------------------------------------- the kernel's order
def kernel_order(x: np.ndarray, plan, op: str) -> np.ndarray:
    """segment_graph.cu's order from the new tables alone: each segment's
    sum from the identity (F <= 4 sums: per 32-slot round of its block, a
    binary counter of subtree sums joined from the right at the round's
    end; the rounds' sums folded from +0), written to its row or its
    partial; a crossing row's partials folded per window from +0 and
    across windows from +0 (max: from -3e38); empty rows 0."""
    t = plan.tables
    # each slot's offset in its block (a block's live slots are a prefix)
    at = np.arange(plan.n_live)
    at -= t.blocks[np.searchsorted(t.blocks, at, side="right") - 1]
    F = x.shape[1]
    win = ops.run_chunk(plan.n_blocks, F)
    comb, ident = _comb(op), _ident(op)
    tree = op == "sum" and F <= 4
    out = np.full((plan.n_rows, F), np.nan, np.float32)
    out[t.empty] = 0.0
    part = np.full((t.part.shape[0], F), np.nan, np.float32)
    acc = np.full(F, ident, np.float32)
    st, cnt = {}, 0
    for (word, dst), off in zip(t.slots, at):
        fl = int(np.uint32(np.int32(word)))
        v = x[fl & MASK]
        if tree:
            c, lvl = v.copy(), 0
            while (cnt >> lvl) & 1:
                c = comb(st[lvl], c)
                lvl += 1
            st[lvl] = c
            cnt += 1
            if fl & ops.LAST_SEG or off % 32 == 31:
                tot = None
                for lv in range(6):
                    if (cnt >> lv) & 1:
                        tot = st[lv] if tot is None else comb(st[lv], tot)
                acc = comb(acc, tot)
                st, cnt = {}, 0
        else:
            acc = comb(acc, v)
        if fl & ops.LAST_SEG:
            if dst >= 0:
                out[dst] = acc
            else:
                part[-1 - dst] = acc
            acc = np.full(F, ident, np.float32)
    for q0, (lo, n, b0, row) in enumerate(t.part):
        if q0 != lo:
            continue                        # folded at the row's first
        tot = np.full(F, ident, np.float32)
        wsum, wcur = np.full(F, ident, np.float32), b0 // win
        for q in range(lo, lo + n):
            w = (b0 + q - lo) // win
            if op == "sum" and w != wcur:
                tot, wsum = comb(tot, wsum), np.full(F, ident, np.float32)
                wcur = w
            wsum = comb(wsum, part[q])
        out[row] = comb(tot, wsum)
    return out


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


# ------------------------------------------------------------------- tests
@pytest.mark.parametrize("name", CASES)
def test_tables_describe_the_layout(name):
    """Every live edge sits in one slot, in the old layout's order; each
    row's segments follow its blocks; crossing rows list their blocks in
    order; the empty rows are exactly the rows no live edge reaches; tasks
    hold whole segments."""
    plan, idx, n_rows, mask = _plan(name)
    t = plan.tables
    tabs = chip_smoke.gnn_stacked_tables(torch, ops, plan)
    seg, src = tabs["seg"][0].numpy(), tabs["src"][0].numpy()
    assert seg.size == plan.n_slots and tabs["tob"].shape[1] == plan.n_blocks
    live = (idx >= 0) & (idx < n_rows)
    if mask is not None:
        live &= mask
    words = t.slots[:, 0].view(np.uint32)
    edges = (words & MASK).astype(np.int64)
    assert t.slots.dtype == np.int32 and t.slots.shape == (plan.n_live, 2)
    assert sorted(edges.tolist()) == np.flatnonzero(live).tolist()
    pos = np.flatnonzero(seg >= 0)            # the old layout's live slots
    np.testing.assert_array_equal(src[pos], edges)
    rows = idx[edges]
    assert (np.diff(rows) >= 0).all()
    # flags: a segment ends where its row or its block does
    blk = pos // E_BLK
    seg_end = np.append((rows[1:] != rows[:-1]) | (blk[1:] != blk[:-1]),
                        True)[:pos.size]
    np.testing.assert_array_equal((words & ops.LAST_SEG) != 0, seg_end)
    assert not (words & (1 << 30)).any()
    # blocks: each block with a live slot, its live slots a prefix of it
    b = t.blocks
    assert b[0] == 0 and b[-1] == plan.n_live and (np.diff(b) > 0).all()
    np.testing.assert_array_equal(np.unique(blk), blk[b[:-1]])
    assert (pos[b[:-1]] % E_BLK == 0).all()
    for lo, hi in zip(b[:-1], b[1:]):
        np.testing.assert_array_equal(pos[lo:hi], pos[lo] + np.arange(
            hi - lo))
    # destinations: a row with one block is written directly; a crossing
    # row's partials, one a block, are consecutive and name its blocks in
    # order
    dst = t.slots[:, 1]
    assert t.part.dtype == np.int32 and t.part.shape[1:] == (4,)
    crossing = set()
    for r in np.unique(rows):
        blocks = np.unique(blk[rows == r])
        d = dst[rows == r]
        if blocks.size == 1:
            assert (d == r).all()
            continue
        crossing.add(int(r))
        parts = np.unique(-1 - d)
        lo = parts[0]
        np.testing.assert_array_equal(parts, lo + np.arange(blocks.size))
        np.testing.assert_array_equal(blocks, blocks[0] + np.arange(
            blocks.size))
        for q in parts:
            assert t.part[q].tolist() == [lo, blocks.size, blocks[0], r]
        # a partial holds exactly its block's slots of the row
        for q, b in zip(parts, blocks):
            assert ((-1 - d) == q).sum() == ((blk == b) & (rows == r)).sum()
    assert set(t.part[:, 3].tolist()) == crossing
    assert (t.part[:, 1] >= 2).all()
    reached = np.zeros(n_rows, bool)
    reached[rows] = True
    np.testing.assert_array_equal(t.empty, np.flatnonzero(~reached))
    np.testing.assert_array_equal(tabs["hit"].numpy(), reached)
    assert t.task[0] == 0 and t.task[-1] == plan.n_live
    assert (np.diff(t.task) > 0).all()
    assert seg_end[t.task[1:] - 1].all()
    if name == "hub":
        hub = t.part[t.part[:, 3] == 5][0]
        assert hub[1] >= 3                     # three or more blocks
        assert hub[2] + hub[1] - 1 >= 4        # into a second window
    if name == "one_edge_tile":
        assert (seg // R_BLK == 7).sum() == 1


@pytest.mark.parametrize("F", FS)
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("name", CASES)
def test_kernel_order_is_the_old_route_bit_for_bit(name, op, F):
    """The new kernel's order equals the old route's bit for bit and sits
    within the fp32 bound of fp64 (sum) or equals the plain version
    (max)."""
    plan, idx, n_rows, mask = _plan(name)
    x = _values(idx.size, F, seed=F)
    got = kernel_order(x, plan, op)
    old = old_route(x, plan, op)
    np.testing.assert_array_equal(_bits(got), _bits(old))
    plain = ref.segment_agg_graph_ref(torch.as_tensor(x), plan.index,
                                      plan.live, n_rows, op).numpy()
    if op == "max":
        np.testing.assert_array_equal(got, plain)
        return
    live = (idx >= 0) & (idx < n_rows)
    if mask is not None:
        live &= mask
    r, x64 = idx[live], x[live].astype(np.float64)
    want, absum = np.zeros((n_rows, F)), np.zeros((n_rows, F))
    np.add.at(want, r, x64)
    np.add.at(absum, r, np.abs(x64))
    n = np.bincount(r, minlength=n_rows)[:, None]
    assert (np.abs(got - want) <= n * 2.0 ** -24 * absum).all()


@pytest.mark.parametrize("F", [1, 70])
def test_the_order_check_has_teeth(F):
    """On the hub plan a plain left fold of each row differs from the old
    route in some row: the bit-equality above checks the order, not only
    the values."""
    plan, idx, n_rows, _ = _plan("hub")
    x = _values(idx.size, F, seed=F)
    old = old_route(x, plan, "sum")
    fold = np.zeros((n_rows, F), np.float32)
    for e in np.argsort(idx, kind="stable"):
        fold[idx[e]] += x[e]
    assert not np.array_equal(_bits(fold), _bits(old))


@pytest.mark.parametrize("op", ["sum", "max"])
def test_bf16_on_the_cpu_is_the_cast_composition(op):
    """bfloat16 values go to the graph entry as they are; on the CPU it is
    the cast, fp32 plain version, cast back, in bf16 (what the card's bf16
    instance must equal)."""
    plan, idx, n_rows, _ = _plan("random")
    xb = torch.as_tensor(_values(idx.size, 24, seed=3)).to(torch.bfloat16)
    got = ops.segment_agg_graph(xb, plan, op)
    want = ref.segment_agg_graph_ref(xb.float(), plan.index, plan.live,
                                     n_rows, op).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    summed = ops.graph_sum(xb, plan) if op == "sum" \
        else ops.graph_max(xb, plan)
    assert summed.dtype == torch.bfloat16 and torch.equal(summed, want)


@pytest.mark.parametrize("per_group", [1, 2, 3, 4])
@pytest.mark.parametrize("name", CASES)
def test_pending_partials_fit_the_kernel(name, per_group):
    """A lane group streaming ``per_group`` tasks never holds more crossing
    rows' partials unsettled than the kernel has room for (4: one carried
    over and at most ``ops.CHUNK_ENDS`` = 3 ending in one step of
    ``ops.IN_FLIGHT`` slots); the "pending" plan fills that room."""
    plan = _plan(name)[0]
    peak = chip_smoke.pending_peak(plan.tables, per_group)
    assert peak <= ops.CHUNK_ENDS + 1
    if name == "pending" and per_group >= 3:
        assert peak == ops.CHUNK_ENDS + 1


def test_more_crossing_ends_than_the_kernel_holds_raise():
    """``graph_tables`` refuses a layout in which more than
    ``ops.CHUNK_ENDS`` crossing segments end in ``ops.IN_FLIGHT`` slots
    (blocks of two slots, which ``make_plan`` never lays out), where the
    kernel would drop a partial."""
    rows = np.repeat(np.arange(4), 2)
    pos = np.array([255, 256, 511, 512, 767, 768, 1023, 1024])
    with pytest.raises(AssertionError, match="crossing segments end"):
        ops.graph_tables(pos, np.arange(8), rows, 4)
    # one row over three blocks, a slot each: 3 ends, which fit
    t = ops.graph_tables(np.array([255, 256, 512]), np.arange(3),
                         np.zeros(3, int), 1)
    assert t.part.shape[0] == 3
