"""Each kernel's cost function held to the bound column of PERF.md's table
of kernels (section 6), at that table's shapes, within 1% (or half a unit
of the table's last digit where it prints fewer than three figures); the
graph entry's rows on edge plans of the table's sizes (uniform random
edges, as the GNN cells draw them). The EAGr rows need the main path's
real plans: there ``chip_smoke.py``'s bound helpers, which call the cost
functions, are checked against the formulas by hand at a small stated
size. The bounds take one H100 SXM5's data-sheet peaks."""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as bag  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash  # noqa: E402
from repro_torch.kernels.segment_agg import ops as seg  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _close(got_ms: float, table_ms: float, digits: int) -> bool:
    """Within 1% of the table, or within half a unit of its last printed
    digit (``digits`` after the point)."""
    return abs(got_ms - table_ms) <= max(0.01 * table_ms, 0.5 * 10 ** -digits)


def _plan(n_edges: int, n_rows: int, seed: int):
    idx = np.random.default_rng(seed).integers(0, n_rows, n_edges)
    return seg.make_edge_plan(torch.as_tensor(idx), n_rows)


# (name, edges, rows, F, table ms, digits, bound by)
GRAPH_ROWS = [
    ("graphcast mesh set into dst", 327_680, 40_962, 512, 0.22615, 5),
    ("graphcast mesh set into src", 327_680, 40_962, 512, 0.22615, 5),
    ("grid2mesh into dst", 679_936, 40_962, 512, 0.44234, 5),
    ("grid2mesh into src", 679_936, 169_984, 512, 0.52122, 5),
    ("mesh2grid into dst", 679_936, 169_984, 512, 0.52122, 5),
    ("mesh2grid into src", 679_936, 40_962, 512, 0.44234, 5),
    ("GAT messages", 168_960, 169_984, 64, 0.02630, 5),
    ("GAT softmax max", 168_960, 169_984, 8, 0.003641, 6),
    ("NequIP messages F 32", 8_192, 3_840, 32, 0.00048, 5),
    ("NequIP messages F 96", 8_192, 3_840, 96, 0.00140, 5),
    ("NequIP messages F 160", 8_192, 3_840, 160, 0.00232, 5),
    ("NequIP readout", 3_840, 128, 1, 0.00001, 5),
]


@pytest.mark.parametrize("row", GRAPH_ROWS, ids=[r[0] for r in GRAPH_ROWS])
def test_graph_cost_matches_table(row):
    name, E, R, F, table, digits = row
    plan = _plan(E, R, seed=len(name))
    w = seg.graph_cost(plan.n_live, plan.n_rows, F)
    ms, by = cost.bound_ms(w)
    assert by == "bytes"
    assert _close(ms, table, digits), (ms, table)
    # the formula by hand: 8 B of slot table and 4 F B of values a live
    # edge, 4 F B an output row
    assert plan.n_live == E
    assert w.bytes == 8 * E + 4 * F * (E + R)
    assert w.ops == E * F


@pytest.mark.parametrize("row", GRAPH_ROWS, ids=[r[0] for r in GRAPH_ROWS])
def test_graph_cost_counts_two_bytes_a_bf16_value(row):
    """The bf16 instance at each row's shape: 2 F B of each live edge and
    output row, the same 8 B of slot table a live edge and the same
    operations; its bound is that many bytes over the HBM rate, below the
    fp32 row's."""
    name, E, R, F, table, digits = row
    plan = _plan(E, R, seed=len(name))
    w = seg.graph_cost(plan.n_live, plan.n_rows, F, 2)
    assert w.bytes == 8 * E + 2 * F * (E + R)
    assert w.ops == E * F
    ms, by = cost.bound_ms(w)
    assert by == "bytes"
    fp32 = cost.bound_ms(seg.graph_cost(plan.n_live, plan.n_rows, F))[0]
    assert ms == cost.bound_ms(cost.Work(w.ops, w.bytes))[0] < fp32


def test_graph_entry_counts_its_values_dtype():
    """Under ``cost.counting()`` the graph entry counts 2 B a value for
    bf16 values and 4 for fp32, on either path."""
    plan = _plan(400, 50, seed=1)
    x = torch.randn(400, 12)
    seg.reset_launches()
    with cost.counting():
        seg.segment_agg_graph(x, plan, "sum")
        seg.segment_agg_graph(x.to(torch.bfloat16), plan, "max")
    w32 = seg.graph_cost(400, 50, 12)
    w16 = seg.graph_cost(400, 50, 12, 2)
    assert seg.WORK.snapshot() == {
        "sum_gnn": dict(calls=1, ops=w32.ops, bytes=w32.bytes),
        "max_gnn": dict(calls=1, ops=w16.ops, bytes=w16.bytes)}
    assert w32.bytes - w16.bytes == 2 * 12 * (400 + 50)
    seg.reset_launches()


# (name, B, Hq, Hkv, S, d, table ms)
PREFILL_ROWS = [
    ("granite-3-2b", 8, 32, 8, 2048, 64, 0.13904),
    ("dbrx-132b", 8, 48, 8, 2048, 128, 0.41711),
    ("arctic-480b", 8, 56, 8, 2048, 128, 0.48662),
    ("command-r-plus-104b", 8, 96, 8, 2048, 128, 0.83421),
]


@pytest.mark.parametrize("row", PREFILL_ROWS, ids=[r[0] for r in PREFILL_ROWS])
def test_prefill_cost_matches_table(row):
    _, B, Hq, Hkv, S, d, table = row
    w = flash.prefill_cost(B, Hq, Hkv, S, S, d, True, 2)
    ms, by = cost.bound_ms(w)
    # the table's rows took 989e12 FLOP/s; the data sheet's 989.4e12 moves
    # them by 0.04%
    assert by == "operations" and _close(ms, table, 5), (ms, table)
    assert w.ops == 4 * d * B * Hq * S * (S + 1) // 2


# (name, Hq, Hkv, d, table ms): B 8 against a 2,080-row cache, live
# lengths spread over 2,049..2,080 (chip_smoke.py's serve-shape rows)
DECODE_ROWS = [
    ("granite-3-2b", 32, 8, 64, 0.010117),
    ("dbrx-132b", 48, 8, 128, 0.020253),
    ("arctic-480b", 56, 8, 128, 0.020262),
    ("command-r-plus-104b", 96, 8, 128, 0.020311),
]


@pytest.mark.parametrize("row", DECODE_ROWS, ids=[r[0] for r in DECODE_ROWS])
def test_decode_cost_matches_table(row):
    _, Hq, Hkv, d, table = row
    live = np.linspace(2049, 2080, 8).round().astype(int)
    w = flash.decode_cost(8, Hq, Hkv, d, int(live.sum()), 2)
    ms, by = cost.bound_ms(w)
    assert by == "bytes" and _close(ms, table, 6), (ms, table)


def test_bag_costs_match_table():
    # 512 bags x 16 ids, D 18, weighted (DIEN's profile lookup)
    ms, by = cost.bound_ms(bag.bag_cost(512 * 16, 512 * 16, 512, 18, True))
    assert by == "bytes" and _close(ms, 0.000207, 6)
    # its backward: V 100,000
    ms, by = cost.bound_ms(bag.bag_backward_cost(
        int(0.7 * 512 * 16), 512 * 16, 512, 100_000, 18, True))
    assert by == "bytes" and _close(ms, 0.002180, 6)


def test_causal_pairs_closed_form():
    for Sq, Skv in ((1, 1), (5, 5), (3, 9), (9, 3), (64, 100), (100, 64)):
        off = Skv - Sq
        loop = sum(min(max(i + off + 1, 0), Skv) for i in range(Sq))
        assert flash.causal_pairs(Sq, Skv) == loop
        assert flash.causal_pairs(Sq, Skv, causal=False) == Sq * Skv


# ---------------------------- the EAGr rows: chip_smoke's helpers by hand
@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, os.path.abspath(ROOT))
    import chip_smoke as cs
    return cs


def _level(seed: int, n_rows: int = 300, n_edges: int = 900):
    rng = np.random.default_rng(seed)
    plan = seg.make_plan(rng.integers(0, n_rows, n_edges), n_rows)
    return (torch.as_tensor(plan.seg_padded),
            torch.as_tensor(plan.tile_of_block),
            torch.as_tensor(plan.first_of_tile), plan)


@pytest.mark.parametrize("F", [1, 64])
def test_level_bound_by_hand(chip_smoke, F):
    segv, tob, fot, plan = _level(0)
    n_live = 900
    rows_out = min(int(fot.sum()) * 128, 300)
    nbytes = segv.numel() * 4 + tob.numel() * 8 + n_live * 4 * F \
        + rows_out * 4 * F
    assert chip_smoke.level_bound_ms(segv, tob, fot, F, 300) == \
        (nbytes / 3.35e12 * 1e3, "bytes")


@pytest.mark.parametrize("op", ["sum", "max"])
def test_active_and_stacked_bounds_by_hand(chip_smoke, op):
    segv, tob, fot, plan = _level(1)
    src = torch.arange(segv.numel(), dtype=torch.int32) % 97
    nb = tob.numel()
    act = torch.tensor([0, nb - 1, nb, nb], dtype=torch.int32)
    live = segv >= 0
    blocks_live = (segv.view(nb, -1) >= 0)
    act_slots = torch.zeros_like(live)
    for b in (0, nb - 1):
        act_slots[b * 256:(b + 1) * 256] = True
    # the active entry: the caller passes the active blocks' slots only
    seg_c = torch.where(act_slots, segv, -1)
    n_live = int((seg_c >= 0).sum())
    n_src = int(src[seg_c >= 0].unique().numel())
    tiles = int(tob[torch.tensor([0, nb - 1])].unique().numel())
    slot_b = 12 if op == "sum" else 8
    nbytes = 2 * (256 * slot_b + 12) + n_src * 4 * 2 + tiles * 128 * 4 * 2 \
        + 300
    t_b = nbytes / 3.35e12 * 1e3
    t_o = n_live * 2 * (2 if op == "sum" else 1) / 67e12 * 1e3
    assert chip_smoke.active_bound_ms(seg_c, src, tob, act, 2, 300, op) == \
        (max(t_b, t_o), "bytes")
    # the stacked dense entry over two shards (the same level twice)
    row_b = 2 * 256 * 4 if op == "sum" else 256 * 4
    one = (segv.numel() * 4 + int(blocks_live.any(1).sum()) * row_b
           + int(src[live].unique().numel()) * 4 * 3 + nb * 8
           + min(int(fot.sum()) * 128, 300) * 4 * 3)
    got = chip_smoke.stacked_level_bound_ms(
        torch.stack([segv, segv]), torch.stack([src, src]),
        torch.stack([tob, tob]), torch.stack([fot, fot]), 3, 300, op)
    assert got == (2 * one / 3.35e12 * 1e3, "bytes")


def test_bound_helpers_call_the_cost_functions(chip_smoke):
    assert chip_smoke.prefill_bound_ms(8, 32, 8, 2048, 2048, 64, True, 2) \
        == cost.bound_ms(flash.prefill_cost(8, 32, 8, 2048, 2048, 64, True,
                                            2))
    assert chip_smoke.decode_bound_ms(32, 8, 64, [5, 7], 2) == \
        cost.bound_ms(flash.decode_cost(2, 32, 8, 64, 12, 2))
    assert chip_smoke.bag_bound_ms(10, 12, 3, 18, True) == \
        cost.bound_ms(bag.bag_cost(10, 12, 3, 18, True))
    assert chip_smoke.bag_backward_bound_ms(10, 12, 3, 50, 18, False) == \
        cost.bound_ms(bag.bag_backward_cost(10, 12, 3, 50, 18, False))
    plan = _plan(1000, 77, 0)
    assert chip_smoke.gnn_bound_ms(plan, 16) == cost.bound_ms(
        seg.graph_cost(plan.n_live, 77, 16))
