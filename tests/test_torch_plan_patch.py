"""The port's plan patch path (§3.3) against the JAX package's
(``backend="xla"`` on the CPU): one churn sequence gives bit-equal plan
tables (``plan_snapshot``) and the same tier per burst; freed slots are
reused; a capacity overflow recompiles and patching resumes; the node
lifecycle; the tables keep their storage under in-capacity churn; the
``EAGR_PATCH_PARITY`` mirror holds; a reference-patched plan carries over
through ``convert``. The JAX package's churn property
(``tests/test_plan_patch.py::test_property_patched_plan_stays_exact``) is
replayed on the same seeds against both packages, the port held to the
window oracle."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import make_freqs  # noqa: E402
from repro.core import dataflow as RD  # noqa: E402
from repro.core import engine as RE  # noqa: E402
from repro.core.aggregates import make_aggregate as r_agg  # noqa: E402
from repro.core.bipartite import build_bipartite as r_bip  # noqa: E402
from repro.core.dynamic import DynamicOverlay as RDyn  # noqa: E402
from repro.core.vnm import construct_vnm as r_vnm  # noqa: E402
from repro.core.window import WindowSpec as RSpec  # noqa: E402
from repro.core.window import window_state_to_host  # noqa: E402
from repro.graphs.generators import rmat_graph as r_rmat  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import dataflow as TD  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import plan_patch as PP  # noqa: E402
from repro_torch.core.aggregates import make_aggregate as t_agg  # noqa: E402
from repro_torch.core.bipartite import build_bipartite as t_bip  # noqa: E402
from repro_torch.core.dynamic import DynamicOverlay as TDyn  # noqa: E402
from repro_torch.core.vnm import construct_vnm as t_vnm  # noqa: E402
from repro_torch.core.window import WindowSpec as TSpec  # noqa: E402
from repro_torch.graphs.generators import rmat_graph as t_rmat  # noqa: E402
from repro_torch.kernels.segment_agg import ops as T  # noqa: E402


def _system(port: bool, n=120, e=700, seed=3, agg="sum", spec="tuple",
            headroom=2.0, rng_seed=1):
    """The reference test's ``_system`` in either package: an engine over
    the unpruned export of a DynamicOverlay, plus the overlay journal."""
    rmat, bip, vnm, dyn_c, D = (t_rmat, t_bip, t_vnm, TDyn, TD) if port \
        else (r_rmat, r_bip, r_vnm, RDyn, RD)
    bp = bip(rmat(n, e, seed=seed))
    ov, _ = vnm(bp, variant="vnm_a", max_iterations=2, seed=0)
    dyn = dyn_c.from_overlay(ov, bp.reader_input_sets())
    ov0 = dyn.to_overlay(prune=False)
    wf, rf = make_freqs(n, seed=rng_seed)
    dec, _ = D.decide_mincut(ov0, wf, rf, D.cost_model_for(agg))
    if port:
        w = TSpec("tuple", 4) if spec == "tuple" else TSpec("time", 3.0,
                                                             capacity=8)
        eng = TE.EagrEngine(ov0, dec, t_agg(agg), w, headroom=headroom,
                            device="cpu")
    else:
        w = RSpec("tuple", 4) if spec == "tuple" else RSpec("time", 3.0,
                                                             capacity=8)
        eng = RE.EagrEngine(ov0, dec, r_agg(agg), w, backend="xla",
                            headroom=headroom)
    return eng, dyn, bp


def _churn_step(dyn, rng, readers, n_base=120):
    """The reference test's churn step: add/delete an edge, add/delete a
    node."""
    op = int(rng.integers(0, 4))
    if op == 0:
        dyn.add_edge(int(rng.integers(0, n_base)), int(rng.choice(readers)))
    elif op == 1:
        r = int(rng.choice(readers))
        if dyn.reader_inputs.get(r):
            dyn.delete_edge(int(next(iter(dyn.reader_inputs[r]))), r)
    elif op == 2:
        nid = int(rng.integers(1000, 2000))
        dyn.add_node(nid,
                     in_neighbors={int(x) for x in rng.integers(0, n_base, 3)},
                     out_readers={int(rng.choice(readers))})
    else:
        victims = [k for k in list(dyn.reader_inputs) if k >= 1000]
        if victims:
            dyn.delete_node(int(rng.choice(victims)))


def _oracle_gaps(eng, dyn, q):
    """(reader, got, want) for every reader of ``q`` whose answer leaves the
    window oracle by more than 1e-4."""
    out = np.asarray(eng.read_batch(q, batch_size=max(4, len(q))))
    gaps = []
    for i, b in enumerate(q):
        want = np.ravel(eng.oracle_read(int(b), dyn.reader_inputs))
        got = np.ravel(out[i])
        if not np.allclose(got, want, rtol=1e-4, atol=1e-4):
            gaps.append((int(b), got.tolist(), want.tolist()))
    return gaps


def _pool(eng, dyn):
    return [r for r in dyn.reader_inputs
            if dyn.reader_inputs[r] and r in eng.plan.reader_node_of_base]


def _tables(plan):
    return {f"pa.{k}": v.cpu().numpy().copy()
            for k, v in TE._plan_array_leaves(plan.arrays)}


def _ptrs(plan):
    return {k: v.data_ptr() for k, v in TE._plan_array_leaves(plan.arrays)}


def _assert_plans_equal(pr, pt):
    ar, orr = RE.plan_snapshot(pr)
    at, ot = TE.plan_snapshot(pt)
    assert ar.keys() == at.keys()
    for k in ar:
        a, b = np.asarray(ar[k]), np.asarray(at[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert orr["depth"] == ot["depth"]
    for f in ("n_push_edges", "n_pull_edges", "patches_applied"):
        assert orr[f] == ot[f], f
    np.testing.assert_array_equal(pr.routes.writer_row, pt.routes.writer_row)
    np.testing.assert_array_equal(pr.routes.reader_node,
                                  pt.routes.reader_node)


# ----------------------------------------------------- against the reference
@pytest.mark.parametrize("agg,spec", [("sum", "tuple"), ("max", "time")])
def test_churn_tables_bit_equal_to_reference(agg, spec, monkeypatch):
    """One churn sequence into both packages: after every burst the plan
    tables, decisions, levels, id maps and routes are bit-equal, the tier
    (patched / relayout / recompiled) is the same, the port's tables keep
    their storage while nothing recompiles, and the answers agree (max
    exactly, sums within 1e-4) and equal the window oracle on tuple
    windows. The parity mirror checks every patch."""
    monkeypatch.setenv("EAGR_PATCH_PARITY", "1")
    er, dr, bp = _system(False, agg=agg, spec=spec)
    et, dt, _ = _system(True, agg=agg, spec=spec)
    rng = np.random.default_rng(7)
    readers = list(bp.reader_inputs)
    kinds = []
    for step in range(14):
        state = rng.bit_generator.state
        for dyn in (dr, dt):
            rng.bit_generator.state = state
            for _ in range(3):
                _churn_step(dyn, rng, readers)
        ptrs = _ptrs(et.plan)
        rr, rt = er.apply_delta(dr.drain_delta()), \
            et.apply_delta(dt.drain_delta())
        kinds.append(rt.kind)
        assert (rr.kind, rr.reason) == (rt.kind, rt.reason)
        assert rr.retired_writer_rows == rt.retired_writer_rows
        if not rt.recompiled:
            assert _ptrs(et.plan) == ptrs, "in-capacity patch reallocated"
        _assert_plans_equal(er.plan, et.plan)
        ids = rng.choice(bp.writers, 16)
        vals = rng.normal(size=16).astype(np.float32)
        er.write_batch(ids, vals, batch_size=16)
        et.write_batch(ids, vals, batch_size=16)
        q = np.array(sorted(_pool(et, dt))[step::7][:8])
        a, b = np.asarray(er.read_batch(q)), et.read_batch(q)
        if agg == "max":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
            assert _oracle_gaps(et, dt, q) == []
    assert "patched" in kinds
    assert et.plan.patches_applied >= 10


def test_patch_reuses_freed_slots():
    """Delete + re-add of one edge stays on the slot tier (no level rebuilt,
    nothing recompiled) and claims from the tiles' free pools exactly as
    the reference does: bit-equal tables after each step, and the re-add
    claims only slots that were free before it."""
    er, dr, bp = _system(False)
    et, dt, _ = _system(True)
    occupied = lambda: {n: set(np.flatnonzero(
        _tables(et.plan)[f"pa.{n}.seg"] >= 0).tolist())
        for n in ("push", "pull")}
    r = next(r for r, s in dt.reader_inputs.items() if s)
    w = int(next(iter(dt.reader_inputs[r])))
    for dyn in (dr, dt):
        dyn.delete_edge(w, r)
    rr, res1 = er.apply_delta(dr.drain_delta()), \
        et.apply_delta(dt.drain_delta())
    assert not res1.recompiled and res1.stats["edges_removed"] >= 1
    assert rr.stats == res1.stats
    _assert_plans_equal(er.plan, et.plan)
    mid = occupied()
    for dyn in (dr, dt):
        dyn.add_edge(w, r)
    rr, res2 = er.apply_delta(dr.drain_delta()), \
        et.apply_delta(dt.drain_delta())
    assert not res2.recompiled and res2.kind == "patched"
    assert res2.stats["edges_added"] >= 1
    assert res2.stats["levels_rebuilt"] == 0
    assert rr.stats == res2.stats
    _assert_plans_equal(er.plan, et.plan)
    after = occupied()
    claimed = sum(len(after[n] - mid[n]) for n in after)
    assert claimed == res2.stats["edges_added"]
    rng = np.random.default_rng(0)
    et.write_batch(rng.choice(bp.writers, 16),
                   rng.normal(size=16).astype(np.float32), batch_size=16)
    assert _oracle_gaps(et, dt, np.array(_pool(et, dt)[:6])) == []


def test_recompile_fallback_with_growth_then_patch():
    """Exceeding capacity falls back to compile_plan with growth headroom
    (as the reference does, on the same delta); the next small delta
    patches in place again, tables keeping their storage."""
    er, dr, bp = _system(False, headroom=None)
    et, dt, _ = _system(True, headroom=None)
    rng = np.random.default_rng(13)
    ids, vals = rng.choice(bp.writers, 16), \
        rng.normal(size=16).astype(np.float32)
    er.write_batch(ids, vals, batch_size=16)
    et.write_batch(ids, vals, batch_size=16)
    for r in list(bp.reader_inputs)[:6]:
        add = {int(x) for x in rng.integers(0, 120, 40)}
        dr.add_reader_inputs(int(r), add)
        dt.add_reader_inputs(int(r), add)
    rr, rt = er.apply_delta(dr.drain_delta()), et.apply_delta(dt.drain_delta())
    assert rt.recompiled and rt.reason == rr.reason
    _assert_plans_equal(er.plan, et.plan)
    assert _oracle_gaps(et, dt, np.array(_pool(et, dt)[:8])) == []
    dims, ptrs = TE.plan_dims(et.plan), _ptrs(et.plan)
    for dyn in (dr, dt):
        dyn.add_edge(int(bp.writers[1]), int(list(bp.reader_inputs)[0]))
    rr, rt = er.apply_delta(dr.drain_delta()), et.apply_delta(dt.drain_delta())
    assert not rt.recompiled and not rr.recompiled
    assert TE.plan_dims(et.plan) == dims and _ptrs(et.plan) == ptrs
    _assert_plans_equal(er.plan, et.plan)
    assert _oracle_gaps(et, dt, np.array(_pool(et, dt)[:8])) == []


def test_node_lifecycle_add_write_read_delete():
    eng, dyn, bp = _system(True)
    rng = np.random.default_rng(17)
    r0 = int(list(bp.reader_inputs)[0])
    dyn.add_node(777, in_neighbors={int(bp.writers[0]), int(bp.writers[1])},
                 out_readers={r0})
    assert not eng.apply_delta(dyn.drain_delta()).recompiled
    eng.write_batch(np.array([777]), np.array([4.5], np.float32), batch_size=4)
    eng.write_batch(np.array([int(bp.writers[0])]),
                    np.array([2.0], np.float32), batch_size=4)
    assert _oracle_gaps(eng, dyn, np.array([777, r0])) == []
    dyn.delete_node(777)
    res = eng.apply_delta(dyn.drain_delta())
    assert res.retired_writer_rows
    with pytest.raises(ValueError, match="not.*readers"):
        eng.read_batch(np.array([777]))
    before = eng.state.pao.clone()
    eng.write_batch(np.array([777]), np.array([9.0], np.float32))
    assert torch.equal(eng.state.pao, before)  # the retired base is dropped
    assert _oracle_gaps(eng, dyn, np.array(_pool(eng, dyn)[:6])) == []


def test_same_epoch_add_delete_keeps_writer_rows_stable():
    """A writer added and deleted in one drain epoch still claims a window
    row, so a later writer keeps its row across a capacity recompile."""
    eng, dyn, bp = _system(True)
    rng = np.random.default_rng(29)
    r0 = int(list(bp.reader_inputs)[0])
    dyn.add_node(1000, in_neighbors=set(), out_readers={r0})
    dyn.delete_node(1000)
    delta = dyn.drain_delta()
    assert delta.new_writer_nodes
    eng.apply_delta(delta)
    dyn.add_node(1001, in_neighbors=set(), out_readers={r0})
    eng.apply_delta(dyn.drain_delta())
    eng.write_batch(np.array([1001]), np.array([123.0], np.float32),
                    batch_size=4)
    before = float(np.ravel(eng.read_batch(np.array([r0])))[0])
    res = None
    for k in range(12):
        for j in range(60):
            dyn.add_node(2000 + 100 * k + j,
                         in_neighbors={int(x)
                                       for x in rng.integers(0, 120, 3)},
                         out_readers={r0})
        res = eng.apply_delta(dyn.drain_delta())
        if res.recompiled:
            break
    assert res is not None and res.recompiled
    after = float(np.ravel(eng.read_batch(np.array([r0])))[0])
    assert _oracle_gaps(eng, dyn, np.array([r0])) == []
    assert abs(after - before) < 1e-3


def test_empty_delta_is_free():
    eng, dyn, _ = _system(True)
    state = eng.state
    res = eng.apply_delta(dyn.drain_delta())
    assert res.reason == "empty delta" and not res.recompiled
    assert eng.state is state


def test_parity_mirror_catches_a_stray_edit(monkeypatch):
    """Under EAGR_PATCH_PARITY the host mirror replays every edit and
    ``verify_device`` passes after each patch; a table edited behind its
    back is caught."""
    monkeypatch.setenv("EAGR_PATCH_PARITY", "1")
    eng, dyn, bp = _system(True)
    rng = np.random.default_rng(3)
    readers = list(bp.reader_inputs)
    for _ in range(6):
        _churn_step(dyn, rng, readers)
        eng.apply_delta(dyn.drain_delta())  # verifies itself
    host = eng.plan.host
    assert host.auto_verify and host.push.mirror is not None
    host.verify_device(eng.plan)
    live = int(np.flatnonzero(_tables(eng.plan)["pa.pull.seg"][0] >= 0)[0])
    eng.plan.arrays.pull.sign[0, live] += 1.0
    with pytest.raises(AssertionError, match="pull.sign"):
        host.verify_device(eng.plan)


def test_patched_engine_matches_fresh_compile():
    eng, dyn, bp = _system(True)
    rng = np.random.default_rng(11)
    readers = list(bp.reader_inputs)
    writes = []
    for _ in range(10):
        _churn_step(dyn, rng, readers)
        eng.apply_delta(dyn.drain_delta())
        ids = rng.choice(bp.writers, 16)
        vals = rng.normal(size=16).astype(np.float32)
        writes.append((ids, vals))
        eng.write_batch(ids, vals, batch_size=16)
    fresh = TE.EagrEngine(dyn.to_overlay(prune=False), eng.plan.decision,
                          t_agg("sum"), TSpec("tuple", 4), device="cpu")
    for ids, vals in writes:
        fresh.write_batch(ids, vals, batch_size=16)
    q = np.array(_pool(eng, dyn)[:12])
    np.testing.assert_allclose(eng.read_batch(q), fresh.read_batch(q),
                               rtol=1e-4, atol=1e-4)


# ----------------------------------------------------- the table helpers
def test_scatter_helpers_in_place_and_pads_harmless():
    """``scatter_slots``/``scatter_rows`` write in place; shape-bucket pads
    (level out of bounds) write nothing new, also when the list holds no
    real edit; ``patch_level`` and ``tile_occupancy`` agree with numpy."""
    rng = np.random.default_rng(5)
    lp = T.make_leveled_plan([rng.integers(0, 300, e) for e in (40, 513)],
                             300)
    seg = torch.as_tensor(lp.seg.copy())
    ptr, want = seg.data_ptr(), lp.seg.copy()
    oob = PP._OOB + np.arange(5, dtype=np.int32)
    lvl = torch.as_tensor(np.r_[np.int32(1), np.int32(0), oob])
    slot = torch.as_tensor(np.r_[np.int32(7), np.int32(300), np.zeros(5)]
                           .astype(np.int32))
    vals = torch.as_tensor(np.r_[np.int32(5), np.int32(-1), np.zeros(5)]
                           .astype(np.int32))
    T.scatter_slots(seg, lvl, slot, vals)
    want[1, 7], want[0, 300] = 5, -1
    assert seg.data_ptr() == ptr
    np.testing.assert_array_equal(seg.numpy(), want)
    T.scatter_slots(seg, torch.as_tensor(oob), torch.zeros(5, dtype=torch.int32),
                    torch.full((5,), 9, dtype=torch.int32))
    np.testing.assert_array_equal(seg.numpy(), want)
    row = np.arange(lp.e_pad, dtype=np.int32)
    T.scatter_rows(seg, torch.as_tensor(np.r_[np.int32(0), oob[:2]]),
                   torch.as_tensor(np.stack([row, row * 0, row * 0])))
    want[0] = row
    np.testing.assert_array_equal(seg.numpy(), want)
    dec = torch.zeros(10, dtype=torch.int32)
    T.scatter_rows(dec, torch.as_tensor(np.r_[np.int32(3), oob[:3]]),
                   torch.as_tensor(np.array([1, 0, 0, 0], np.int32)))
    assert dec.tolist() == [0, 0, 0, 1, 0, 0, 0, 0, 0, 0]
    seg2 = torch.as_tensor(lp.seg.copy())
    src = torch.zeros_like(seg2)
    sign = torch.zeros(seg2.shape)
    T.patch_level(seg2, src, sign, 1, [3, 9], [12, -1], [4, 0], [1.0, 0.0])
    assert seg2[1, 3] == 12 and seg2[1, 9] == -1 and src[1, 3] == 4
    occ = T.tile_occupancy(torch.as_tensor(lp.seg),
                           torch.as_tensor(lp.tile_of_block), lp.n_row_tiles)
    for l in range(lp.n_levels):
        live = lp.seg[l] >= 0
        tiles = np.repeat(lp.tile_of_block[l], T.E_BLK)[live]
        np.testing.assert_array_equal(
            occ[l].numpy(), np.bincount(tiles, minlength=lp.n_row_tiles))


def test_relayout_level_respects_block_budget():
    rng = np.random.default_rng(2)
    dst, src = rng.integers(0, 256, 30), rng.integers(0, 256, 30)
    lp = T.make_leveled_plan([dst], 256)
    nb = lp.seg.shape[1] // T.E_BLK
    out = T.relayout_level(dst, src, np.ones(30), 256, nb, lp.e_pad)
    assert out is not None
    assert (np.sort(out[0][out[0] >= 0]) == np.sort(dst)).all()
    big = rng.integers(0, 256, nb * T.E_BLK + 1)
    assert T.relayout_level(big, big, np.ones_like(big), 256, nb,
                            nb * T.E_BLK) is None


# --------------------------------------------------------------- convert
def test_reference_patched_plan_carries_over():
    """A plan the reference has patched (unpruned id space, retired writer
    rows) and its state cross into the port through ``convert``; it equals
    the port's own churned plan table for table, answers alike, and keeps
    patching in place."""
    er, dr, bp = _system(False)
    et, dt, _ = _system(True)
    rng = np.random.default_rng(21)
    readers = list(bp.reader_inputs)
    for _ in range(6):
        state = rng.bit_generator.state
        for dyn in (dr, dt):
            rng.bit_generator.state = state
            _churn_step(dyn, rng, readers)
        er.apply_delta(dr.drain_delta())
        et.apply_delta(dt.drain_delta())
    for dyn in (dr, dt):  # a retired writer row
        dyn.add_node(1500, in_neighbors=set(), out_readers={readers[0]})
    er.apply_delta(dr.drain_delta())
    et.apply_delta(dt.drain_delta())
    ids = rng.choice(bp.writers, 16)
    vals = rng.normal(size=16).astype(np.float32)
    for eng in (er, et):
        eng.write_batch(np.r_[ids, 1500], np.r_[vals, 2.0].astype(np.float32))
    for dyn in (dr, dt):
        dyn.delete_node(1500)
    er.apply_delta(dr.drain_delta())
    et.apply_delta(dt.drain_delta())
    assert et.plan.host.retired_writer_bases
    arrays, objs = RE.plan_snapshot(er.plan)
    plan = convert.plan_from_reference(arrays, objs, device="cpu")
    for k, v in _tables(et.plan).items():
        np.testing.assert_array_equal(_tables(plan)[k], v, err_msg=k)
    assert plan.writer_row_of_base == et.plan.writer_row_of_base
    assert plan.depth == et.plan.depth
    win = window_state_to_host(er.state.windows)
    state = convert.state_from_reference(win, np.asarray(er.state.pao),
                                         np.asarray(er.state.now),
                                         device="cpu")
    carried = TE.EagrEngine(dt.to_overlay(prune=False), plan.decision,
                            t_agg("sum"), TSpec("tuple", 4), plan=plan,
                            device="cpu")
    carried.adopt_state(state, now_host=et._now_host,
                        last_eval_now=et._last_eval_now)
    q = np.array(_pool(et, dt)[:10])
    np.testing.assert_array_equal(carried.read_batch(q), et.read_batch(q))
    dt2 = dt.fork()  # the carried engine's own journal
    dt.add_edge(int(bp.writers[2]), int(readers[1]))
    dt2.add_edge(int(bp.writers[2]), int(readers[1]))
    r1 = et.apply_delta(dt.drain_delta())
    r2 = carried.apply_delta(dt2.drain_delta())
    assert r1.kind == r2.kind and not r2.recompiled
    for k, v in _tables(et.plan).items():
        np.testing.assert_array_equal(_tables(carried.plan)[k], v, err_msg=k)


# ------------------------------------------- the reference's churn property
# tests/test_plan_patch.py::test_property_patched_plan_stays_exact fails in
# the JAX package on seeds 0, 3 and 5 (of 0..39): its answers stay on the
# window oracle, but its jit caches grow without a recompile (the read that
# first falls back from the sparse to the dense read path traces the dense
# read body). The port has no trace cache; it is held to the oracle, and to
# its tables keeping their storage while nothing recompiles.
@pytest.mark.parametrize("seed", [0, 3, 5, 11])
def test_reference_churn_property_replayed(seed):
    answers = []
    for port in (False, True):
        eng, dyn, bp = _system(port, n=100, e=550, seed=seed % 7,
                               headroom=2.5, rng_seed=seed % 5)
        rng = np.random.default_rng(seed)
        readers = list(bp.reader_inputs)
        eng.write_batch(rng.choice(bp.writers, 12),
                        rng.normal(size=12).astype(np.float32), batch_size=12)
        dyn.add_edge(int(bp.writers[0]), int(readers[0]))
        eng.apply_delta(dyn.drain_delta())
        eng.write_batch(rng.choice(bp.writers, 12),
                        rng.normal(size=12).astype(np.float32), batch_size=12)
        ptrs = _ptrs(eng.plan) if port else None
        recompiles, got = 0, []
        for _ in range(12):
            _churn_step(dyn, rng, readers, n_base=100)
            recompiles += bool(eng.apply_delta(dyn.drain_delta()).recompiled)
            eng.write_batch(rng.choice(bp.writers, 12),
                            rng.normal(size=12).astype(np.float32),
                            batch_size=12)
            q = rng.choice(_pool(eng, dyn), 4)
            assert _oracle_gaps(eng, dyn, q) == [], (port, seed)
            got.append(np.asarray(eng.read_batch(q, batch_size=4)))
        if port and recompiles == 0:
            assert _ptrs(eng.plan) == ptrs
        answers.append(got)
    for a, b in zip(*answers):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


def test_adopt_decisions_grows_padding_where_needed():
    """A re-decision that needs more push blocks than the current plan
    pads: the port floors the new plan's dims at the current ones and
    grows where needed, keeps the windows and answers exactly; the JAX
    package passes the current dims alone and its compile raises
    (ROADMAP.md §3)."""
    er, dr, bp = _system(False, n=400, e=2400, headroom=None)
    et, dt, _ = _system(True, n=400, e=2400, headroom=None)
    all_push = np.full(len(et.plan.decision), TD.PUSH, np.int64)
    need = TE.measure_plan(et.overlay, all_push)
    assert need.push_blocks > TE.plan_dims(et.plan).push_blocks
    rng = np.random.default_rng(2)
    ids = rng.choice(bp.writers, 16)
    vals = rng.normal(size=16).astype(np.float32)
    er.write_batch(ids, vals, batch_size=16)
    et.write_batch(ids, vals, batch_size=16)
    with pytest.raises(ValueError, match="pad_blocks"):
        er.adopt_decisions(all_push)
    before = TE.plan_dims(et.plan)
    new = et.adopt_decisions(all_push)
    dims = TE.plan_dims(new)
    assert dims.push_blocks == need.push_blocks
    assert dims.pull_blocks == before.pull_blocks
    assert (new.decision == TD.PUSH).all()
    assert _oracle_gaps(et, dt, np.array(_pool(et, dt)[:12])) == []
