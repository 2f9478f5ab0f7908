"""The port's host copies and dense engine against the JAX package's
(``backend="xla"`` on the CPU): the same overlay, decisions and plan tables
bit for bit, and the same answers for every aggregate x tuple/time window x
scalar/vector payload on one event stream — float sums within 1e-4, max/min,
counts and top-k ids exactly. Also: state carried across mid-stream through
``repro_torch.convert``, replay determinism, and the features this slice
leaves out raising ``NotImplementedError``."""
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
from repro_torch.core.aggregates import make_aggregate as t_agg  # noqa: E402
from repro_torch.core.bipartite import build_bipartite as t_bip  # noqa: E402
from repro_torch.core.dynamic import DynamicOverlay as TDyn  # noqa: E402
from repro_torch.core.vnm import construct_vnm as t_vnm  # noqa: E402
from repro_torch.core.window import WindowSpec as TSpec  # noqa: E402
from repro_torch.graphs.generators import rmat_graph as t_rmat  # noqa: E402

GRAPH = dict(n_nodes=400, n_edges=2400, seed=7)


def _same_overlay(a, b):
    assert a.kinds == b.kinds
    assert a.origin == b.origin
    assert a.in_edges == b.in_edges
    assert a.dup_insensitive == b.dup_insensitive


@pytest.fixture(scope="module")
def world():
    """Both packages' bipartite graphs and vnm_a overlays of one RMAT
    graph, plus frequencies made with numpy."""
    g_r, g_t = r_rmat(GRAPH["n_nodes"], GRAPH["n_edges"], seed=7), \
        t_rmat(GRAPH["n_nodes"], GRAPH["n_edges"], seed=7)
    bp_r, bp_t = r_bip(g_r), t_bip(g_t)
    ov_r, _ = r_vnm(bp_r, variant="vnm_a", max_iterations=3, seed=0)
    ov_t, _ = t_vnm(bp_t, variant="vnm_a", max_iterations=3, seed=0)
    wf, rf = make_freqs(GRAPH["n_nodes"], seed=7)
    return dict(bp_r=bp_r, bp_t=bp_t, ov_r=ov_r, ov_t=ov_t, wf=wf, rf=rf)


# -------------------------------------------------------------- host copies
@pytest.mark.parametrize("variant", ["vnm_a", "vnm_n", "vnm_d"])
def test_construct_vnm_same_overlay(world, variant):
    a, sa = r_vnm(world["bp_r"], variant=variant, max_iterations=3, seed=1)
    b, sb = t_vnm(world["bp_t"], variant=variant, max_iterations=3, seed=1)
    _same_overlay(a, b)
    assert (sa.iterations, sa.bicliques, sa.si_per_iteration) == \
        (sb.iterations, sb.bicliques, sb.si_per_iteration)
    b.validate(world["bp_t"].reader_input_sets())


@pytest.mark.parametrize("agg,window", [("sum", 1), ("max", 4), ("topk", 8)])
def test_decide_mincut_same_decisions(world, agg, window):
    dr, sr = RD.decide_mincut(world["ov_r"], world["wf"], world["rf"],
                              RD.cost_model_for(agg, window=window),
                              window=window)
    dt, st = TD.decide_mincut(world["ov_t"], world["wf"], world["rf"],
                              TD.cost_model_for(agg, window=window),
                              window=window)
    np.testing.assert_array_equal(dr, dt)
    assert sr.pruned_fraction == st.pruned_fraction


def test_dynamic_overlay_export_same(world):
    ris = world["bp_r"].reader_input_sets()
    a = RDyn.from_overlay(world["ov_r"], ris)
    b = TDyn.from_overlay(world["ov_t"], world["bp_t"].reader_input_sets())
    _same_overlay(a.to_overlay(prune=False), b.to_overlay(prune=False))
    _same_overlay(a.fork().to_overlay(prune=False),
                  b.fork().to_overlay(prune=False))
    _same_overlay(a.to_overlay(), b.to_overlay())


# --------------------------------------------------------------- plan tables
def _decisions(world, agg="sum", window=4):
    return RD.decide_mincut(world["ov_r"], world["wf"], world["rf"],
                            RD.cost_model_for(agg, window=window),
                            window=window)[0]


@pytest.mark.parametrize("headroom", [None, 2.0])
def test_compile_plan_tables_bit_equal(world, headroom):
    dec = _decisions(world)
    pad_r = pad_t = None
    if headroom:
        pad_r = RE.grow_pad(RE.measure_plan(world["ov_r"], dec), headroom)
        pad_t = TE.grow_pad(TE.measure_plan(world["ov_t"], dec), headroom)
        assert pad_r.__dict__ == pad_t.__dict__
    pr = RE.compile_plan(world["ov_r"], dec, backend="xla", pad=pad_r)
    pt = TE.compile_plan(world["ov_t"], dec, pad=pad_t, device="cpu")
    leaves_r = dict(RE._plan_array_leaves(pr.arrays))
    leaves_t = dict(TE._plan_array_leaves(pt.arrays))
    assert leaves_r.keys() == leaves_t.keys()
    for name, leaf in leaves_r.items():
        a, b = np.asarray(leaf), leaves_t[name].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for f in ("n_nodes", "n_writers", "n_levels", "n_row_tiles"):
        assert getattr(pr.meta, f) == getattr(pt.meta, f), f
    assert pr.writer_row_of_base == pt.writer_row_of_base
    assert pr.reader_node_of_base == pt.reader_node_of_base
    np.testing.assert_array_equal(pr.routes.writer_row, pt.routes.writer_row)
    np.testing.assert_array_equal(pr.routes.reader_node, pt.routes.reader_node)
    assert (pr.depth, pr.n_push_edges, pr.n_pull_edges) == \
        (pt.depth, pt.n_push_edges, pt.n_pull_edges)
    assert RE.plan_dims(pr).__dict__ == TE.plan_dims(pt).__dict__


# ------------------------------------------------------------------ answers
CASES = [  # (aggregate, kwargs, window kind, value_dim)
    ("sum", {}, "tuple", 1), ("sum", {}, "time", 1),
    ("count", {}, "tuple", 1), ("count", {}, "time", 1),
    ("avg", {}, "tuple", 1), ("avg", {}, "time", 1),
    ("topk", {"k": 3, "domain": 16}, "tuple", 1),
    ("topk", {"k": 3, "domain": 16}, "time", 1),
    ("max", {}, "tuple", 1), ("max", {}, "time", 1),
    ("min", {}, "tuple", 1), ("min", {}, "time", 1),
    ("sum", {"value_dim": 3}, "tuple", 3), ("sum", {"value_dim": 3}, "time", 3),
    ("max", {"value_dim": 3}, "time", 3), ("min", {"value_dim": 3}, "tuple", 3),
]


def _spec(kind, vd):
    kw = dict(kind=kind, size=4 if kind == "tuple" else 3.0,
              capacity=0 if kind == "tuple" else 8, value_dim=vd)
    return RSpec(**kw), TSpec(**kw)


def _batch(rng, bp, agg, vd, n=48):
    ids = rng.choice(bp.writers, n)
    if agg == "topk":
        return ids, rng.integers(0, 16, n).astype(np.float32)
    shape = (n,) if vd == 1 else (n, vd)
    return ids, rng.normal(size=shape).astype(np.float32)


def _assert_answers(agg, got, want):
    if agg in ("sum", "avg"):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:  # max/min are exact; counts and top-k ids are integer-exact
        np.testing.assert_array_equal(got, want)


def _engines(world, agg, kw, kind, vd, headroom=2.0):
    dec = _decisions(world, agg)
    sr, st = _spec(kind, vd)
    ref = RE.EagrEngine(world["ov_r"], dec, r_agg(agg, **kw), sr,
                        backend="xla", headroom=headroom)
    port = TE.EagrEngine(world["ov_t"], dec, t_agg(agg, **kw), st,
                         device="cpu", headroom=headroom)
    return ref, port


@pytest.mark.parametrize("agg,kw,kind,vd", CASES)
def test_engine_answers_match_reference(world, agg, kw, kind, vd):
    ref, port = _engines(world, agg, kw, kind, vd)
    rng = np.random.default_rng(CASES.index((agg, kw, kind, vd)))
    readers = np.asarray(list(world["bp_r"].reader_inputs))
    for i in range(4):
        ids, vals = _batch(rng, world["bp_r"], agg, vd)
        ref.write_batch(ids, vals)
        port.write_batch(ids, vals)
        if i == 2:  # an all-dropped batch only advances the clock
            ref.write_batch(np.array([10**6]), vals[:1])
            port.write_batch(np.array([10**6]), vals[:1])
        q = rng.choice(readers, 24)
        _assert_answers(agg, port.read_batch(q), np.asarray(ref.read_batch(q)))
    assert float(port.state.now) == float(ref.state.now)
    assert port._now_host == ref._now_host
    if kind == "time":
        # under time windows the engines answer from PAOs evaluated at the
        # last write (the invertible path even subtracts an entry only when
        # the ring overwrites it), while the window oracle ages entries out
        # at the read's clock: the JAX package's engine disagrees with it the
        # same way, so the oracle is ground truth for tuple windows only
        return
    # and against the window oracle, independent of the overlay
    ris = world["bp_t"].reader_input_sets()
    for r in readers[:8]:
        got = port.read_batch(np.array([r]))[0]
        _assert_answers(agg, np.ravel(got),
                        np.ravel(port.oracle_read(int(r), ris)))


def test_refresh_pao_matches_reference(world):
    ref, port = _engines(world, "max", {}, "time", 1)
    rng = np.random.default_rng(5)
    for _ in range(3):
        ids, vals = _batch(rng, world["bp_r"], "max", 1)
        ref.write_batch(ids, vals)
        port.write_batch(ids, vals)
    want = np.asarray(RE._refresh_pao(ref.plan.meta, ref.agg, ref.spec,
                                      ref.plan.arrays, ref.state.windows,
                                      ref.state.now))
    got = TE.refresh_pao_step(port.plan.meta, port.agg, port.spec,
                              port.plan.arrays, port.state.windows,
                              port.state.now).numpy()
    np.testing.assert_array_equal(got, want)


def test_replay_is_bit_identical(world):
    _, port = _engines(world, "sum", {}, "tuple", 1)
    rng = np.random.default_rng(9)
    stream = [_batch(rng, world["bp_t"], "sum", 1, n=96) for _ in range(3)]
    finals = []
    for _ in range(2):
        port.adopt_state(port.init_state(), now_host=0.0, last_eval_now=0.0)
        for ids, vals in stream:
            port.write_batch(ids, vals)
        finals.append(port.state.pao.clone())
    assert torch.equal(finals[0], finals[1])


# ------------------------------------------------------ carrying state across
@pytest.mark.parametrize("agg,kind", [("sum", "tuple"), ("max", "time"),
                                      ("topk", "time")])
def test_state_carried_across_mid_stream(world, agg, kind):
    kw = {"k": 3, "domain": 16} if agg == "topk" else {}
    ref, _ = _engines(world, agg, kw, kind, 1)
    rng = np.random.default_rng(21)
    for _ in range(3):
        ref.write_batch(*_batch(rng, world["bp_r"], agg, 1))
    arrays, objs = RE.plan_snapshot(ref.plan)
    plan = convert.plan_from_reference(arrays, objs, device="cpu")
    state = convert.state_from_reference(
        window_state_to_host(ref.state.windows), np.asarray(ref.state.pao),
        np.asarray(ref.state.now), device="cpu")
    port = TE.EagrEngine(world["ov_t"], ref.plan.decision,
                         t_agg(agg, **kw), _spec(kind, 1)[1], device="cpu",
                         plan=plan)
    port.adopt_state(state, now_host=ref._now_host,
                     last_eval_now=ref._last_eval_now, expiry=ref._expiry)
    readers = np.asarray(list(world["bp_r"].reader_inputs))
    q = rng.choice(readers, 32)
    _assert_answers(agg, port.read_batch(q), np.asarray(ref.read_batch(q)))
    ids, vals = _batch(rng, world["bp_r"], agg, 1)
    ref.write_batch(ids, vals)
    port.write_batch(ids, vals)
    _assert_answers(agg, port.read_batch(q), np.asarray(ref.read_batch(q)))


def test_plan_snapshot_round_trip(world):
    pt = TE.compile_plan(world["ov_t"], _decisions(world), device="cpu")
    back = TE.plan_from_snapshot(*TE.plan_snapshot(pt), device="cpu")
    for (name, a), (_, b) in zip(TE._plan_array_leaves(pt.arrays),
                                 TE._plan_array_leaves(back.arrays)):
        assert torch.equal(a, b), name
    assert back.meta == pt.meta
    assert back.writer_row_of_base == pt.writer_row_of_base


def test_convert_rejects_unrolled_plans(world):
    pr = RE.compile_plan(world["ov_r"], _decisions(world),
                         backend="xla_unrolled")
    with pytest.raises(ValueError, match="xla_unrolled"):
        convert.plan_from_reference(*RE.plan_snapshot(pr))


# ------------------------------------------------------------ out of slice
def test_features_outside_the_slice_raise(world, monkeypatch):
    _, port = _engines(world, "sum", {}, "tuple", 1, headroom=None)
    rows = np.zeros(16, np.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.write_rows(rows, np.zeros(16, np.float32), np.ones(16, bool),
                        active=(np.zeros(1, np.int32),))
    for call in (lambda: port.apply_delta(None),
                 lambda: port.adopt_decisions(port.plan.decision),
                 lambda: port.attach_alerts(None)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    monkeypatch.setenv("EAGR_SEGAGG_BF16", "1")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TE.compile_plan(world["ov_t"], port.plan.decision)


def test_engine_rejects_negative_edges_for_max(world):
    ov_r, _ = r_vnm(world["bp_r"], variant="vnm_n", max_iterations=3, seed=0)
    ov_t, _ = t_vnm(world["bp_t"], variant="vnm_n", max_iterations=3, seed=0)
    if not any(s < 0 for ins in ov_t.in_edges for _, s in ins):
        pytest.skip("no negative edges on this seed")
    dec = np.zeros(ov_t.n_nodes, np.int64)
    with pytest.raises(ValueError):
        RE.EagrEngine(ov_r, dec, r_agg("max"), RSpec("tuple", 2),
                      backend="xla")
    with pytest.raises(ValueError):
        TE.EagrEngine(ov_t, dec, t_agg("max"), TSpec("tuple", 2),
                      device="cpu")


def test_calibrated_cost_model_times_the_aggregate_in_torch():
    cm = TD.calibrate_cost_model(t_agg("sum"), pao_dim=2, device="cpu")
    assert cm.name == "calibrated"
    assert cm.H(4) == 1.0 and cm.L(32) >= 1.0
