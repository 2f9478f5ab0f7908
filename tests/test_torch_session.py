"""The port's ``EagrSession`` against the JAX package's (``backend="xla"``
on the CPU): the same readers, writers and neighbourhoods, the same answers
for several simultaneous queries on one write stream, Figure 1(b) of the
paper exactly, the same register-time validation errors; plus the port's own
rules — no JAX and no ``repro`` module in a process that runs a session (and
the serve and training paths, a GNN cell among them), no silent fall back
to the CPU, and every arch of the JAX package's registry loading."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.window import WindowSpec as RSpec  # noqa: E402
from repro.graphs.generators import rmat_graph as r_rmat  # noqa: E402
from repro.graphs.generators import small_example_graph as r_small  # noqa: E402
from repro.session import EagrSession as RSession  # noqa: E402
from repro.session import Query as RQuery  # noqa: E402
from repro_torch import EagrSession, Query, WindowSpec, convert  # noqa: E402
from repro_torch.core import dataflow as TD  # noqa: E402
from repro.core import engine as RE  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core.window import init_windows  # noqa: E402
from repro_torch.graphs.generators import rmat_graph, small_example_graph  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
NAMES = "abcdefg"
FIG1B = {"a": 19.0, "b": 19.0, "c": 16.0, "d": 15.0, "e": 18.0, "f": 19.0,
         "g": 25.0}


def test_figure_1b_exactly():
    """The quickstart's values: SUM over N(v) with c = 1 on Figure 1(a)."""
    s = EagrSession(small_example_graph(), device="cpu")
    sums = s.register(Query(agg="sum", window=WindowSpec("tuple", 1)))
    counts = s.register(Query(agg="count"))
    writes = {"a": 4.0, "b": 2.0, "c": 9.0, "d": 3.0, "e": 1.0, "f": 6.0,
              "g": 7.0}
    s.update(np.array([NAMES.index(k) for k in writes]),
             np.array(list(writes.values()), np.float32))
    got = s.read(sums, np.arange(7)).ravel()
    assert got.tolist() == [FIG1B[n] for n in NAMES]
    ref = RSession(r_small(), backend="xla")
    rc = ref.register(RQuery(agg="count"))
    ref.update(np.arange(7), np.ones(7, np.float32))
    np.testing.assert_array_equal(s.read(counts, np.arange(7)),
                                  np.asarray(ref.read(rc, np.arange(7))))
    assert s.n_engine_groups == 2


QUERIES = [("sum", None, RSpec("tuple", 4), WindowSpec("tuple", 4)),
           ("max", None, RSpec("tuple", 4), WindowSpec("tuple", 4)),
           ("count", None, RSpec("time", 3.0, capacity=8),
            WindowSpec("time", 3.0, capacity=8)),
           ("avg", None, RSpec("tuple", 2), WindowSpec("tuple", 2)),
           ("topk", {"k": 2, "domain": 8}, RSpec("tuple", 8),
            WindowSpec("tuple", 8))]


@pytest.mark.parametrize("continuous", [False, True])
def test_session_matches_reference(continuous):
    g_r, g_t = r_rmat(200, 1200, seed=3), rmat_graph(200, 1200, seed=3)
    ref = RSession(g_r, backend="xla")
    port = EagrSession(g_t, device="cpu")
    assert port.readers == ref.readers and port.writers == ref.writers
    for r in port.readers[:20]:
        assert port.neighborhood(r) == ref.neighborhood(r)
    hs = [(ref.register(RQuery(agg=a, agg_kwargs=kw, window=rs,
                               continuous=continuous)),
           port.register(Query(agg=a, agg_kwargs=kw, window=ts,
                               continuous=continuous)), a)
          for a, kw, rs, ts in QUERIES]
    rng = np.random.default_rng(4)
    readers = np.asarray(port.readers)
    for _ in range(4):
        ids = rng.choice(port.writers, 64)
        vals = rng.integers(0, 8, 64).astype(np.float32)
        vals[::3] += rng.normal(size=len(vals[::3])).astype(np.float32)
        ref.update(ids, vals)
        port.update(ids, vals)
        q = rng.choice(readers, 20)
        for hr, ht, a in hs:
            want, got = np.asarray(ref.read(hr, q)), port.read(ht, q)
            if a in ("sum", "avg"):
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
            else:
                np.testing.assert_array_equal(got, want)
    st = port.stats()
    assert (st.n_queries, st.n_engine_groups, st.updates) == (5, 5, 4)


def test_groups_share_engines_and_unregister():
    s = EagrSession(small_example_graph(), device="cpu")
    a = s.register(Query(agg="sum", window=WindowSpec("tuple", 2)))
    b = s.register(Query(agg="SUM", window=WindowSpec("tuple", 2),
                         readers=[0, 1]))
    c = s.register(Query(agg="sum", window=WindowSpec("tuple", 3)))
    assert a.group is b.group and a.group is not c.group
    s.update(np.arange(7), np.arange(7, dtype=np.float32))
    np.testing.assert_array_equal(b.read([0, 1]), s.read(a, [0, 1]))
    with pytest.raises(ValueError, match="outside"):
        s.read(b, [2])
    s.unregister(a)
    assert s.n_engine_groups == 2 and s.queries == [b, c]
    with pytest.raises(ValueError, match="unknown query handle"):
        s.read(a, [0])


@pytest.mark.parametrize("bad", [
    dict(agg="median"),
    dict(agg="sum", window=RSpec("session", 1)),
    dict(agg="sum", window=RSpec("time", 4)),
    dict(agg="sum", window=RSpec("tuple", 0)),
    dict(agg="sum", window=RSpec("tuple", 4, capacity=2)),
    dict(agg="sum", window=RSpec("tuple", 2, value_dim=3)),
    dict(agg="sum", readers=[]),
])
def test_query_validation_errors_match(bad):
    def port_kw(kw):
        w = kw.get("window")
        if w is not None:
            kw = dict(kw, window=WindowSpec(w.kind, w.size, w.capacity,
                                            w.value_dim))
        return kw

    with pytest.raises(ValueError) as er:
        RQuery(**bad).resolve()
    with pytest.raises(ValueError) as et:
        Query(**port_kw(bad)).resolve()
    assert str(et.value) == str(er.value)


def test_update_validation():
    s = EagrSession(small_example_graph(), device="cpu")
    with pytest.raises(ValueError, match="no queries"):
        s.update([0], [1.0])
    s.register(Query(agg="sum"))
    with pytest.raises(ValueError, match="negative"):
        s.update([-1], [1.0])
    with pytest.raises(ValueError, match="shape"):
        s.update([0, 1], [1.0])
    with pytest.raises(ValueError, match="value_dim"):
        s.register(Query(agg="sum", agg_kwargs={"value_dim": 2},
                         window=WindowSpec("tuple", 1, value_dim=2)))


def test_no_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EagrSession(small_example_graph())
    with pytest.raises(RuntimeError):
        EagrSession(small_example_graph(), device="cuda")


def _device_entry_points():
    """Every public function that places tensors, each called with no
    ``device`` argument on inputs made on the CPU."""
    s = EagrSession(small_example_graph(), device="cpu")
    eng = s.register(Query(agg="sum")).group.engine
    arrays, objs = TE.plan_snapshot(eng.plan)
    win = {k: v.numpy() for k, v in eng.state.windows._asdict().items()}
    return {
        "compile_plan": lambda: TE.compile_plan(eng.overlay,
                                                eng.plan.decision),
        "plan_from_snapshot": lambda: TE.plan_from_snapshot(arrays, objs),
        "plan_from_reference": lambda: convert.plan_from_reference(arrays,
                                                                   objs),
        "state_from_reference": lambda: convert.state_from_reference(
            win, eng.state.pao.numpy(), 0.0),
        "init_windows": lambda: init_windows(4, WindowSpec("tuple", 2)),
        "init_pao": lambda: eng.agg.init_pao(4),
        "calibrate_cost_model": lambda: TD.calibrate_cost_model(eng.agg),
        "EagrEngine": lambda: TE.EagrEngine(eng.overlay, eng.plan.decision,
                                            eng.agg),
    }


@pytest.mark.parametrize("entry", [
    "compile_plan", "plan_from_snapshot", "plan_from_reference",
    "state_from_reference", "init_windows", "init_pao",
    "calibrate_cost_model", "EagrEngine"])
def test_no_silent_cpu_in_entry_points(entry, monkeypatch):
    call = _device_entry_points()[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


@pytest.mark.parametrize("call", [
    lambda s, h, d, mp: get_arch("graphcast"),
    lambda s, h, d, mp: get_arch("gat-cora"),
    lambda s, h, d, mp: get_arch("nequip"),
    lambda s, h, d, mp: get_arch("gatedgcn"),
])
def test_features_outside_the_slice_raise(call, tmp_path, monkeypatch):
    """The GNN archs of item 13d, which once raised here, now load and
    build their reduced train cell (their parity with the JAX package:
    tests/test_torch_gnn_{common,models,nequip,configs}.py); an id the JAX
    package does not know still raises ``KeyError``. Every other item
    works too: the LM archs serve and train
    (tests/test_torch_{transformer,train_lm}.py), DIEN trains
    (tests/test_torch_train_dien.py), bf16 edge values (item 12) in
    sessions, sharded sessions, snapshots and restores in
    tests/test_torch_bf16.py; shards and checkpoints (items 10 and 9) in
    tests/test_torch_{stacked,checkpoint,fault}.py; churn, flush and
    adaptation (items 5 and 6) against the reference below, ingest and
    alerts (items 7 and 8) in tests/test_torch_ingest.py and
    tests/test_torch_alerts.py."""
    mod = call(None, None, str(tmp_path), monkeypatch)
    assert mod.FAMILY == "gnn"
    cell = mod.build_smoke("full_graph_sm", device="cpu")
    assert {"cfg", "params", "opt_state", "batch", "step", "lr"} <= set(cell)
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


@pytest.fixture
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, which only
    contend with the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("arch_id,shape", [
    ("command-r-plus-104b", "train_4k"), ("arctic-480b", "train_4k"),
    ("dbrx-132b", "train_4k"), ("granite-3-2b", "train_4k"),
    ("dien", "train_batch")])
def test_train_cells_build_and_step(arch_id, shape):
    """The train shapes (item 13c) build their reduced cell on the CPU and
    step it: finite loss and gradient norm, every parameter leaf finite,
    the optimizer's count at 1 (AdamW and Adafactor)."""
    c = get_arch(arch_id).build_smoke(shape, device="cpu")
    params, state, metrics = c["step"](c["params"], c["opt_state"],
                                       c["batch"], c["lr"])
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0
    from repro_torch.train.optimizer import tree_leaves
    assert all(bool(torch.isfinite(p).all()) for p in tree_leaves(params))
    assert int(state.count) == 1


def test_port_loads_no_jax_and_no_repro():
    """A fresh process imports repro_torch, runs a small session (with a
    churn burst, a sparse write and read, and an adaptation), a pipelined
    session (``ingest_depth=2``) with a standing alert, a sharded session
    with churn, a save, a restore and a reshard, the recovery driver, the
    streams and the eagr config, the serve path (LM prefill and decode,
    a MoE arch's prefill and the launcher serving one, DIEN scoring and
    retrieval, the launcher) and the training path (a smoke train step,
    one of each GNN arch, and the training launcher with an injected
    failure, for DIEN and GatedGCN) on the CPU and finds neither JAX nor
    the JAX package in ``sys.modules``."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from repro_torch import EagrSession, Query, WindowSpec
        from repro_torch.graphs.generators import rmat_graph
        import repro_torch.convert
        s = EagrSession(rmat_graph(120, 600, seed=1), device="cpu")
        h = s.register(Query(agg="sum", window=WindowSpec("tuple", 2)))
        m = s.register(Query(agg="max", window=WindowSpec("tuple", 2)))
        s.update(np.asarray(s.writers[:16]), np.ones(16, np.float32))
        s.read(h, s.readers[:8]); s.read(m, s.readers[:8])
        # one churn burst and a sparse write and read after it
        s.add_edge(s.writers[0], s.readers[3])
        s.delete_edge(min(s.neighborhood(s.readers[4])), s.readers[4])
        s.add_node(900, [s.writers[1]], [s.readers[5]])
        rep = s.flush()
        assert rep.patched + rep.relayout + rep.recompiled == 2, rep
        import os
        os.environ["EAGR_SPARSE_WRITE"] = "1"
        s.update(np.asarray(s.writers[:4]), np.ones(4, np.float32))
        s.read(h, s.readers[:4]); s.read(m, s.readers[:4])
        eng = h.group.engine
        assert eng.frontier_log[-1] >= 0 and eng.plan.reader_frontier
        s.adapt()
        # the streaming path: a pipelined session with a standing alert
        from repro_torch.streams import batched_playback, generate_trace
        p = EagrSession(rmat_graph(120, 600, seed=1), device="cpu",
                        ingest_depth=2, ingest_batch=32)
        c = p.register(Query(agg="sum", window=WindowSpec("tuple", 2),
                             continuous=True))
        a = c.on_threshold(above=2.0)
        tr = generate_trace(np.asarray(p.writers), np.asarray(p.readers),
                            400, alpha=1.5, value_domain=4, seed=0)
        for kind, ids, vals in batched_playback(tr, 16):
            if kind == "write":
                p.update(ids, vals)
            else:
                p.read(c, ids)
        p.flush()
        assert p.stats().ingest.batches > 0 and a.fired()
        # shards and checkpoints: a sharded session with churn, a save, a
        # same-layout restore and a reshard, the recovery driver
        import tempfile
        from repro_torch.distributed import SessionRecoveryDriver
        d = tempfile.mkdtemp()
        sh = EagrSession(rmat_graph(120, 600, seed=1), device="cpu",
                         shards=2)
        hs = sh.register(Query(agg="sum", window=WindowSpec("tuple", 2)))
        sh.update(np.asarray(sh.writers[:16]), np.ones(16, np.float32))
        sh.add_edge(sh.writers[0], sh.readers[3])
        sh.flush()
        want = sh.read(hs, sh.readers[:8])
        sh.save(d + "/c", blocking=True)
        back = EagrSession.restore(d + "/c", device="cpu")
        assert (back.read(back.queries[0], sh.readers[:8]) == want).all()
        one = EagrSession.restore(d + "/c", shards=0, device="cpu")
        assert one.read(one.queries[0], sh.readers[:8]).shape == want.shape
        def make():
            x = EagrSession(rmat_graph(120, 600, seed=1), device="cpu")
            x.register(Query(agg="sum"))
            return x
        SessionRecoveryDriver(
            make, lambda i: (np.asarray([i % 7]), np.ones(1, np.float32)),
            d + "/r", ckpt_every=2, device="cpu").run(5, fail_at={3})
        from repro_torch.configs import get_arch
        get_arch("eagr").build_smoke("stream_mixed", device="cpu")
        # the serve path: LM prefill + decode, DIEN scoring, the launcher
        from repro_torch.launch import serve
        from repro_torch.models import transformer as T
        from repro_torch.models.recsys import dien
        c = get_arch("granite-3-2b").build_smoke("prefill_32k", device="cpu")
        logits, cache = T.prefill(c["params"], c["tokens"], c["cfg"])
        c = get_arch("granite-3-2b").build_smoke("decode_32k", device="cpu")
        T.decode_step(c["params"], c["cache"], c["tokens"], c["lengths"],
                      c["cfg"])
        c = get_arch("dien").build_smoke("serve_p99", device="cpu")
        dien.serve(c["params"], c["batch"], c["cfg"])
        c = get_arch("dien").build_smoke("retrieval_cand", device="cpu")
        dien.retrieval_score(c["params"], c["batch"], c["cfg"])
        c = get_arch("arctic-480b").build_smoke("prefill_32k", device="cpu")
        T.prefill(c["params"], c["tokens"], c["cfg"])
        serve.main(["--arch", "internlm2-1.8b", "--requests", "2",
                    "--decode-steps", "1", "--device", "cpu"])
        serve.main(["--arch", "dbrx-132b", "--requests", "2",
                    "--decode-steps", "1", "--device", "cpu"])
        # the training path: a smoke train step and the launcher
        from repro_torch.launch import train
        c = get_arch("dbrx-132b").build_smoke("train_4k", device="cpu")
        c["step"](c["params"], c["opt_state"], c["batch"], c["lr"])
        train.main(["--arch", "dien", "--smoke", "--steps", "4",
                    "--ckpt-every", "2", "--fail-at", "3", "--device", "cpu"])
        # the GNNs: a smoke train step of each arch, the launcher on one
        for a in ("gat-cora", "gatedgcn", "graphcast", "nequip"):
            c = get_arch(a).build_smoke("molecule", device="cpu")
            c["step"](c["params"], c["opt_state"], c["batch"], c["lr"])
        train.main(["--arch", "gatedgcn", "--smoke", "--steps", "4",
                    "--ckpt-every", "2", "--fail-at", "3", "--device", "cpu"])
        # the cell tools: every cell on the meta device, the roofline, a
        # measured smoke cell, the sharding rules, int8 compression
        import torch
        from repro_torch.configs import all_cells
        from repro_torch.distributed import compression, sharding
        from repro_torch.launch import dryrun, mesh, roofline
        from repro_torch.models.common import spec_to_meta
        pm = mesh.make_production_mesh(multi_pod=True)
        recs = [dryrun.run_cell(a, s, pm) for a, s in all_cells()]
        recs.append(dryrun.run_cell("gat-cora", "molecule", pm, measure=True,
                                    smoke=True, device="cpu", repeats=1))
        assert "gat-cora" in roofline.format_table(roofline.analyze(recs))
        specs = get_arch("dien").ARCH.build("serve_p99",
                                            device="meta").arg_axes[0]
        assert spec_to_meta(specs)["item_embed"].is_meta
        assert sharding.explain_sharding(specs, pm).startswith("[")
        g = {"w": torch.ones(3)}
        compression.compress_with_feedback(g, compression.init_error_state(g))
        bad = [k for k in sys.modules if k == "jax" or k.startswith("jax.")
               or k == "repro" or k.startswith("repro.")]
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    # one intra-op thread: small tensors, and other test processes share
    # the cores
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


# ----------------------------------------------------------- churn, adapt
def _port_spec(w):
    return WindowSpec(w.kind, w.size, w.capacity, w.value_dim)


@pytest.mark.parametrize("adapt_every", [0, 5])
def test_churn_and_adapt_match_reference(adapt_every):
    """add_edge / delete_edge / add_node / delete_node journaled into both
    sessions, flushed into the plans: the same FlushReport counters, the
    same churned neighbourhoods, bit-equal plan tables, answers of every
    query against the reference's (exact but for sums), then one adapt()
    with the same flips; ``adapt_every`` triggers it on the same ops."""
    ref = RSession(r_rmat(150, 900, seed=5), backend="xla",
                   adapt_every=adapt_every)
    port = EagrSession(rmat_graph(150, 900, seed=5), device="cpu",
                       adapt_every=adapt_every)
    hs = [(ref.register(RQuery(agg=a, agg_kwargs=kw, window=rs)),
           port.register(Query(agg=a, agg_kwargs=kw, window=_port_spec(rs))),
           a) for a, kw, rs, _ in QUERIES[:4]]
    rng = np.random.default_rng(11)
    writers = np.asarray(port.writers)
    for step in range(8):
        ids = rng.choice(writers, 32)
        vals = rng.integers(0, 8, 32).astype(np.float32)
        ref.update(ids, vals)
        port.update(ids, vals)
        for _ in range(3):
            r = int(rng.choice(port.readers))
            nb = port.neighborhood(r)
            if rng.random() < 0.3 and nb:
                ref.delete_edge(min(nb), r)
                port.delete_edge(min(nb), r)
            else:
                w = int(rng.choice(writers))
                if w != r and w not in nb:
                    ref.add_edge(w, r)
                    port.add_edge(w, r)
        if step == 2:
            ref.add_node(600, {int(writers[0])}, {port.readers[0]})
            port.add_node(600, {int(writers[0])}, {port.readers[0]})
        if step == 5:
            ref.delete_node(600)
            port.delete_node(600)
        assert port.stats().pending_mutations
        fr, ft = ref.flush(), port.flush()
        assert (ft.patched, ft.relayout, ft.recompiled, ft.journal_nodes) \
            == (fr.patched, fr.relayout, fr.recompiled, fr.journal_nodes)
        assert port.readers == ref.readers
        q = rng.choice(np.asarray(port.readers), 16)
        for r in q:
            assert port.neighborhood(r) == ref.neighborhood(r)
        for hr, ht, a in hs:
            want, got = np.asarray(ref.read(hr, q)), port.read(ht, q)
            if a in ("sum", "avg"):
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
            else:
                np.testing.assert_array_equal(got, want)
    for gr, gt in zip(ref._groups.values(), port._groups.values()):
        ar, _ = RE.plan_snapshot(gr.engine.plan)
        at, _ = TE.plan_snapshot(gt.engine.plan)
        for k in ar:
            np.testing.assert_array_equal(np.asarray(ar[k]), at[k],
                                          err_msg=k)
    fl_r, fl_t = ref.adapt(), port.adapt()
    assert fl_t.per_group == fl_r.per_group and fl_t.flips == int(fl_r)
    q = np.asarray(port.readers)[:24]
    for hr, ht, a in hs:
        want, got = np.asarray(ref.read(hr, q)), port.read(ht, q)
        if a in ("sum", "avg"):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_array_equal(got, want)
    st = port.stats()
    assert st.patches_applied > 0 and not st.pending_mutations
    assert st.frontier["steps"] == 4 * 8


def test_reports_and_continuous_pin():
    """FlushReport stays a list of per-group results; an empty journal
    flushes to None; a continuous group keeps churn-added nodes PUSH and
    never adapts."""
    s = EagrSession(rmat_graph(120, 600, seed=2), device="cpu")
    h = s.register(Query(agg="sum", continuous=True))
    rep = s.flush()
    assert list(rep) == [None] and rep.patched == 0
    s.add_node(500, [s.writers[0]], [s.readers[0]])
    (res,) = s.flush()
    assert res.kind in ("patched", "relayout") and "patched=" in repr(rep)
    plan = h.group.engine.plan
    assert (plan.decision == TD.PUSH).all()
    assert s.adapt() == 0 and s.adapt().per_group == (0,)
