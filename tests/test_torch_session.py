"""The port's ``EagrSession`` against the JAX package's (``backend="xla"``
on the CPU): the same readers, writers and neighbourhoods, the same answers
for several simultaneous queries on one write stream, Figure 1(b) of the
paper exactly, the same register-time validation errors; plus the port's own
rules — no JAX and no ``repro`` module in a process that runs a session, no
silent fall back to the CPU, and the features this slice leaves out raising
``NotImplementedError``."""
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
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core.window import init_windows  # noqa: E402
from repro_torch.graphs.generators import rmat_graph, small_example_graph  # noqa: E402

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
    lambda s, h: s.add_edge(0, 1), lambda s, h: s.delete_edge(0, 1),
    lambda s, h: s.add_node(9), lambda s, h: s.delete_node(0),
    lambda s, h: s.flush(), lambda s, h: s.adapt(),
    lambda s, h: s.register_alert(h), lambda s, h: h.on_threshold(above=1),
    lambda s, h: s.save("x"), lambda s, h: EagrSession.restore("x"),
    lambda s, h: EagrSession(small_example_graph(), device="cpu", shards=2),
    lambda s, h: EagrSession(small_example_graph(), device="cpu",
                             adapt_every=4),
    lambda s, h: EagrSession(small_example_graph(), device="cpu",
                             ingest_depth=2),
    lambda s, h: EagrSession(small_example_graph(), device="cpu",
                             ckpt_dir="x"),
])
def test_features_outside_the_slice_raise(call):
    s = EagrSession(small_example_graph(), device="cpu")
    h = s.register(Query(agg="sum"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        call(s, h)


def test_port_loads_no_jax_and_no_repro():
    """A fresh process imports repro_torch, runs a small session on the CPU
    and finds neither JAX nor the JAX package in ``sys.modules``."""
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
        bad = [k for k in sys.modules if k == "jax" or k.startswith("jax.")
               or k == "repro" or k.startswith("repro.")]
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout
