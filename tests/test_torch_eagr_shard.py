"""The port's reader partitioning (``repro_torch.distributed.eagr_shard``)
against the JAX package's (``backend="xla"`` on the CPU): the same shard
closures, projected decisions, aligned plan tables and owner maps, array
for array, and the same per-shard plans after churn routed through
``ShardedDynamic``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import dataflow as RD  # noqa: E402
from repro.core import engine as RE  # noqa: E402
from repro.core.bipartite import build_bipartite as r_bip  # noqa: E402
from repro.core.dynamic import DynamicOverlay as RDyn  # noqa: E402
from repro.core.vnm import construct_vnm as r_vnm  # noqa: E402
from repro.distributed import eagr_shard as RS  # noqa: E402
from repro.graphs.generators import rmat_graph as r_rmat  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core.bipartite import build_bipartite as t_bip  # noqa: E402
from repro_torch.core.dynamic import DynamicOverlay as TDyn  # noqa: E402
from repro_torch.core.vnm import construct_vnm as t_vnm  # noqa: E402
from repro_torch.distributed import eagr_shard as TS  # noqa: E402
from repro_torch.graphs.generators import rmat_graph as t_rmat  # noqa: E402


def _world(n=400, e=2400, seed=5):
    """Both packages' unpruned basis overlays of one RMAT graph, with the
    min-cut decisions (numpy, shared) and the reader neighbourhoods."""
    out = []
    for rmat, bip, vnm, dyn in ((r_rmat, r_bip, r_vnm, RDyn),
                                (t_rmat, t_bip, t_vnm, TDyn)):
        bp = bip(rmat(n, e, seed=seed))
        ov, _ = vnm(bp, variant="vnm_a", max_iterations=3, seed=0)
        out.append((bp, dyn.from_overlay(ov, bp.reader_input_sets())
                    .to_overlay(prune=False)))
    (bpr, br), (bpt, bt) = out
    wf = np.ones(max(o for o in br.origin if o >= 0) + 1)
    dec, _ = RD.decide_mincut(br, wf, wf.copy(),
                              RD.cost_model_for("sum", window=4), window=4)
    return bpr, br, bpt, bt, dec


@pytest.fixture(scope="module")
def world():
    return _world()


def _assert_overlays_equal(a, b):
    assert a.kinds == b.kinds
    assert list(a.origin) == list(b.origin)
    assert [list(map(tuple, e)) for e in a.in_edges] == \
        [list(map(tuple, e)) for e in b.in_edges]


def _assert_plans_equal(pr, pt):
    ar, orr = RE.plan_snapshot(pr)
    at, ot = TE.plan_snapshot(pt)
    assert ar.keys() == at.keys()
    for k in ar:
        a, b = np.asarray(ar[k]), np.asarray(at[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert orr == ot


@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_partition_equals_reference(world, n_shards):
    _, br, _, bt, dec = world
    sr = RS.partition_overlay(br, dec, n_shards, seed=1, backend="xla",
                              headroom=2.0)
    st = TS.partition_overlay(bt, dec, n_shards, seed=1, device="cpu",
                              headroom=2.0)
    assert st.n_shards == sr.n_shards == n_shards
    assert st.reader_shard == sr.reader_shard
    assert st.writer_rows == sr.writer_rows
    assert st.replication_factor() == sr.replication_factor()
    for s in range(n_shards):
        _assert_overlays_equal(sr.shards[s], st.shards[s])
        np.testing.assert_array_equal(sr.shard_decisions[s],
                                      st.shard_decisions[s])
        _assert_plans_equal(sr.shard_plans[s], st.shard_plans[s])
    # aligned: one padded shape, the metas equal up to the real depth
    assert len({TE.plan_dims(p) for p in st.shard_plans}) == 1


def test_project_decisions_equals_reference(world):
    _, br, _, bt, dec = world
    sr = RS.partition_overlay(br, dec, 3, seed=4, backend="xla")
    st = TS.partition_overlay(bt, dec, 3, seed=4, device="cpu")
    for s in range(3):
        np.testing.assert_array_equal(
            RS._project_decisions(br, dec, sr.shards[s]),
            TS._project_decisions(bt, dec, st.shards[s]))


def test_sharded_dynamic_churn_equals_reference(world):
    """Churn routed by ShardedDynamic (no engines: plans patched directly)
    leaves the same per-shard plans in both packages, realigned to one
    shape."""
    bpr, br, bpt, bt, dec = world
    sr = RS.partition_overlay(br, dec, 3, seed=2, backend="xla",
                              headroom=2.0)
    st = TS.partition_overlay(bt, dec, 3, seed=2, device="cpu",
                              headroom=2.0)
    dr, dt = RS.ShardedDynamic(sr), TS.ShardedDynamic(st)
    readers = sorted(sr.reader_shard)
    writers = sorted(bpr.writers)
    rng = np.random.default_rng(0)
    for _ in range(3):
        ops = [(int(rng.choice(writers)), int(rng.choice(readers)))
               for _ in range(6)]
        for u, v in ops:
            for d in (dr, dt):
                d.add_edge(u, v)
        v = int(rng.choice(readers))
        u = min(bpr.reader_input_sets()[v])
        for d in (dr, dt):
            d.delete_edge(u, v)
        res_r, res_t = dr.apply(), dt.apply()
        assert [r is None for r in res_r] == [r is None for r in res_t]
        for s in range(3):
            _assert_plans_equal(sr.shard_plans[s], st.shard_plans[s])
        assert st.writer_rows == sr.writer_rows
    assert len({TE.plan_dims(p) for p in st.shard_plans}) == 1


def test_shard_batches_route_like_reference(world):
    _, br, _, bt, dec = world
    sr = RS.partition_overlay(br, dec, 4, seed=3, backend="xla")
    st = TS.partition_overlay(bt, dec, 4, seed=3, device="cpu")
    rng = np.random.default_rng(7)
    ids = rng.integers(-2, 450, 64)
    vals = rng.standard_normal(64).astype(np.float32)
    for (a, b, c), (x, y, z) in zip(RS.shard_write_batch(sr, ids, vals),
                                    TS.shard_write_batch(st, ids, vals)):
        np.testing.assert_array_equal(a, x)
        np.testing.assert_array_equal(b, y)
        np.testing.assert_array_equal(c, z)
    readers = rng.choice(sorted(sr.reader_shard), 32)
    for (a, b), (x, y) in zip(RS.shard_read_batch(sr, readers),
                              TS.shard_read_batch(st, readers)):
        np.testing.assert_array_equal(a, x)
        np.testing.assert_array_equal(b, y)
    bad = max(sr.reader_shard) + 1000
    with pytest.raises(ValueError, match="owned by no shard"):
        TS.shard_read_batch(st, np.array([readers[0], bad]))
    with pytest.raises(ValueError, match="owned by no shard"):
        TS.ShardedDynamic(st).add_edge(int(readers[0]), bad)
