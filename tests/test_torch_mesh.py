"""EAGr's shards on a group of ranks (``launch.mesh.make_shard_mesh``, the
mesh half of ``distributed.stacked.StackedShardedEngine``): a 3-rank gloo
group on the CPU, one shard per rank, held bit for bit to the one-card stack
run in the parent on the same inputs, for sum, count, max and min, tuple and
time windows, dense and sparse writes, a slice patch kept in place and the
growth fallback, alerts' fired sets, a sharded ``EagrSession``, a group's
checkpoint restored on one card and a one-card checkpoint restored onto the
group. The group's answers agree with the JAX package's ``shard_map`` path
on 3 forced CPU devices (run in a subprocess: sums within 1e-4, max and min
exactly), and ``compressed_all_reduce`` over the group with the JAX
package's ``compressed_psum`` under ``shard_map``.

One spawn of the group runs every case (each rank writes its results to a
file) while the parent runs the same cases without a group; the tests below
read both. Every collective has a timeout and the spawn a join deadline, so
a hung rank fails the tests instead of stalling the suite."""
import contextlib
import os
import pickle
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import EagrSession, Query, WindowSpec  # noqa: E402
from repro_torch.core import dataflow as TD  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core.aggregates import make_aggregate  # noqa: E402
from repro_torch.core.bipartite import build_bipartite  # noqa: E402
from repro_torch.core.dynamic import DynamicOverlay  # noqa: E402
from repro_torch.core.vnm import construct_vnm  # noqa: E402
from repro_torch.distributed import eagr_shard as TS  # noqa: E402
from repro_torch.distributed.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.distributed.compression import compressed_all_reduce  # noqa: E402
from repro_torch.distributed.stacked import StackedShardedEngine  # noqa: E402
from repro_torch.graphs.generators import rmat_graph  # noqa: E402
from repro_torch.launch import mesh as PM  # noqa: E402
from repro_torch.streams.alerts import AlertSet, AlertSpec  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
N_SHARDS = 3
AGGS = ("sum", "count", "max", "min")
KINDS = ("tuple", "time")
COMPRESS_N = 300
COLLECTIVE_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 240.0


# ------------------------------------------------------------- the cases
def _world():
    """tests/test_torch_stacked.py's 400-node world: its bipartite graph
    and the unpruned overlay basis."""
    bp = build_bipartite(rmat_graph(400, 2400, seed=5))
    ov, _ = construct_vnm(bp, variant="vnm_a", max_iterations=3, seed=0)
    basis = DynamicOverlay.from_overlay(
        ov, bp.reader_input_sets()).to_overlay(prune=False)
    return bp, basis


def _decisions(basis, all_push=False):
    if all_push:
        return np.full(basis.n_nodes, TD.PUSH, np.int64)
    wf = np.ones(max(o for o in basis.origin if o >= 0) + 1)
    return TD.decide_mincut(basis, wf, wf.copy(),
                            TD.cost_model_for("sum", window=4), window=4)[0]


def _spec(kind):
    return WindowSpec("tuple", 4) if kind == "tuple" \
        else WindowSpec("time", 3.0, capacity=8)


def _engine(world, agg, kind, all_push=False, headroom=2.0):
    """The stack of N_SHARDS shards: one shard per rank inside the group,
    all on one device outside it."""
    sh = TS.partition_overlay(world[1], _decisions(world[1], all_push),
                              N_SHARDS, seed=1, device="cpu",
                              headroom=headroom)
    return sh, StackedShardedEngine(sh, make_aggregate(agg), _spec(kind),
                                    device="cpu", base_capacity=500)


def _batches(bp, n_batches, B=64, seed=10, integral=False):
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        ids = rng.choice(bp.writers, B)
        vals = rng.integers(-4, 5, B).astype(np.float32) if integral \
            else rng.standard_normal(B).astype(np.float32)
        yield ids, vals


def _state(eng):
    st = eng.global_state_host()
    return [np.asarray(x).copy() for x in (*st.windows, st.pao, st.now)]


def _ptrs(eng):
    out = {k: v.data_ptr() for k, v in TE._plan_array_leaves(eng.arrays)}
    out["wmap"] = eng.writer_map.data_ptr()
    out["rmap"] = eng.reader_map.data_ptr()
    return out


def _plans(sh):
    """Every shard's plan tables as this process holds them."""
    return [TE.plan_snapshot(p)[0] for p in sh.shard_plans]


def _churn(sd, bp, rng, readers):
    for _ in range(4):
        sd.add_edge(int(rng.choice(bp.writers)), int(rng.choice(readers)))
    v = int(rng.choice(readers))
    sd.delete_edge(min(bp.reader_input_sets()[v]), v)


@contextlib.contextmanager
def _sparse(mode):
    old = os.environ.get("EAGR_SPARSE_WRITE")
    if mode is None:
        os.environ.pop("EAGR_SPARSE_WRITE", None)
    else:
        os.environ["EAGR_SPARSE_WRITE"] = mode
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("EAGR_SPARSE_WRITE", None)
        else:
            os.environ["EAGR_SPARSE_WRITE"] = old


def _session_ops(s):
    """EagrSession(shards=3)'s stream of tests/test_torch_stacked.py: three
    groups, six write batches with a churn burst flushed after the third,
    one read of each query."""
    hs = [s.register(Query(agg=a, window=w)) for a, w in (
        ("sum", WindowSpec("tuple", 4)), ("max", WindowSpec("tuple", 4)),
        ("count", WindowSpec("time", 3.0, capacity=8)))]
    rng = np.random.default_rng(0)
    W, R = np.asarray(s.writers), np.asarray(s.readers)
    kinds = None
    for step in range(6):
        s.update(rng.choice(W, 64), rng.integers(-3, 6, 64).astype(np.float32))
        if step == 2:
            s.add_edge(int(W[0]), int(R[5]))
            s.delete_edge(min(s.neighborhood(int(R[7]))), int(R[7]))
            rep = s.flush()
            kinds = (rep.patched, rep.relayout, rep.recompiled)
    q = rng.choice(R, 48)
    return hs, q, kinds


def _cases(world, work: str, tag: str, sparse_mode: str) -> dict:
    """Every case on this process's engines: inside the group each rank
    holds one shard, outside it one device holds all three. ``tag`` names
    this side's checkpoint directory."""
    bp = world[0]
    out = {}
    with _sparse(None):
        for agg in AGGS:
            for kind in KINDS:
                sh, eng = _engine(world, agg, kind)
                for ids, vals in _batches(bp, 5,
                                          integral=agg in ("max", "min")):
                    eng.write_batch(ids, vals, batch_size=64)
                q = np.random.default_rng(3).choice(sorted(sh.reader_shard),
                                                    40)
                out[("engine", agg, kind)] = dict(
                    state=_state(eng), read=eng.read_batch(q, batch_size=40),
                    local=list(eng.local))
    # sparse on the group against dense on one card (sparse == dense)
    with _sparse(sparse_mode):
        for agg in ("sum", "max"):
            sh, eng = _engine(world, agg, "tuple", all_push=True)
            went = []
            for ids, vals in _batches(bp, 4, B=16):
                went.append(eng._frontier_active(ids) is not None)
                eng.write_batch(ids, vals, batch_size=16)
            q = np.random.default_rng(5).choice(sorted(sh.reader_shard), 40)
            out[("sparse", agg)] = dict(state=_state(eng), sparse=all(went),
                                        read=eng.read_batch(q, 40))
    with _sparse(None):
        # in-capacity churn: slices patched in place, every rank's host
        # copy of every shard's plan equal to the owner's
        sh, eng = _engine(world, "sum", "tuple", headroom=4.0)
        sd = TS.ShardedDynamic(sh, eng)
        ptrs = _ptrs(eng)
        readers = sorted(sh.reader_shard)
        batches = _batches(bp, 9)
        recompiled = False
        for burst in range(3):
            ids, vals = next(batches)
            eng.write_batch(ids, vals, batch_size=64)
            _churn(sd, bp, np.random.default_rng(burst), readers)
            res = sd.apply()
            recompiled |= any(r is not None and r.recompiled for r in res)
        views = all(sh.shard_plans[s].arrays.push.seg.data_ptr()
                    == eng.arrays.push.seg[i].data_ptr()
                    for i, s in enumerate(eng.local))
        in_place = _ptrs(eng) == ptrs and views
        for ids, vals in [next(batches) for _ in range(3)]:
            eng.write_batch(ids, vals, batch_size=64)
        q = np.random.default_rng(9).choice(sorted(sh.reader_shard), 40)
        out["patch"] = dict(state=_state(eng), read=eng.read_batch(q, 40),
                            in_place=in_place, recompiled=recompiled,
                            plans=_plans(sh))
        # the growth fallback: a burst of new writers past the padding
        sh, eng = _engine(world, "max", "tuple", headroom=1.0)
        shape0 = TE.plan_dims(sh.shard_plans[0])
        sd = TS.ShardedDynamic(sh, eng)
        for ids, vals in _batches(bp, 2, integral=True):
            eng.write_batch(ids, vals, batch_size=64)
        readers = sorted(sh.reader_shard)
        rng = np.random.default_rng(2)
        new = int(max(bp.writers)) + 1
        for k in range(40):
            sd.add_node(new + k, set(), {int(rng.choice(readers))})
        res = sd.apply()
        ids = np.concatenate([np.arange(new, new + 40), bp.writers[:24]])
        eng.write_batch(ids, np.arange(64, dtype=np.float32), batch_size=64)
        out["growth"] = dict(
            recompiled=any(r is not None and r.recompiled for r in res),
            grew=TE.plan_dims(sh.shard_plans[0]) != shape0,
            state=_state(eng),
            read=eng.read_batch(np.asarray(readers[:40]), batch_size=40),
            plans=_plans(sh))
        # alerts: a cap of 8, so a shard that fires more takes the dense
        # recovery
        sh, eng = _engine(world, "sum", "tuple", all_push=True)
        at = AlertSet(cap=8)
        at.register(0, AlertSpec(above=1.5, hysteresis=0.5),
                    sorted(sh.reader_shard)[::2], dynamic=False)
        eng.attach_alerts(at)
        fired = []
        for ids, vals in _batches(bp, 8, integral=True):
            eng.write_batch(ids, vals, batch_size=64)
            at.collect()
            fired += [(b.now, b.base_ids, b.values, b.aids, b.overflow)
                      for b in at.pop_fired()]
        out["alerts"] = dict(fired=fired, per_base=at.per_base())
        # a sharded session, saved
        s = EagrSession(rmat_graph(400, 2400, seed=8), shards=N_SHARDS,
                        device="cpu")
        hs, q, kinds = _session_ops(s)
        out["session"] = dict(
            reads=[s.read(h, q) for h in hs], kinds=kinds,
            ranks=[h.group.engine.mesh is not None for h in hs])
        s.save(os.path.join(work, f"save_{tag}"), blocking=True)
        # the parent's one-card checkpoint restored here, then driven on
        r = EagrSession.restore(os.path.join(work, "one_card"), device="cpu")
        reads = [r.read(h, q) for h in r.queries]
        rng = np.random.default_rng(11)
        W = np.asarray(r.writers)
        for _ in range(3):
            r.update(rng.choice(W, 64),
                     rng.integers(-3, 6, 64).astype(np.float32))
        out["restore"] = dict(
            first=reads, after=[r.read(h, q) for h in r.queries],
            ranks=[h.group.engine.mesh is not None for h in r.queries])
    return out


# ------------------------------------------------------------ the group
def _rank(rank, store, work):
    """One rank of the group: every case on its own shard, the results to
    ``rank{rank}.pkl``."""
    torch.set_num_threads(1)
    PM.init_group(rank, N_SHARDS, store, backend="gloo",
                  timeout_s=COLLECTIVE_TIMEOUT_S)
    import torch.distributed as dist

    try:
        out = _cases(_world(), work, "group", sparse_mode="1")
        x = np.random.default_rng(21).standard_normal(
            (N_SHARDS, COMPRESS_N)).astype(np.float32) * (1.0 + np.arange(
                N_SHARDS, dtype=np.float32)[:, None])
        out["compressed"] = compressed_all_reduce(
            torch.from_numpy(x[rank].copy())).numpy()
        mesh = PM.make_shard_mesh(N_SHARDS, device="cpu")
        out["mesh"] = (mesh.rank, mesh.world, str(mesh.device),
                       str(mesh.comm), mesh.backend)
        out["fewer"] = PM.make_shard_mesh(N_SHARDS + 1, device="cpu") is None
        with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


_JAX = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.core import dataflow as RD
    from repro.core.aggregates import make_aggregate
    from repro.core.bipartite import build_bipartite
    from repro.core.dynamic import DynamicOverlay
    from repro.core.vnm import construct_vnm
    from repro.core.window import WindowSpec
    from repro.distributed import compression as JC
    from repro.distributed import eagr_shard as RS
    from repro.distributed.stacked import StackedShardedEngine
    from repro.graphs.generators import rmat_graph
    S, N = int(sys.argv[2]), int(sys.argv[3])
    assert len(jax.devices()) == S
    bp = build_bipartite(rmat_graph(400, 2400, seed=5))
    ov, _ = construct_vnm(bp, variant="vnm_a", max_iterations=3, seed=0)
    basis = DynamicOverlay.from_overlay(
        ov, bp.reader_input_sets()).to_overlay(prune=False)
    wf = np.ones(max(o for o in basis.origin if o >= 0) + 1)
    dec = RD.decide_mincut(basis, wf, wf.copy(),
                           RD.cost_model_for("sum", window=4), window=4)[0]
    out = {}
    for agg in ("sum", "max", "min"):
        sh = RS.partition_overlay(basis, dec, S, seed=1, backend="xla",
                                  headroom=2.0)
        eng = StackedShardedEngine(sh, make_aggregate(agg),
                                   WindowSpec("tuple", 4), mesh="auto",
                                   base_capacity=500)
        assert eng.mesh is not None, "no shard_map mesh"
        rng = np.random.default_rng(10)
        for _ in range(5):
            ids = rng.choice(bp.writers, 64)
            vals = (rng.integers(-4, 5, 64).astype(np.float32)
                    if agg != "sum" else
                    rng.standard_normal(64).astype(np.float32))
            eng.write_batch(ids, vals, batch_size=64)
        q = np.random.default_rng(3).choice(sorted(sh.reader_shard), 40)
        out[agg] = np.asarray(eng.read_batch(q, batch_size=40))
    x = np.random.default_rng(21).standard_normal((S, N)).astype(
        np.float32) * (1.0 + np.arange(S, dtype=np.float32)[:, None])
    mesh = Mesh(np.asarray(jax.devices()), ("x",))
    got = jax.shard_map(lambda v: JC.compressed_psum(v, "x"), mesh=mesh,
                        in_specs=P("x"), out_specs=P("x"))(
        jnp.asarray(x.reshape(-1)))
    out["compressed"] = np.asarray(got)[:N]
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The group's results by rank, the one-card results, the JAX
    package's shard_map answers, and the working directory."""
    work = str(tmp_path_factory.mktemp("mesh"))
    world = _world()
    # the one-card checkpoint the group restores
    s = EagrSession(rmat_graph(400, 2400, seed=8), shards=N_SHARDS,
                    device="cpu")
    _session_ops(s)
    s.save(os.path.join(work, "one_card"), blocking=True)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count="
                         f"{N_SHARDS}")
    jax_out = os.path.join(work, "jax.npz")
    ref = subprocess.Popen([sys.executable, "-c", _JAX, jax_out,
                            str(N_SHARDS), str(COMPRESS_N)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    errors = []

    def group():
        try:
            PM.spawn_group(_rank, N_SHARDS,
                           args=(os.path.join(work, "store"), work),
                           join_timeout_s=JOIN_TIMEOUT_S)
        except BaseException as e:  # re-raised in the parent below
            errors.append(e)

    t = threading.Thread(target=group)
    t.start()
    try:
        one = _cases(world, work, "one", sparse_mode="0")
    finally:
        t.join()
        log, _ = ref.communicate(timeout=JOIN_TIMEOUT_S)
    if errors:
        raise errors[0]
    assert ref.returncode == 0, log
    ranks = []
    for r in range(N_SHARDS):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return dict(ranks=ranks, one=one, jax=dict(np.load(jax_out)), work=work)


def _equal_lists(a, b, what):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f"{what}[{i}]")


def _equal_plans(a, b, what):
    for s, (pa, pb) in enumerate(zip(a, b)):
        assert pa.keys() == pb.keys(), what
        for k in pa:
            np.testing.assert_array_equal(np.asarray(pa[k]),
                                          np.asarray(pb[k]),
                                          err_msg=f"{what} shard {s} {k}")


# ------------------------------------------------------------- the tests
def test_make_shard_mesh_none_without_group_or_with_fewer_ranks(runs):
    assert PM.make_shard_mesh(N_SHARDS) is None          # no group here
    for r, out in enumerate(runs["ranks"]):
        assert out["mesh"] == (r, N_SHARDS, "cpu", "cpu", "gloo")
        assert out["fewer"]


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("kind", KINDS)
def test_group_bit_equal_to_one_card_stack(runs, agg, kind):
    want = runs["one"][("engine", agg, kind)]
    assert want["local"] == list(range(N_SHARDS))
    for r, out in enumerate(runs["ranks"]):
        got = out[("engine", agg, kind)]
        assert got["local"] == [r]
        _equal_lists(got["state"], want["state"], f"rank {r} state")
        np.testing.assert_array_equal(got["read"], want["read"])


@pytest.mark.parametrize("agg", ["sum", "max"])
def test_group_sparse_bit_equal_to_one_card_dense(runs, agg):
    want = runs["one"][("sparse", agg)]
    assert not want["sparse"]
    for r, out in enumerate(runs["ranks"]):
        got = out[("sparse", agg)]
        assert got["sparse"], f"rank {r} never went sparse"
        _equal_lists(got["state"], want["state"], f"rank {r} state")
        np.testing.assert_array_equal(got["read"], want["read"])


def test_group_slice_patch_in_place(runs):
    want = runs["one"]["patch"]
    assert want["in_place"] and not want["recompiled"]
    for r, out in enumerate(runs["ranks"]):
        got = out["patch"]
        assert got["in_place"] and not got["recompiled"], f"rank {r}"
        _equal_lists(got["state"], want["state"], f"rank {r} state")
        np.testing.assert_array_equal(got["read"], want["read"])
        # every rank replayed every shard's patch on its own copy
        _equal_plans(got["plans"], want["plans"], f"rank {r}")


def test_group_growth_fallback(runs):
    want = runs["one"]["growth"]
    assert want["recompiled"] and want["grew"]
    for r, out in enumerate(runs["ranks"]):
        got = out["growth"]
        assert got["recompiled"] and got["grew"], f"rank {r}"
        _equal_lists(got["state"], want["state"], f"rank {r} state")
        np.testing.assert_array_equal(got["read"], want["read"])
        _equal_plans(got["plans"], want["plans"], f"rank {r}")


def test_group_alerts_fire_the_one_card_sets(runs):
    want = runs["one"]["alerts"]
    assert sum(len(f[1]) for f in want["fired"]) > 0
    assert any(f[4] for f in want["fired"])      # the dense recovery ran
    for r, out in enumerate(runs["ranks"]):
        got = out["alerts"]
        assert len(got["fired"]) == len(want["fired"]), f"rank {r}"
        for a, b in zip(got["fired"], want["fired"]):
            assert a[0] == b[0] and a[4] == b[4]
            for x, y in zip(a[1:4], b[1:4]):
                np.testing.assert_array_equal(x, y)
        assert got["per_base"].keys() == want["per_base"].keys()
        for k in want["per_base"]:
            np.testing.assert_array_equal(got["per_base"][k],
                                          want["per_base"][k], err_msg=k)


def test_group_session_bit_equal_to_one_card(runs):
    want = runs["one"]["session"]
    assert want["ranks"] == [False] * 3
    for r, out in enumerate(runs["ranks"]):
        got = out["session"]
        assert got["ranks"] == [True] * 3, f"rank {r}"
        assert got["kinds"] == want["kinds"]
        _equal_lists(got["reads"], want["reads"], f"rank {r} reads")


def test_group_checkpoint_equals_one_card_and_restores_on_one_card(runs):
    """The group's save (rank 0 writes after one gather) holds the same
    arrays and objects as the one-card session's, and restores on one card
    to the same answers."""
    work = runs["work"]
    ga, go, gs = CheckpointManager(
        os.path.join(work, "save_group")).restore_payload()
    oa, oo, os_ = CheckpointManager(
        os.path.join(work, "save_one")).restore_payload()
    # the construction's wall times aside, every object is the same
    strip = lambda o: {k: v for k, v in o.items() if k != "construction"}
    assert gs == os_ and strip(go) == strip(oo)
    assert ga.keys() == oa.keys()
    for k in oa:
        np.testing.assert_array_equal(ga[k], oa[k], err_msg=k)
    back = EagrSession.restore(os.path.join(work, "save_group"),
                               device="cpu")
    s = EagrSession(rmat_graph(400, 2400, seed=8), shards=N_SHARDS,
                    device="cpu")
    _, q, _ = _session_ops(s)
    _equal_lists([back.read(h, q) for h in back.queries],
                 runs["one"]["session"]["reads"], "restored reads")


def test_one_card_checkpoint_restores_onto_group(runs):
    want = runs["one"]["restore"]
    assert want["ranks"] == [False] * 3
    for r, out in enumerate(runs["ranks"]):
        got = out["restore"]
        assert got["ranks"] == [True] * 3, f"rank {r}"
        _equal_lists(got["first"], want["first"], f"rank {r} first read")
        _equal_lists(got["after"], want["after"], f"rank {r} after writes")


@pytest.mark.parametrize("agg", ["sum", "max", "min"])
def test_group_answers_equal_jax_shard_map(runs, agg):
    want = runs["jax"][agg]
    for out in runs["ranks"]:
        got = out[("engine", agg, "tuple")]["read"]
        if agg == "sum":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_array_equal(got, want)


def test_compressed_all_reduce_on_group_equals_jax_psum(runs):
    want = runs["jax"]["compressed"]
    for out in runs["ranks"]:
        np.testing.assert_array_equal(out["compressed"], want)


def test_shard_journals_build_on_first_use():
    """A burst on one shard builds that shard's journal only, and lands the
    same plans and state as journals all built up front."""
    world = _world()
    outs = []
    for eager in (False, True):
        sh, eng = _engine(world, "sum", "tuple", headroom=4.0)
        sd = TS.ShardedDynamic(sh, eng)
        assert sd.dynamics.built() == []
        if eager:
            list(sd.dynamics)
        for ids, vals in _batches(world[0], 2):
            eng.write_batch(ids, vals, batch_size=64)
        r = next(b for b, s in sorted(sh.reader_shard.items()) if s == 1)
        sd.add_edge(int(world[0].writers[0]), int(r))
        assert [s for s, _ in sd.dynamics.built()] == \
            ([0, 1, 2] if eager else [1])
        res = sd.apply()
        assert [x is not None for x in res] == [False, True, False]
        outs.append((_state(eng), _plans(sh)))
    _equal_lists(outs[0][0], outs[1][0], "state")
    _equal_plans(outs[0][1], outs[1][1], "lazy against eager")
