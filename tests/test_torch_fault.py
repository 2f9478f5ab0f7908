"""The port's fault tolerance (``repro_torch.distributed.fault``): the
session recovery driver replays a crashed stream bit for bit (single and
sharded), the straggler detector flags the JAX package's steps, and the
checkpoint/restart runner over a dict of tensors ends where an
uninterrupted run ends."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.distributed.fault import StragglerDetector as RStraggler  # noqa: E402
from repro_torch import EagrSession, Query, WindowSpec  # noqa: E402
from repro_torch.distributed import (  # noqa: E402
    CheckpointManager,
    FaultTolerantRunner,
    SessionRecoveryDriver,
    StragglerDetector,
)
from repro_torch.graphs.generators import rmat_graph  # noqa: E402


@pytest.mark.parametrize("shards", [None, 2])
def test_recovery_driver_replay_is_bit_identical(tmp_path, shards):
    g = rmat_graph(400, 2400, seed=7)

    def make_session():
        s = EagrSession(g, shards=shards, device="cpu")
        s.register(Query(agg="sum", window=WindowSpec("tuple", 4)))
        s.register(Query(agg="max", window=WindowSpec("time", 3.0,
                                                      capacity=8)))
        return s

    W = np.asarray(make_session().writers)

    def make_batch(seq):
        rng = np.random.default_rng(1000 + seq)
        return rng.choice(W, 16), rng.normal(size=16).astype(np.float32)

    drv = SessionRecoveryDriver(make_session, make_batch,
                                str(tmp_path / "a"), ckpt_every=8,
                                device="cpu")
    s_fault = drv.run(30, fail_at={5, 13, 27})
    assert drv.report.restarts == 3 and s_fault._seq == 30
    s_clean = SessionRecoveryDriver(make_session, make_batch,
                                    str(tmp_path / "b"), ckpt_every=8,
                                    device="cpu").run(30)
    q = np.asarray(s_clean.readers)[:40]
    for hf, hc in zip(s_fault.queries, s_clean.queries):
        np.testing.assert_array_equal(s_fault.read(hf, q),
                                      s_clean.read(hc, q))


def test_recovery_driver_gives_up_after_max_restarts(tmp_path):
    g = rmat_graph(400, 2400, seed=7)

    def make_session():
        s = EagrSession(g, device="cpu")
        s.register(Query(agg="sum"))
        return s

    def make_batch(seq):
        raise RuntimeError("the stream source is gone")

    drv = SessionRecoveryDriver(make_session, make_batch, str(tmp_path),
                                max_restarts=2, device="cpu")
    with pytest.raises(RuntimeError, match="stream source"):
        drv.run(4)
    assert drv.report.restarts == 3


def test_straggler_detector_matches_reference():
    rng = np.random.default_rng(0)
    times = np.concatenate([0.1 + 0.002 * rng.random(40), [0.5, 0.101],
                            0.1 + 0.002 * rng.random(10), [0.9]])
    det, ref = StragglerDetector(z=4.0), RStraggler(z=4.0)
    flags = [det.observe(i, float(t)) for i, t in enumerate(times)]
    assert flags == [ref.observe(i, float(t)) for i, t in enumerate(times)]
    assert flags[40] and flags[-1] and not flags[41]
    assert [f[0] for f in det.flagged] == [f[0] for f in ref.flagged]


def test_fault_runner_over_tensors_replays_deterministically(tmp_path):
    """Least squares by SGD on a dict of tensors: a run with injected
    failures restores the latest checkpoint and replays, ending at the
    uninterrupted run's weights bit for bit."""
    target = torch.arange(4, dtype=torch.float32)[:, None]

    def make_batch(i):
        g = torch.Generator().manual_seed(i)
        x = torch.randn(16, 4, generator=g)
        return {"x": x, "y": x @ target}

    def step_fn(state, batch):
        err = batch["x"] @ state["w"] - batch["y"]
        grad = 2.0 * batch["x"].T @ err / err.shape[0]
        return {"w": state["w"] - 0.05 * grad,
                "opt": {"count": state["opt"]["count"] + 1}}, \
            {"loss": float((err ** 2).mean())}

    state0 = {"w": torch.zeros(4, 1),
              "opt": {"count": torch.zeros((), dtype=torch.int32)}}
    clean, rep1 = FaultTolerantRunner(
        step_fn, make_batch, CheckpointManager(str(tmp_path / "a")),
        ckpt_every=5).run(state0, 30)
    assert rep1.restarts == 0 and rep1.checkpoints == 6
    faulty, rep2 = FaultTolerantRunner(
        step_fn, make_batch, CheckpointManager(str(tmp_path / "b")),
        ckpt_every=5).run(state0, 30, fail_at={12, 23})
    assert rep2.restarts == 2
    assert torch.equal(clean["w"], faulty["w"])
    assert int(faulty["opt"]["count"]) == 30
    assert rep1.losses[-1] < rep1.losses[0]
    # the runner's checkpoints restore into a template's structure
    back, manifest = CheckpointManager(str(tmp_path / "a")).restore(state0)
    assert manifest["step"] == 30 and torch.equal(back["w"], clean["w"])
    assert back["opt"]["count"].dtype == torch.int32
