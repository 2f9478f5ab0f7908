"""The port's ``configs/eagr.py`` (the paper's reference deployment) against
the JAX package's: ``build_engine(SMOKE_CFG)`` gives bit-equal plan tables,
routing maps and decisions, the same construction and decision statistics,
and ``get_arch("eagr")`` serves the config."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import eagr as R  # noqa: E402
from repro.core import engine as RE  # noqa: E402
from repro_torch.configs import eagr as T  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402


def test_configs_equal():
    assert dataclasses.asdict(T.CFG) == dataclasses.asdict(R.CFG)
    assert dataclasses.asdict(T.SMOKE_CFG) == dataclasses.asdict(R.SMOKE_CFG)
    assert T.CFG.algorithm == "vnm_n" and get_arch("eagr") is T


def test_build_engine_smoke_plan_bit_equal():
    """``SMOKE_CFG``: vnm_n overlay (4 iterations), min-cut under Zipf
    frequencies, split_nodes — the same plan tables in both packages."""
    er, bpr, (sr, dr) = R.build_engine(R.SMOKE_CFG)
    et, bpt, (st, dt) = T.build_engine(T.SMOKE_CFG, device="cpu")
    np.testing.assert_array_equal(bpr.writers, bpt.writers)
    assert et.overlay.n_nodes == er.overlay.n_nodes
    ar, orr = RE.plan_snapshot(er.plan)
    at, ot = TE.plan_snapshot(et.plan)
    assert set(ar) == set(at)
    for k in ar:
        np.testing.assert_array_equal(np.asarray(ar[k]), at[k], err_msg=k)
    assert ot["depth"] == orr["depth"]
    for f in ("algorithm", "iterations", "bicliques", "si_per_iteration"):
        assert getattr(st, f) == getattr(sr, f), f
    assert vars(dt) == vars(dr)


def test_build_smoke_runs_on_cpu():
    c = get_arch("eagr").build_smoke("stream_mixed", device="cpu")
    eng = c["engine"]
    eng.write_batch(c["ids"], c["vals"])
    ans = eng.read_batch(c["readers"])
    assert ans.shape[0] == T.SMOKE_CFG.read_batch and np.isfinite(ans).all()
    with pytest.raises(KeyError):
        T.build_smoke("train")
