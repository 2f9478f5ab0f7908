"""The port's windows and aggregates against the JAX package's: the
closed-form batch append against the event-at-a-time scan oracle
(``apply_writes_scan``) with duplicate writers, window evaluation, and every
built-in aggregate's lift/finalize/merge and constructor errors. Inputs are
made with numpy from a seed and handed to both sides."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import aggregates as RA  # noqa: E402
from repro.core import window as RW  # noqa: E402
from repro_torch.core import aggregates as TA  # noqa: E402
from repro_torch.core import window as TW  # noqa: E402

AGGS = [("sum", {}), ("count", {}), ("avg", {}), ("max", {}), ("min", {}),
        ("topk", {"k": 3, "domain": 8}), ("sum", {"value_dim": 3}),
        ("max", {"value_dim": 3})]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _to_torch(state):
    return TW.WindowState(*(torch.as_tensor(np.array(x)) for x in state))


def _assert_state_equal(ref, port):
    for f, a, b in zip(RW.WindowState._fields, ref, port):
        np.testing.assert_array_equal(np.asarray(a), _np(b), err_msg=f)


def _stream(rng, n_rows, B, value_dim):
    rows = rng.integers(0, n_rows, B).astype(np.int32)
    vals = rng.normal(size=(B,) if value_dim == 1 else (B, value_dim))
    stamps = np.sort(rng.uniform(0, 10, B)).astype(np.float32)
    mask = rng.random(B) < 0.8
    return rows, vals.astype(np.float32), stamps, mask


@pytest.mark.parametrize("cap", [1, 2, 5])
@pytest.mark.parametrize("value_dim", [1, 3])
@pytest.mark.parametrize("kind", ["tuple", "time"])
def test_apply_writes_matches_scan_oracle(cap, value_dim, kind):
    """Duplicate writers in one batch follow event-at-a-time semantics:
    the port's closed form equals the reference's scan, bit for bit."""
    rng = np.random.default_rng(cap * 10 + value_dim)
    spec_r = RW.WindowSpec(kind, cap if kind == "tuple" else 3.0,
                           capacity=cap, value_dim=value_dim)
    spec_t = TW.WindowSpec(kind, cap if kind == "tuple" else 3.0,
                           capacity=cap, value_dim=value_dim)
    ref = RW.init_windows(6, spec_r)
    port = TW.init_windows(6, spec_t, device="cpu")
    _assert_state_equal(ref, port)
    for _ in range(3):
        rows, vals, stamps, mask = _stream(rng, 6, 40, value_dim)
        ref, ev_r, evv_r = RW.apply_writes_scan(
            ref, spec_r, jnp.asarray(rows), jnp.asarray(vals),
            jnp.asarray(stamps), jnp.asarray(mask))
        port, ev_t, evv_t = TW.apply_writes(
            port, spec_t, torch.as_tensor(rows), torch.as_tensor(vals),
            torch.as_tensor(stamps), torch.as_tensor(mask))
        _assert_state_equal(ref, port)
        np.testing.assert_array_equal(np.asarray(evv_r), _np(evv_t))
        np.testing.assert_array_equal(np.asarray(ev_r), _np(ev_t))


@pytest.mark.parametrize("name,kw", AGGS)
@pytest.mark.parametrize("kind", ["tuple", "time"])
def test_window_pao_matches(name, kw, kind):
    rng = np.random.default_rng(7)
    ra, ta = RA.make_aggregate(name, **kw), TA.make_aggregate(name, **kw)
    vd = kw.get("value_dim", 1)
    args = dict(kind=kind, size=3 if kind == "tuple" else 4.0, capacity=5,
                value_dim=vd)
    spec_r, spec_t = RW.WindowSpec(**args), TW.WindowSpec(**args)
    state = RW.init_windows(9, spec_r)
    for t in range(4):
        rows, vals, _, mask = _stream(rng, 9, 24, vd)
        if name == "topk":
            vals = rng.integers(0, 8, 24).astype(np.float32)
        state, _, _ = RW.apply_writes(
            state, spec_r, jnp.asarray(rows), jnp.asarray(vals),
            jnp.full(24, float(t), jnp.float32), jnp.asarray(mask))
    now = 5.0
    want = np.asarray(RW.window_pao(state, spec_r, ra, now=now))
    got = TW.window_pao(_to_torch(state), spec_t, ta,
                        now=torch.tensor(now)).numpy()
    if ra.combine == "sum" and name not in ("count", "topk"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.asarray(RW.live_mask(state, spec_r, now)),
        TW.live_mask(_to_torch(state), spec_t, now).numpy())
    np.testing.assert_array_equal(
        np.asarray(RW.stale_rows(state, spec_r, 1.0, now)),
        TW.stale_rows(_to_torch(state), spec_t, 1.0, now).numpy())


def test_pad_and_reset_window_rows_match():
    rng = np.random.default_rng(3)
    spec_r, spec_t = RW.WindowSpec("tuple", 3), TW.WindowSpec("tuple", 3)
    state = RW.init_windows(5, spec_r)
    rows, vals, stamps, mask = _stream(rng, 5, 20, 1)
    state, _, _ = RW.apply_writes(state, spec_r, jnp.asarray(rows),
                                  jnp.asarray(vals), jnp.asarray(stamps),
                                  jnp.asarray(mask))
    port = _to_torch(state)
    for n in (8, 5, 3):
        _assert_state_equal(RW.pad_window_rows(state, n),
                            TW.pad_window_rows(port, n))
    _assert_state_equal(RW.reset_window_rows(state, [1, 3]),
                        TW.reset_window_rows(port, [1, 3]))
    _assert_state_equal(RW.init_windows(4, spec_r),
                        TW.init_windows(4, spec_t, device="cpu"))


@pytest.mark.parametrize("name,kw", AGGS)
def test_aggregate_lift_finalize_merge_match(name, kw):
    rng = np.random.default_rng(11)
    ra, ta = RA.make_aggregate(name, **kw), TA.make_aggregate(name, **kw)
    for f in ("name", "pao_dim", "combine", "dup_insensitive",
              "supports_subtraction", "value_dim", "cache_key", "identity"):
        assert getattr(ra, f) == getattr(ta, f), f
    vd = kw.get("value_dim", 1)
    raw = rng.normal(size=(32,) if vd == 1 else (32, vd)).astype(np.float32)
    if name == "topk":
        raw = rng.integers(-2, 10, 32).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(ra.lift(jnp.asarray(raw))),
                                  ta.lift(torch.as_tensor(raw)).numpy())
    pao = rng.normal(size=(16, ra.pao_dim)).astype(np.float32)
    if name == "topk":  # integer counts with many ties
        pao = rng.integers(0, 3, (16, ra.pao_dim)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(ra.finalize(jnp.asarray(pao))),
                                  ta.finalize(torch.as_tensor(pao)).numpy())
    seg = rng.integers(0, 5, 16)
    want = np.asarray(ra.segment_merge(jnp.asarray(pao), jnp.asarray(seg), 5))
    got = ta.segment_merge(torch.as_tensor(pao), torch.as_tensor(seg),
                           5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(ra.init_pao(4)),
                                  ta.init_pao(4, device="cpu").numpy())
    # the per-event UDF API (scalar streams)
    acc_r, acc_t = ra.INITIALIZE(), ta.INITIALIZE()
    for v in (raw[:5] if vd == 1 else ()):
        acc_r = ra.UPDATE(acc_r, None, float(v))
        acc_t = ta.UPDATE(acc_t, None, float(v))
    np.testing.assert_allclose(acc_t, acc_r, rtol=1e-6)
    np.testing.assert_array_equal(ta.FINALIZE(acc_t), ra.FINALIZE(acc_r))


def test_topk_ties_put_lower_index_first():
    p = np.array([[1, 3, 3, 0, 3, 1]], np.float32)
    agg = TA.make_aggregate("topk", k=3, domain=6)
    assert agg.finalize(torch.as_tensor(p)).tolist() == [[1, 2, 4]]
    ref = RA.make_aggregate("topk", k=3, domain=6)
    assert np.asarray(ref.finalize(jnp.asarray(p))).tolist() == [[1, 2, 4]]


def test_cache_key_equality_and_hash():
    a, b = TA.make_aggregate("topk", k=3), TA.make_aggregate("TOP-K", k=3)
    assert a == b and hash(a) == hash(b)
    assert a != TA.make_aggregate("topk", k=4)
    custom = TA.Aggregate(name="c", pao_dim=1, combine="sum",
                          lift=lambda v: v, finalize=lambda p: p)
    assert custom == custom and custom != TA.Aggregate(
        name="c", pao_dim=1, combine="sum", lift=lambda v: v,
        finalize=lambda p: p)
    assert TA.make_aggregate(custom) is custom


@pytest.mark.parametrize("bad", [("median", {}), (3, {}), ("topk", {"j": 1}),
                                 ("custom", None)])
def test_make_aggregate_errors_match(bad):
    name, kw = bad
    if kw is None:  # an Aggregate plus constructor kwargs
        name_r = RA.count_aggregate()
        name_t = TA.count_aggregate()
        kw = {"k": 2}
    else:
        name_r = name_t = name
    with pytest.raises(ValueError) as er:
        RA.make_aggregate(name_r, **kw)
    with pytest.raises(ValueError) as et:
        TA.make_aggregate(name_t, **kw)
    assert str(et.value) == str(er.value)
