"""The port's segment_agg layer against the JAX package's: plan builders bit
for bit, and the wrapper's plain PyTorch version (what a CPU tensor runs)
against the JAX oracle and the interpret-mode Pallas kernel, across the
shape sweep of ``tests/test_kernels.py``. Inputs are made with numpy from a
seed and handed to both sides."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.segment_agg import ops as R  # noqa: E402
from repro.kernels.segment_agg.ref import segment_agg_ref as jax_ref  # noqa: E402
from repro_torch.kernels.segment_agg import ops as T  # noqa: E402
from repro_torch.kernels.segment_agg.ref import (  # noqa: E402
    segment_agg_level_ref,
    segment_agg_ref,
)

SWEEP = [(100, 8, 17), (1000, 64, 300), (37, 5, 10), (4096, 128, 128),
         (513, 200, 77), (1, 1, 1), (2000, 96, 1000)]


def _inputs(E, F, n_rows, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_rows, E),
            rng.normal(size=(E, F)).astype(np.float32))


@pytest.mark.parametrize("E,F,n_rows", SWEEP)
def test_make_plan_bit_equal(E, F, n_rows):
    seg, _ = _inputs(E, F, n_rows)
    a, b = R.make_plan(seg, n_rows), T.make_plan(seg, n_rows)
    for f in ("perm", "seg_padded", "tile_of_block", "first_of_tile"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert (a.n_rows, a.n_row_tiles, a.e_pad) == (b.n_rows, b.n_row_tiles,
                                                  b.e_pad)
    assert T.count_blocks(seg) == R.count_blocks(seg)


@pytest.mark.parametrize("pad", [None, (8, 64)])
def test_leveled_plan_bit_equal(pad):
    rng = np.random.default_rng(1)
    n_rows = 700
    segs = [rng.integers(0, n_rows, n) for n in (900, 0, 300, 2500, 17)]
    kw = {} if pad is None else dict(pad_levels=pad[0], pad_blocks=pad[1])
    a = R.make_leveled_plan(segs, n_rows, **kw)
    b = T.make_leveled_plan(segs, n_rows, **kw)
    for f in ("seg", "tile_of_block", "first_of_tile", "tile_slots"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype
    assert len(a.perms) == len(b.perms)
    for x, y in zip(a.perms, b.perms):
        np.testing.assert_array_equal(x, y)
    vals = rng.integers(0, 50, 2500).astype(np.int32)
    np.testing.assert_array_equal(a.layout(3, vals), b.layout(3, vals))
    assert T.leveled_plan_blocks(segs) == R.leveled_plan_blocks(segs)
    for l in range(a.n_levels):
        np.testing.assert_array_equal(
            R.tile_slot_ranges(a.tile_of_block[l], a.n_row_tiles),
            T.tile_slot_ranges(b.tile_of_block[l], b.n_row_tiles))


@pytest.mark.parametrize("n_blocks", [4, 16])
def test_relayout_level_bit_equal(n_blocks):
    rng = np.random.default_rng(2)
    dst = rng.integers(0, 300, 400)
    src = rng.integers(0, 300, 400)
    sign = rng.choice([-1.0, 1.0], 400).astype(np.float32)
    a = R.relayout_level(dst, src, sign, 300, n_blocks, n_blocks * R.E_BLK)
    b = T.relayout_level(dst, src, sign, 300, n_blocks, n_blocks * T.E_BLK)
    assert (a is None) == (b is None)
    if a is not None:
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("E,F,n_rows", SWEEP)
@pytest.mark.parametrize("op", ["sum", "max"])
def test_plain_version_matches_jax_oracle(E, F, n_rows, op):
    """The wrapper on CPU tensors (the plain version) against
    ``repro.kernels.segment_agg.ref.segment_agg_ref``, to 1e-5."""
    seg, x = _inputs(E, F, n_rows)
    plan = T.make_plan(seg, n_rows)
    got = T.segment_agg(torch.as_tensor(x), plan, op=op).numpy()
    want = np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(seg), n_rows, op=op))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    direct = segment_agg_ref(torch.as_tensor(x), torch.as_tensor(seg),
                             n_rows, op).numpy()
    np.testing.assert_allclose(direct, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("E,F,n_rows", [(100, 8, 17), (1000, 64, 300),
                                        (513, 200, 77), (1, 1, 1)])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_plain_version_matches_pallas_interpret(E, F, n_rows, op):
    """The level wrapper against the Pallas kernel run in interpret mode on
    the same padded level, on the rows some slot routes to."""
    seg, x = _inputs(E, F, n_rows, seed=3)
    plan = R.make_plan(seg, n_rows)
    xp = np.zeros((plan.e_pad, F), np.float32)
    xp[plan.perm] = x
    want = np.asarray(R.segment_agg_level(
        jnp.asarray(xp), jnp.asarray(plan.seg_padded),
        jnp.asarray(plan.tile_of_block), jnp.asarray(plan.first_of_tile),
        n_rows=n_rows, n_row_tiles=plan.n_row_tiles, op=op, interpret=True))
    got = T.segment_agg_level(
        torch.as_tensor(xp), torch.as_tensor(plan.seg_padded),
        torch.as_tensor(plan.tile_of_block),
        torch.as_tensor(plan.first_of_tile),
        n_rows=n_rows, n_row_tiles=plan.n_row_tiles, op=op).numpy()
    hit = np.zeros(n_rows, bool)
    hit[seg] = True
    np.testing.assert_allclose(got[hit], want[hit], rtol=1e-5, atol=1e-5)
    # visited rows without a slot hold the op's identity, as on the TPU
    ident = 0.0 if op == "sum" else -3.0e38
    tiles = set(plan.tile_of_block.tolist())
    idle = [r for r in range(n_rows) if not hit[r] and r // T.R_BLK in tiles]
    np.testing.assert_array_equal(got[idle], np.full((len(idle), F), ident,
                                                     np.float32))


def test_empty_rows_read_zero():
    plan = T.make_plan(np.array([5, 5, 5]), 10)
    out = T.segment_agg(torch.ones((3, 4)), plan, op="max").numpy()
    assert np.allclose(out[5], 1.0) and np.allclose(out[0], 0.0)


def _level(F=3):
    plan = T.make_plan(np.array([0, 1, 1, 4]), 6)
    return (torch.zeros((plan.e_pad, F)), torch.as_tensor(plan.seg_padded),
            torch.as_tensor(plan.tile_of_block),
            torch.as_tensor(plan.first_of_tile), plan)


def test_cpu_path_counts_no_launch():
    x, seg, tob, fot, plan = _level()
    before = dict(T.LAUNCHES)
    T.segment_agg_level(x, seg, tob, fot, n_rows=6, n_row_tiles=1, op="sum")
    T.segment_agg_level(x, seg, tob, fot, n_rows=6, n_row_tiles=1, op="max")
    assert T.LAUNCHES == before


@pytest.mark.parametrize("case", ["dtype", "seg_dtype", "shape", "op",
                                  "contiguous", "device", "rows"])
def test_level_wrapper_rejects_bad_inputs(case):
    x, seg, tob, fot, plan = _level()
    kw = dict(n_rows=6, n_row_tiles=1, op="sum")
    if case == "dtype":
        x = x.to(torch.float64)
    elif case == "seg_dtype":
        seg = seg.to(torch.int64)
    elif case == "shape":
        x = x[:-1]
    elif case == "op":
        kw["op"] = "mean"
    elif case == "contiguous":
        x = torch.zeros((x.shape[1], x.shape[0])).t()
    elif case == "device":
        x = x.to("meta")
    elif case == "rows":
        kw["n_rows"] = 200
    with pytest.raises((TypeError, ValueError)):
        T.segment_agg_level(x, seg, tob, fot, **kw)


def test_level_ref_identity_and_padding():
    x = torch.tensor([[1.0], [2.0], [5.0], [7.0]])
    seg = torch.tensor([1, -1, 1, 0], dtype=torch.int32)
    s = segment_agg_level_ref(x, seg, 3, "sum")
    m = segment_agg_level_ref(x, seg, 3, "max")
    assert s.flatten().tolist() == [7.0, 6.0, 0.0]
    assert m.flatten().tolist() == [7.0, 5.0, np.float32(-3.0e38)]
