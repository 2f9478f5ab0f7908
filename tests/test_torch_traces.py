"""The port's trace generators (``repro_torch.streams.traces``, host numpy)
against the JAX package's: equal arrays for equal seeds — Zipf frequencies,
mixed read/write traces (scalar and vector payloads), the §5.3 shifted
workload and batched playback with and without padding."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.streams import traces as R  # noqa: E402
from repro_torch.streams import traces as T  # noqa: E402


def _trace_fields(tr):
    return (tr.kind, tr.node, tr.value, tr.write_freq, tr.read_freq)


@pytest.mark.parametrize("n,alpha,seed", [(1, 1.0, 0), (500, 1.5, 3),
                                          (4096, 0.8, 11)])
def test_zipf_frequencies_equal(n, alpha, seed):
    a, b = R.zipf_frequencies(n, alpha, seed), T.zipf_frequencies(n, alpha,
                                                                   seed)
    np.testing.assert_array_equal(a, b)
    assert b.dtype == np.float64 and np.isclose(b.sum(), 1.0)


@pytest.mark.parametrize("ratio,value_dim,seed", [(1.0, 1, 0), (4.0, 1, 5),
                                                  (0.5, 3, 9)])
def test_generate_trace_and_shift_equal(ratio, value_dim, seed):
    rng = np.random.default_rng(seed)
    writers = np.unique(rng.integers(0, 900, 400))
    readers = np.unique(rng.integers(200, 1000, 300))
    kw = dict(write_read_ratio=ratio, alpha=1.5, value_domain=16, seed=seed,
              value_dim=value_dim)
    a = R.generate_trace(writers, readers, 2000, **kw)
    b = T.generate_trace(writers, readers, 2000, **kw)
    assert a.n_events == b.n_events == 2000
    for x, y in zip(_trace_fields(a), _trace_fields(b)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    boost = readers[:7]
    sa = R.shift_workload(a, boost, factor=10.0, seed=seed + 1)
    sb = T.shift_workload(b, boost, factor=10.0, seed=seed + 1)
    for x, y in zip(_trace_fields(sa), _trace_fields(sb)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("pad", [False, True])
def test_batched_playback_equal(pad):
    rng = np.random.default_rng(2)
    writers, readers = np.arange(0, 300), np.arange(100, 400)
    a = R.generate_trace(writers, readers, 1500, alpha=1.2, seed=4)
    b = T.generate_trace(writers, readers, 1500, alpha=1.2, seed=4)
    size = int(rng.integers(7, 64))
    ra = list(R.batched_playback(a, size, pad=pad))
    rb = list(T.batched_playback(b, size, pad=pad))
    assert len(ra) == len(rb) > 1
    for x, y in zip(ra, rb):
        assert len(x) == len(y) == (4 if pad else 3)
        assert x[0] == y[0]
        np.testing.assert_array_equal(x[1], y[1])
        np.testing.assert_array_equal(x[2], y[2])
        if pad:
            assert x[3] == y[3] and len(y[1]) == size
