"""The port's embedding-bag layer against the JAX package's: the wrapper's
plain version (what a CPU tensor runs) against the interpret-mode Pallas
``embedding_bag`` and the JAX ``embedding_bag_ref``, weighted and
unweighted, with empty bags and padding ids, at ``tests/test_kernels.py``'s
shapes. Inputs are made with numpy from a seed and handed to both sides.
Tolerance 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.embedding_bag.ops import embedding_bag as jax_bag  # noqa: E402
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_ref  # noqa: E402
from repro_torch.kernels.embedding_bag import ops  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import bags_of  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(V, D, n_ids, n_bags, seed, *, empty=0, pad=0.0):
    """table, ids, offsets, weights (numpy). ``empty`` bags get no ids (runs
    of equal offsets); a ``pad`` share of ids is -1."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(0, V, n_ids).astype(np.int32)
    ids[rng.random(n_ids) < pad] = -1
    cuts = np.sort(rng.choice(np.arange(1, n_ids), size=n_bags - 1 - empty,
                              replace=False)) if n_bags > 1 else []
    offs = np.concatenate([[0], cuts]).astype(np.int32)
    if empty:
        offs = np.sort(np.concatenate(
            [offs, rng.choice(offs, size=empty)])).astype(np.int32)
    w = rng.normal(size=n_ids).astype(np.float32)
    return table, ids, offs, w


def _bags(offs, n_ids):
    return np.asarray(bags_of(torch.from_numpy(offs), n_ids)).astype(np.int32)


@pytest.mark.parametrize("V,D,n_ids,n_bags", [
    (100, 16, 64, 8), (1000, 32, 256, 16), (500, 64, 100, 100),
    (64, 8, 16, 1)])
@pytest.mark.parametrize("weighted", [False, True])
def test_matches_jax(V, D, n_ids, n_bags, weighted):
    table, ids, offs, w = _case(V, D, n_ids, n_bags, seed=V + n_bags)
    wt = torch.from_numpy(w) if weighted else None
    got = ops.embedding_bag(*map(torch.from_numpy, (table, ids, offs)),
                            n_bags=n_bags, weights=wt).numpy()
    jw = jnp.asarray(w) if weighted else None
    pallas = jax_bag(*map(jnp.asarray, (table, ids, offs)), n_bags=n_bags,
                     weights=jw, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    ref = jax_ref(jnp.asarray(table), jnp.asarray(ids),
                  jnp.asarray(_bags(offs, n_ids)), n_bags, weights=jw)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_empty_bags_and_padding_ids(weighted):
    n_bags = 24
    table, ids, offs, w = _case(200, 18, 96, n_bags, seed=7, empty=6, pad=0.3)
    wt = torch.from_numpy(w) if weighted else None
    got = ops.embedding_bag(*map(torch.from_numpy, (table, ids, offs)),
                            n_bags=n_bags, weights=wt).numpy()
    pallas = jax_bag(*map(jnp.asarray, (table, ids, offs)), n_bags=n_bags,
                     weights=jnp.asarray(w) if weighted else None,
                     interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    ends = np.append(offs[1:], len(ids))
    empty = offs == ends
    assert empty.sum() >= 1
    assert (got[empty] == 0).all()
    all_pad = np.array([(ids[a:b] < 0).all() for a, b in zip(offs, ends)])
    assert (got[all_pad] == 0).all()


def test_integer_table_is_exact():
    """Sums of small integers are exact in fp32 in any order."""
    rng = np.random.default_rng(11)
    table = rng.integers(-50, 51, size=(300, 18)).astype(np.float32)
    ids = rng.integers(-1, 300, 160).astype(np.int32)
    offs = np.arange(0, 160, 16, dtype=np.int32)
    got = ops.embedding_bag(*map(torch.from_numpy, (table, ids, offs)),
                            n_bags=10).numpy()
    want = np.stack([table[ids[a:a + 16][ids[a:a + 16] >= 0]].sum(0)
                     for a in offs])
    np.testing.assert_array_equal(got, want)


def test_one_large_bag_among_small_ones():
    """A bag of 200,000 ids beside bags of one: the plain version's memory
    is linear in the ids, whatever the largest bag, and it agrees with the
    JAX reference."""
    rng = np.random.default_rng(12)
    table = rng.integers(-50, 51, size=(1000, 18)).astype(np.float32)
    n_ids, n_bags = 200_100, 101
    ids = rng.integers(-1, 1000, n_ids).astype(np.int32)
    offs = np.concatenate([np.arange(100), [100]]).astype(np.int32)
    got = ops.embedding_bag(*map(torch.from_numpy, (table, ids, offs)),
                            n_bags=n_bags).numpy()
    want = jax_ref(jnp.asarray(table), jnp.asarray(ids),
                   jnp.asarray(_bags(offs, n_ids)), n_bags)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("bad", ["table_dtype", "offsets", "weights",
                                 "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    table, ids, offs, w = map(torch.from_numpy, _case(50, 8, 32, 4, seed=1))
    kw = {}
    if bad == "table_dtype":
        table = table.double()
    elif bad == "offsets":
        offs = offs[:3]
    elif bad == "weights":
        kw["weights"] = w[:5]
    else:
        table, ids, offs = (t.to("meta") for t in (table, ids, offs))
    with pytest.raises((ValueError, TypeError)):
        ops.embedding_bag(table, ids, offs, n_bags=4, **kw)


def test_plain_version_sums_each_bag_in_id_order():
    """The kernel adds a bag's rounded products w_i * row_i in id order; the
    plain version on the CPU does the same, so the two agree bit for bit on
    normal-valued tables too. Pinned here at DIEN's lookup shape (512 bags
    of 16 ids, D 18, weighted, a fifth of the ids padding) against a
    sequential fp32 loop."""
    rng = np.random.default_rng(21)
    V, D, n_bags, bag = 1000, 18, 512, 16
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(0, V, n_bags * bag).astype(np.int32)
    ids[rng.random(ids.size) < 0.2] = -1
    w = rng.normal(size=ids.size).astype(np.float32)
    offs = np.arange(0, ids.size, bag, dtype=np.int32)
    got = ops.embedding_bag(*map(torch.from_numpy, (table, ids, offs)),
                            n_bags=n_bags, weights=torch.from_numpy(w)).numpy()
    want = np.zeros((n_bags, D), np.float32)
    for b, lo in enumerate(offs):
        for i in range(lo, lo + bag):
            if ids[i] >= 0:
                want[b] = want[b] + w[i] * table[ids[i]]   # fp32, in order
    np.testing.assert_array_equal(got, want)


def test_cpu_path_counts_no_launch():
    ops.reset_launches()
    table, ids, offs, w = map(torch.from_numpy, _case(50, 18, 64, 4, seed=2))
    ops.embedding_bag(table.requires_grad_(), ids, offs, n_bags=4,
                      weights=w).sum().backward()
    assert ops.LAUNCHES == {"embedding_bag": 0, "embedding_bag_backward": 0}
