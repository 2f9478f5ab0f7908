"""The embedding-bag backward (the dense table gradient of the port's bag):
its plain version ``embedding_bag_backward_ref`` (what a CPU tensor runs,
and the kernel's comparison on the card) against ``jax.grad`` of the JAX
package's ``embedding_bag_ref`` and of DIEN's ``profile_embed``, with
padding ids, ids past the table, ids before the first bag and empty bags;
its summation order (each product rounded, rows added in id order, the
CUDA kernel's order) against a sequential fp32 loop; the autograd
``Function`` against autograd through the plain forward; and the wrapper's
checks. Inputs are numpy-made and handed to both sides. Tolerance: 1e-6
against JAX (fp32 sums of a handful of products; on these inputs they come
out bit-equal), bit-equal inside the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.dien import SMOKE_CFG as JAX_SMOKE  # noqa: E402
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_ref  # noqa: E402
from repro.models.recsys import dien as JD  # noqa: E402
from repro_torch.configs import dien as tconfigs  # noqa: E402
from repro_torch.kernels.embedding_bag import ops  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import (  # noqa: E402
    bags_of,
    embedding_bag_backward_ref,
    embedding_bag_ref,
)
from repro_torch.models.recsys import dien as TD  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, which only
    contend with the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-6, atol=1e-6)


def _case(V, D, n_ids, n_bags, seed, *, pad=0.2, past=0.05, lead=0):
    """grad_out, ids, offsets, weights (numpy): a ``pad`` share of ids -1, a
    ``past`` share at or past V, the first bag starting at ``lead`` (ids
    before it belong to no bag), repeated offsets (empty bags)."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n_bags, D)).astype(np.float32)
    ids = rng.integers(0, V, n_ids).astype(np.int32)
    ids[rng.random(n_ids) < pad] = -1
    ids[rng.random(n_ids) < past] = V + rng.integers(0, 3)
    offs = np.sort(rng.integers(lead, n_ids + 1, n_bags)).astype(np.int32)
    offs[0] = lead
    w = rng.normal(size=n_ids).astype(np.float32)
    return g, ids, offs, w


SHAPES = [(100, 16, 64, 8), (1000, 32, 256, 16), (500, 64, 100, 100),
          (64, 8, 16, 1), (1000, 18, 512 * 16, 512)]


@pytest.mark.parametrize("V,D,n_ids,n_bags", SHAPES)
@pytest.mark.parametrize("weighted", [False, True])
def test_plain_backward_matches_jax_grad(V, D, n_ids, n_bags, weighted):
    """``jax.grad`` of sum(g * embedding_bag_ref(table)) in the table (the
    JAX package drops negative ids; ids past V are dropped here by masking
    them to -1 on the JAX side, where ``jnp.take`` would clamp them)."""
    g, ids, offs, w = _case(V, D, n_ids, n_bags, seed=V + n_ids,
                            lead=3 if n_ids > 8 else 0)
    bags = np.asarray(bags_of(torch.from_numpy(offs), n_ids))
    jids = np.where((ids >= V) | (bags < 0), -1, ids)
    table = np.zeros((V, D), np.float32)
    jw = jnp.asarray(w) if weighted else None

    def f(t):
        out = jax_ref(t, jnp.asarray(jids), jnp.asarray(np.maximum(bags, 0)),
                      n_bags, weights=jw)
        return jnp.sum(out * jnp.asarray(g))

    want = np.asarray(jax.grad(f)(jnp.asarray(table)))
    got = embedding_bag_backward_ref(
        torch.from_numpy(g), torch.from_numpy(ids), torch.from_numpy(bags),
        V, weights=torch.from_numpy(w) if weighted else None)
    assert got.shape == (V, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the wrapper (CPU path) is the plain version
    via = ops.embedding_bag_backward(
        torch.from_numpy(g), torch.from_numpy(ids), torch.from_numpy(offs),
        n_rows=V, weights=torch.from_numpy(w) if weighted else None)
    assert torch.equal(via, got)


def test_profile_embed_gradient_matches_jax():
    """DIEN's profile lookup: the gradient of the port's ``profile_embed``
    (the bag with the mask as weights, then the division by the count)
    through the wrapper's backward, against ``jax.grad`` of the JAX
    package's gather + masked mean, partly masked bags and an empty one."""
    rng = np.random.default_rng(4)
    B, nb = 6, JAX_SMOKE.profile_bag_size
    V, D = JAX_SMOKE.n_profile_feats, JAX_SMOKE.embed_dim
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(0, V, (B, nb)).astype(np.int32)
    mask = rng.random((B, nb)) < 0.6
    mask[1] = False
    g = rng.normal(size=(B, D)).astype(np.float32)

    def f(t):
        out = JD.profile_embed({"profile_embed": t}, jnp.asarray(ids),
                               jnp.asarray(mask), JAX_SMOKE)
        return jnp.sum(out * jnp.asarray(g))

    want = np.asarray(jax.grad(f)(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_()
    out = TD.profile_embed({"profile_embed": t}, torch.from_numpy(ids),
                           torch.from_numpy(mask), tconfigs.SMOKE_CFG)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, **TOL)
    assert (t.grad.numpy()[np.setdiff1d(np.arange(V), ids[mask])] == 0).all()


def test_plain_backward_sums_each_row_in_id_order():
    """The kernel adds a row's rounded products w_i * grad_out[bag_i] in id
    order, with no fused multiply-add; the plain version on the CPU does
    the same, so the two agree bit for bit. Pinned at DIEN's shape (512
    bags of 16 ids, D 18) over a small table (many ids a row) against a
    sequential fp32 loop."""
    rng = np.random.default_rng(21)
    V, D, n_bags, bag = 300, 18, 512, 16
    g = rng.normal(size=(n_bags, D)).astype(np.float32)
    ids = rng.integers(0, V, n_bags * bag).astype(np.int32)
    ids[rng.random(ids.size) < 0.2] = -1
    w = rng.normal(size=ids.size).astype(np.float32)
    offs = np.arange(0, ids.size, bag, dtype=np.int32)
    got = ops.embedding_bag_backward(
        *map(torch.from_numpy, (g, ids, offs)), n_rows=V,
        weights=torch.from_numpy(w)).numpy()
    want = np.zeros((V, D), np.float32)
    for i, v in enumerate(ids):
        if v >= 0:
            want[v] = want[v] + w[i] * g[i // bag]    # fp32, in id order
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("weighted", [False, True])
def test_autograd_function_matches_autograd_through_plain_forward(weighted):
    g, ids, offs, w = _case(200, 18, 300, 20, seed=5, lead=2)
    table = np.random.default_rng(6).normal(size=(200, 18)).astype(np.float32)
    weights = torch.from_numpy(w) if weighted else None
    a = torch.from_numpy(table).requires_grad_()
    out = ops.embedding_bag(a, torch.from_numpy(ids), torch.from_numpy(offs),
                            n_bags=20, weights=weights)
    (out * torch.from_numpy(g)).sum().backward()
    b = torch.from_numpy(table).requires_grad_()
    ref = embedding_bag_ref(b, torch.from_numpy(ids),
                            bags_of(torch.from_numpy(offs), 300), 20,
                            weights=weights)
    (ref * torch.from_numpy(g)).sum().backward()
    assert torch.equal(out.detach(), ref.detach())
    assert torch.equal(a.grad, b.grad)


def test_weights_and_ids_get_no_gradient():
    g, ids, offs, w = _case(50, 8, 32, 4, seed=1)
    table = torch.zeros((50, 8), requires_grad=True)
    wt = torch.from_numpy(w).requires_grad_()
    with pytest.raises(ValueError, match="no gradient to its weights"):
        ops.embedding_bag(table, torch.from_numpy(ids),
                          torch.from_numpy(offs), n_bags=4, weights=wt)
    with torch.no_grad():
        ops.embedding_bag(table, torch.from_numpy(ids),
                          torch.from_numpy(offs), n_bags=4, weights=wt)
    out = ops.embedding_bag(table, torch.from_numpy(ids),
                            torch.from_numpy(offs), n_bags=4,
                            weights=wt.detach())
    assert out.requires_grad


@pytest.mark.parametrize("bad", ["grad_dtype", "offsets", "weights",
                                 "device", "n_rows"])
def test_backward_wrapper_rejects_what_the_kernel_does_not_take(bad):
    g, ids, offs, w = map(torch.from_numpy, _case(50, 8, 32, 4, seed=1))
    kw = {"n_rows": 50}
    if bad == "grad_dtype":
        g = g.double()
    elif bad == "offsets":
        offs = offs[:3]
    elif bad == "weights":
        kw["weights"] = w[:5]
    elif bad == "n_rows":
        kw["n_rows"] = -1
    else:
        g, ids, offs = (t.to("meta") for t in (g, ids, offs))
    with pytest.raises((ValueError, TypeError)):
        ops.embedding_bag_backward(g, ids, offs, **kw)


def test_cpu_backward_counts_no_launch():
    ops.reset_launches()
    g, ids, offs, w = map(torch.from_numpy, _case(50, 18, 64, 4, seed=2))
    table = torch.zeros((50, 18), requires_grad=True)
    ops.embedding_bag(table, ids, offs, n_bags=4, weights=w).sum().backward()
    assert table.grad is not None
    assert ops.LAUNCHES == {"embedding_bag": 0, "embedding_bag_backward": 0}
