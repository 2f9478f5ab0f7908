"""The port's optimizers (``repro_torch.train.optimizer``) against the JAX
package's on shared gradients: AdamW, Adafactor (layer-chunked and not,
with and without weight decay) and SGD over a parameter tree with 1-D,
2-D, layer-stacked 3-D and expert-stacked 4-D leaves, one and two updates,
every parameter and state leaf compared; their state layouts; convergence
on the JAX package's quadratic; Adafactor chunked equal to unchunked.
Inputs are numpy-made and handed to both sides. Tolerance: rtol 1e-5 /
atol 1e-7 on states and parameters (fp32; the two sides differ in the
order of Adafactor's means and in the last bit of a power)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import optimizer as JO  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train.trainer import make_train_step  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, which only
    contend with the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-7)
SHAPES = {"b": (7,), "w": (6, 5), "layers": {"wq": (3, 6, 4),
                                              "we": (2, 3, 5, 4)}}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        return (rng.normal(size=node) * scale).astype(np.float32)

    return draw(SHAPES)


def _np(tree):
    return [np.asarray(x) for x in TO.tree_leaves(tree)]


def _check(got, want, what):
    got, want = _np(got), [np.asarray(x) for x in jax.tree.leaves(want)]
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, err_msg=what, **TOL)


CASES = [("adamw", {}), ("adamw", {"weight_decay": 0.0}), ("adafactor", {}),
         ("adafactor", {"layer_chunked": False}),
         ("adafactor", {"weight_decay": 0.01, "clip": 0.05}), ("sgd", {})]


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{'-'.join(kw) or 'default'}"
                              for n, kw in CASES])
def test_updates_match_jax_on_shared_grads(name, kw):
    p0 = _tree(0)
    grads = [_tree(1, 0.1), _tree(2, 0.3)]
    jopt, topt = JO.get_optimizer(name, **kw), TO.get_optimizer(name, **kw)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jopt.init(jp)
    tp = convert.params_from_reference(p0, device="cpu")
    ts = topt.init(tp)
    for i, g in enumerate(grads):
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp,
                             jnp.float32(0.01))
        tp2, ts2 = topt.update(convert.params_from_reference(g, device="cpu"),
                               ts, tp, 0.01)
        assert tp2 is tp and ts2 is ts          # updated in place
        _check(tp, jp, f"params after update {i + 1}")
        _check(ts, js, f"state after update {i + 1}")


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_state_layout_matches_jax(name):
    p0 = _tree(0)
    js = JO.get_optimizer(name).init(jax.tree.map(jnp.asarray, p0))
    ts = TO.get_optimizer(name).init(convert.params_from_reference(
        p0, device="cpu"))
    assert type(ts).__name__ == type(js).__name__
    jl, tl = jax.tree.leaves(js), TO.tree_leaves(ts)
    assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl]
    assert [str(x.dtype).removeprefix("torch.") for x in tl] == \
        [x.dtype.name for x in jl]


def test_carried_state_converts_from_jax():
    """A non-zero JAX state, carried across by ``opt_state_from_reference``,
    equals the port's own state after the same updates."""
    p0, g = _tree(0), _tree(1, 0.1)
    for name in ("adamw", "adafactor", "sgd"):
        jopt, topt = JO.get_optimizer(name), TO.get_optimizer(name)
        jp = jax.tree.map(jnp.asarray, p0)
        _, js = jopt.update(jax.tree.map(jnp.asarray, g), jopt.init(jp), jp,
                            0.01)
        carried = convert.opt_state_from_reference(
            jax.tree.map(np.asarray, js), device="cpu")
        tp = convert.params_from_reference(p0, device="cpu")
        _, ts = topt.update(convert.params_from_reference(g, device="cpu"),
                            topt.init(tp), tp, 0.01)
        assert type(carried) is type(ts)
        _check(carried, js, name)
        _check(ts, js, name)


def _quadratic_problem(key=0, n=16):
    """The JAX package's test problem (tests/test_optim_trainer.py), its
    arrays handed over as numpy."""
    x = np.array(jax.random.normal(jax.random.PRNGKey(key), (64, n)))
    w_true = np.array(jax.random.normal(jax.random.PRNGKey(key + 1),
                                          (n, 1)))

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return ((pred - batch["y"]) ** 2).mean(), {}

    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(x @ w_true)}
    return batch, {"w": torch.zeros((n, 1))}, loss_fn


@pytest.mark.parametrize("name,lr,steps,tol", [
    ("adamw", 0.05, 400, 1e-2),
    # adafactor's relative-step clipping makes it sign-SGD-like: needs a
    # decaying lr to settle (as in real usage)
    ("adafactor", 0.5, 800, 5e-2),
    ("sgd", 0.05, 400, 1e-2),
])
def test_optimizers_converge(name, lr, steps, tol):
    batch, params, loss_fn = _quadratic_problem()
    opt = TO.get_optimizer(name) if name != "adamw" \
        else TO.adamw(weight_decay=0.0)
    step = make_train_step(loss_fn, opt, clip_norm=None)
    opt_state = opt.init(params)
    for t in range(steps):
        lr_t = lr / np.sqrt(t + 1.0) if name == "adafactor" else lr
        params, opt_state, m = step(params, opt_state, batch, lr_t)
    assert float(m["loss"]) < tol, float(m["loss"])


def test_adafactor_layer_chunked_matches_unchunked():
    """With the clip out of play the per-layer and whole-tensor updates are
    one function (the JAX package's test)."""
    rng = np.random.default_rng(0)
    p = {"w": torch.from_numpy(rng.normal(size=(4, 8, 6)).astype(np.float32))}
    g = {"w": torch.from_numpy(
        (rng.normal(size=(4, 8, 6)) * 0.1).astype(np.float32))}
    o1 = TO.adafactor(layer_chunked=True, clip=1e9)
    o2 = TO.adafactor(layer_chunked=False, clip=1e9)
    p1 = {"w": p["w"].clone()}
    p2 = {"w": p["w"].clone()}
    _, s1 = o1.update(g, o1.init(p1), p1, 0.1)
    _, s2 = o2.update(g, o2.init(p2), p2, 0.1)
    np.testing.assert_allclose(s1.vr["w"].numpy(), s2.vr["w"].numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(p1["w"].numpy(), p2["w"].numpy(), rtol=1e-5,
                               atol=1e-6)


def test_adafactor_clip_is_per_layer():
    """With the clip active, a layer of tiny gradients beside one of large
    gradients moves as far as the large one (the per-layer clip), not
    scaled down with the stacked tensor."""
    g = torch.ones((2, 4, 4))
    g[0] *= 1e-3
    p = {"w": torch.zeros((2, 4, 4))}
    opt = TO.adafactor(clip=1.0)
    opt.update({"w": g}, opt.init(p), p, 0.1)
    np.testing.assert_allclose(p["w"][0].numpy(), p["w"][1].numpy(),
                               rtol=1e-5)


def test_bf16_params_update_in_their_dtype():
    """A bf16 leaf is updated in fp32 and rounded once, as the JAX
    package's ``astype(p.dtype)``."""
    p0 = _tree(0)["w"]
    g = _tree(1, 0.1)["w"]
    jopt, topt = JO.adamw(), TO.adamw()
    jp = {"w": jnp.asarray(p0, jnp.bfloat16)}
    jp, _ = jopt.update({"w": jnp.asarray(g)}, jopt.init(jp), jp, 0.01)
    tp = {"w": torch.from_numpy(p0).to(torch.bfloat16)}
    topt.update({"w": torch.from_numpy(g)}, topt.init(tp), tp, 0.01)
    assert tp["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["w"].float().numpy(),
                                  np.asarray(jp["w"], np.float32))
