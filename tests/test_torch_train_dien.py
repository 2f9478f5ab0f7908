"""The port's DIEN training path against the JAX package's on
``SMOKE_CFG``: parameters and a training batch (ragged behaviour masks,
partly masked profile bags with an empty one, labels and sampled
negatives) drawn with numpy and handed to both sides; ``aux_loss`` and
``loss_fn``'s loss, metrics and every gradient leaf (the profile table's
through the embedding-bag wrapper's backward, whose CPU path is the
kernel's plain version), then one and two AdamW train steps. The reduced
``train_batch`` cell builds and steps.

Tolerances (fp32): loss and metrics rtol 1e-5; gradients rtol 1e-4 plus
1e-4 of the leaf's largest magnitude (the two packages sum in other
orders; the attention's gradients are tiny, ~1e-8, and differ there by up
to 5e-3 of themselves, 1e-5 of the leaf's largest); after
a step the AdamW state rtol 1e-3 plus 1e-3 of the leaf's largest
magnitude and each parameter's move within 1e-4 of itself plus 1e-2 of
lr, where its gradient has |g| > 1e-5 (AdamW divides each entry by its own
RMS; see tests/test_torch_train_lm.py)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.dien import SMOKE_CFG as JAX_SMOKE  # noqa: E402
from repro.models.recsys import dien as JD  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train.trainer import make_train_step as j_train_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import dien as tconfigs  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as bag_ops  # noqa: E402
from repro_torch.models.recsys import dien as TD  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train.trainer import make_train_step, value_and_grad  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, which only
    contend with the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = tconfigs.SMOKE_CFG


def numpy_params(specs, seed):
    rng = np.random.default_rng(seed)

    def draw(s):
        fan_in = s.shape[0] if len(s.shape) > 1 else max(1, s.shape[-1])
        return (rng.normal(size=s.shape) * s.init_scale
                / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree.map(draw, specs,
                        is_leaf=lambda x: hasattr(x, "init_scale"))


def train_batch(B, seed):
    rng = np.random.default_rng(seed)
    S, nb = CFG.seq_len, CFG.profile_bag_size
    mask = rng.random((B, S)) < 0.8
    mask[0] = False                       # a user with no behaviour at all
    pmask = rng.random((B, nb)) < 0.6
    pmask[1] = False                      # a user with an empty profile
    ints = lambda hi, shape: rng.integers(0, hi, shape).astype(np.int32)
    return dict(
        item_ids=ints(CFG.n_items, (B, S)), cat_ids=ints(CFG.n_cats, (B, S)),
        mask=mask, target_item=ints(CFG.n_items, B),
        target_cat=ints(CFG.n_cats, B),
        profile_ids=ints(CFG.n_profile_feats, (B, nb)), profile_mask=pmask,
        labels=ints(2, B), neg_item_ids=ints(CFG.n_items, (B, S)),
        neg_cat_ids=ints(CFG.n_cats, (B, S)))


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _leaf_close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol[0],
                               atol=tol[1] * float(np.abs(want).max()),
                               err_msg=what)


@pytest.fixture(scope="module")
def np_params():
    return numpy_params(JD.param_specs(JAX_SMOKE), seed=0)


def test_aux_loss_matches_jax(np_params):
    rng = np.random.default_rng(7)
    B, S = 5, CFG.seq_len
    hs = rng.normal(size=(B, S, CFG.gru_dim)).astype(np.float32)
    behav, neg = (rng.normal(size=(B, S, CFG.behav_dim)).astype(np.float32)
                  for _ in range(2))
    mask = rng.random((B, S)) < 0.7
    want = JD.aux_loss(None, *map(jnp.asarray, (hs, behav, neg, mask)))
    got = TD.aux_loss(None, *map(torch.from_numpy, (hs, behav, neg, mask)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("aux_weight", [1.0, 0.25])
def test_loss_and_gradients_match_jax(np_params, aux_weight):
    batch = train_batch(8, seed=1)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        functools.partial(JD.loss_fn, cfg=JAX_SMOKE, aux_weight=aux_weight),
        has_aux=True))(_j(np_params), _j(batch))
    bag_ops.reset_launches()
    tl, tm, tg = value_and_grad(
        functools.partial(TD.loss_fn, cfg=CFG, aux_weight=aux_weight),
        convert.params_from_reference(np_params, device="cpu"), _t(batch))
    assert bag_ops.LAUNCHES == {"embedding_bag": 0,
                                "embedding_bag_backward": 0}
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jg)[0]]
    jl_ = jax.tree.leaves(jg)
    assert len(tg) == len(jl_)
    for path, g, w in zip(paths, tg, jl_):
        w = np.asarray(w)
        if path in ("['profile_embed']", "['item_embed']"):
            assert np.abs(w).max() > 0, path     # the lookups do train
        if path == "['ret_w']":
            assert (g.numpy() == 0).all()        # retrieval only
        _leaf_close(g.numpy(), w, (1e-4, 1e-4), path)


def test_train_steps_match_jax(np_params):
    """Two AdamW steps (clip 1.0) on two batches: the loss, ``grad_norm``,
    the state and the parameters after each."""
    jopt, topt = JO.adamw(), TO.adamw()
    jstep = jax.jit(j_train_step(functools.partial(JD.loss_fn,
                                                   cfg=JAX_SMOKE), jopt))
    tstep = make_train_step(functools.partial(TD.loss_fn, cfg=CFG), topt)
    jp = _j(np_params)
    js = jopt.init(jp)
    tp = convert.params_from_reference(np_params, device="cpu")
    ts = topt.init(tp)
    for i in range(2):
        batch = train_batch(8, seed=10 + i)
        _, _, g = value_and_grad(functools.partial(TD.loss_fn, cfg=CFG), tp,
                                 _t(batch))
        before = [np.asarray(x) for x in jax.tree.leaves(jp)]
        jp, js, jm = jstep(jp, js, _j(batch), jnp.float32(1e-3))
        tp, ts, tm = tstep(tp, ts, _t(batch), 1e-3)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"{k} step {i}")
        for a, b in zip(TO.tree_leaves(ts), jax.tree.leaves(js)):
            _leaf_close(a.numpy(), b, (1e-3, 1e-3), f"state step {i}")
        for a, b, p0, gi in zip(TO.tree_leaves(tp), jax.tree.leaves(jp),
                                before, g):
            keep = np.abs(gi.numpy()) > 1e-5
            got, want = a.numpy()[keep] - p0[keep], np.asarray(b)[keep] \
                - p0[keep]
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                       err_msg=f"params step {i}")


def test_train_cell_builds_and_steps():
    """``build_smoke("train_batch")``: the JAX package's reduced cell (batch
    8 with labels and negatives, AdamW, lr 1e-3); steps on the CPU with a
    falling loss on one batch."""
    c = tconfigs.build_smoke("train_batch", device="cpu")
    assert c["cfg"] == CFG and c["optimizer"].name == "adamw"
    assert c["lr"] == 1e-3
    for k in ("labels", "neg_item_ids", "neg_cat_ids"):
        assert c["batch"][k].shape[0] == 8
    losses = []
    p, s = c["params"], c["opt_state"]
    for _ in range(5):
        p, s, m = c["step"](p, s, c["batch"], 1e-2)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
