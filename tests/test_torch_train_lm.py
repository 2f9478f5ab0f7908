"""The port's LM training path against the JAX package's, on the reduced
(smoke) configs of every LM arch in fp32 (granite-3-2b, internlm2-1.8b,
command-r-plus-104b, and the MoE archs arctic-480b, einsum dispatch with a
dense residual in this test, and dbrx-132b, sort dispatch): parameters and
batches drawn with numpy from a seed and handed to both sides,
``loss_fn``'s loss, metrics and every gradient leaf, then one and two
train steps of each arch's own cell (optimizer, accumulation, clip), one
step with command-r-plus-104b's bf16 parameters and a binding clip; ``fused_ce_loss`` and its gradient
against the naive CE; remat bit-equal to no remat; training checkpoints
across the two packages' ``CheckpointManager``s; the flash kernels' refusal
to cut the graph.

Tolerances (fp32), each leaf against the JAX package's:
- loss and metrics: rtol 1e-4; ``grad_norm`` after a step 5e-4 (from
  the state after one step, dbrx-132b's gradients in each package lie
  within 5e-4 of a leaf's largest magnitude from fp64 and its norm
  within 2e-4 of the fp64 norm: ``test_each_package_sits_near_fp64``);
- gradients and logits: rtol 1e-4 plus an atol of 1e-4 times the leaf's
  largest magnitude. The two packages sum in other orders, and on these
  random-init models each package's fp32 gradients lie within 1e-4 of
  the leaf's largest magnitude from the same gradients in fp64, not
  within an elementwise 1e-6 (``test_each_package_sits_near_fp64`` holds
  both packages to that floor);
- optimizer state after a step: rtol 1e-3 plus 1e-3 of the leaf's largest
  magnitude: second moments square the gradients and Adafactor averages
  them over rows and columns, where the small entries carry the largest
  relative differences;
- parameters after a step: the step's move (p - p_before) within 1e-4 of
  itself plus two ulps of p and, for SGD, 1e-4 of the leaf's largest move;
  for AdamW and Adafactor, which divide each entry by its own RMS, 1e-2 of
  lr, and only where every step's gradient has |g| > 1e-5: AdamW's first
  steps move a parameter by about lr * g / (|g| + 1e-8), whose sensitivity
  to g is about 1e-8 / g^2, so the packages' gradient differences of up to
  ~1e-6 move entries with |g| below ~1e-5 by a visible share of lr (those
  entries are left to the moments' check).
"""
import dataclasses
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.lm_common import smoke_config as jax_smoke  # noqa: E402
from repro.distributed.checkpoint import CheckpointManager as JCkpt  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train.trainer import make_train_step as j_train_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.lm_common import smoke_config  # noqa: E402
from repro_torch.distributed.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
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


ARCHS = ["granite-3-2b", "internlm2-1.8b", "command-r-plus-104b",
         "arctic-480b", "dbrx-132b"]
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)   # scalars: loss, metrics
B, S = 4, 64


def assert_leaf_close(got, want, what="", tol=1e-4):
    """Elementwise within rtol ``tol`` plus ``tol`` of the leaf's largest
    magnitude (see the module docstring)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def assert_moved_alike(got, want, before, lr, normalizing, keep, what):
    """The parameters after a step: each side's move from ``before`` (see
    the module docstring), on the entries ``keep``."""
    got, want, before = (np.asarray(x, np.float64)[keep]
                         for x in (got, want, before))
    move = want - before
    atol = 1e-2 * lr if normalizing else \
        1e-4 * (float(np.abs(move).max()) if move.size else 0.0)
    bound = 1e-4 * np.abs(move) + atol \
        + 2 * np.spacing(np.abs(want).astype(np.float32))
    bad = np.abs(got - want) > bound
    assert not bad.any(), (f"{what}: {int(bad.sum())} of {bad.size} entries "
                           f"moved apart, worst {np.abs(got - want).max():.3g}")


def _module(arch_id, pkg):
    return importlib.import_module(
        f"{pkg}.configs." + arch_id.replace("-", "_").replace(".", "_"))


def _jax_lm(arch_id):
    return _module(arch_id, "repro").ARCH.build_smoke.__closure__[0] \
        .cell_contents


def numpy_params(specs, seed):
    rng = np.random.default_rng(seed)

    def draw(s):
        fan_in = s.shape[0] if len(s.shape) > 1 else max(1, s.shape[-1])
        return (rng.normal(size=s.shape) * s.init_scale
                / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree.map(draw, specs,
                        is_leaf=lambda x: hasattr(x, "init_scale"))


def numpy_batch(vocab, seed, b=B):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (b, S)).astype(np.int32)
            for k in ("tokens", "labels")}


@functools.lru_cache(maxsize=None)
def pair(arch_id):
    """(JAX cfg, port cfg, numpy params) of one smoke config; arctic's
    dispatch switched to einsum, so both dispatches train here."""
    jcfg = jax_smoke(_jax_lm(arch_id).cfg)
    tcfg = smoke_config(_module(arch_id, "repro_torch").CFG)
    if arch_id == "arctic-480b":
        jcfg = dataclasses.replace(jcfg, moe_impl="einsum")
        tcfg = dataclasses.replace(tcfg, moe_impl="einsum")
    return jcfg, tcfg, numpy_params(JT.param_specs(jcfg), seed=0)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _leaves(tree):
    return [np.asarray(x) for x in TO.tree_leaves(tree)]


def _jleaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@functools.lru_cache(maxsize=None)
def jax_grad_fn(arch_id):
    jcfg = pair(arch_id)[0]
    return jax.jit(jax.value_and_grad(
        functools.partial(JT.loss_fn, cfg=jcfg), has_aux=True))


@pytest.mark.parametrize("arch_id", ARCHS)
def test_loss_and_gradients_match_jax(arch_id):
    jcfg, tcfg, np_params = pair(arch_id)
    batch = numpy_batch(jcfg.vocab, seed=1)
    (jl, jm), jg = jax_grad_fn(arch_id)(
        jax.tree.map(jnp.asarray, np_params),
        jax.tree.map(jnp.asarray, batch))
    tl, tm, tg = value_and_grad(functools.partial(T.loss_fn, cfg=tcfg),
                                convert.params_from_reference(np_params,
                                                              device="cpu"),
                                _t(batch))
    np.testing.assert_allclose(float(tl), float(jl), **GRAD_TOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **GRAD_TOL)
    if tcfg.is_moe:
        assert float(tm["aux"]) > 0
    jg = _jleaves(jg)
    assert len(tg) == len(jg)
    for g, w in zip(tg, jg):
        assert_leaf_close(g.numpy(), w)


@functools.lru_cache(maxsize=None)
def steps(arch_id, name):
    """The JAX package's jitted train step and the port's for one smoke
    config and optimizer (accumulation over min(accum, 2) microbatches,
    clip 1.0), and the two optimizers."""
    jcfg, tcfg, _ = pair(arch_id)
    accum = min(_jax_lm(arch_id).accum, 2)
    jopt, topt = JO.get_optimizer(name), TO.get_optimizer(name)
    jstep = jax.jit(j_train_step(functools.partial(JT.loss_fn, cfg=jcfg),
                                 jopt, accum_steps=accum))
    tstep = make_train_step(functools.partial(T.loss_fn, cfg=tcfg), topt,
                            accum_steps=accum)
    return jstep, tstep, jopt, topt


@pytest.mark.parametrize("arch_id,after_step,floor,norm_floor", [
    ("granite-3-2b", False, 1e-4, 1e-4), ("dbrx-132b", True, 5e-4, 2e-4)])
def test_each_package_sits_near_fp64(arch_id, after_step, floor, norm_floor):
    """The tolerances' ground: each package's fp32 gradients against the
    port's fp64 gradients of the same model and batch (granite-3-2b at its
    draw; dbrx-132b after one JAX Adafactor step), every leaf within
    ``floor`` of its largest magnitude and the global norm within
    ``norm_floor`` of the fp64 norm, for both packages alike."""
    jcfg, tcfg, np_params = pair(arch_id)
    if after_step:
        jstep, _, jopt, _ = steps(arch_id, _jax_lm(arch_id).optimizer)
        jp = jax.tree.map(jnp.asarray, np_params)
        jp, _, _ = jstep(jp, jopt.init(jp), jax.tree.map(
            jnp.asarray, numpy_batch(jcfg.vocab, seed=10)), jnp.float32(1e-3))
        np_params = jax.tree.map(np.asarray, jp)
    batch = numpy_batch(jcfg.vocab, seed=11)
    _, jg = jax_grad_fn(arch_id)(jax.tree.map(jnp.asarray, np_params),
                                 jax.tree.map(jnp.asarray, batch))
    _, _, tg = value_and_grad(functools.partial(T.loss_fn, cfg=tcfg),
                              convert.params_from_reference(np_params,
                                                            device="cpu"),
                              _t(batch))
    cfg64 = dataclasses.replace(tcfg, compute_dtype=torch.float64,
                                param_dtype=torch.float64)
    p64 = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float64)),
                       np_params)
    _, _, g64 = value_and_grad(functools.partial(T.loss_fn, cfg=cfg64), p64,
                               _t(batch))
    exact = [g.numpy() for g in g64]
    norm = np.sqrt(sum((g ** 2).sum() for g in exact))
    for side in ([g.numpy() for g in tg], _jleaves(jg)):
        for g, e in zip(side, exact):
            scale = np.abs(e).max()
            assert np.abs(g - e).max() <= floor * scale
        side_norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                for g in side))
        assert abs(side_norm - norm) <= norm_floor * norm


STEP_CASES = [(a, _jax_lm(a).optimizer) for a in ARCHS]


@pytest.mark.parametrize("arch_id,name", STEP_CASES,
                         ids=[f"{a}-{o}" for a, o in STEP_CASES])
def test_train_steps_match_jax(arch_id, name):
    """Two steps of the arch's smoke train cell (its own optimizer; SGD's
    whole step is held in ``test_training_checkpoints_cross_packages``
    and on the quadratic in ``tests/test_torch_trainer.py``) on two
    batches: the loss, ``grad_norm``, optimizer state
    and parameters after each. Step 2 starts both sides from the JAX
    package's state after step 1, carried across by ``convert``: MoE
    routing is discrete, and the packages' last-bit differences after one
    step can flip a near-tied top-k choice (dbrx-132b's ``grad_norm`` came
    out 8.5e-4 apart at step 2 with each side going on from its own step
    1)."""
    jcfg, tcfg, np_params = pair(arch_id)
    jstep, tstep, jopt, topt = steps(arch_id, name)
    jp = jax.tree.map(jnp.asarray, np_params)
    js = jopt.init(jp)
    tp = convert.params_from_reference(np_params, device="cpu")
    ts = topt.init(tp)
    for i in range(2):
        if i:
            tp = convert.params_from_reference(jax.tree.map(np.asarray, jp),
                                               device="cpu")
            ts = convert.opt_state_from_reference(
                jax.tree.map(np.asarray, js), device="cpu")
        before = _jleaves(jp)
        batch = numpy_batch(jcfg.vocab, seed=10 + i)
        # the gradient entries too small for a step's move to be compared
        _, _, g = value_and_grad(functools.partial(T.loss_fn, cfg=tcfg),
                                 tp, _t(batch))
        tiny = [np.abs(x.numpy()) <= 1e-5 for x in g]
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, batch),
                           jnp.float32(1e-3))
        tp, ts, tm = tstep(tp, ts, _t(batch), 1e-3)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **GRAD_TOL, err_msg=f"loss step {i}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=5e-4,
                                   err_msg=f"grad_norm step {i}")
        for a, b in zip(_leaves(ts), _jleaves(js)):
            assert_leaf_close(a, b, f"state step {i}", tol=1e-3)
        for a, b, p0, t in zip(_leaves(tp), _jleaves(jp), before, tiny):
            assert_moved_alike(a, b, p0, 1e-3, name != "sgd",
                               ~t if name != "sgd" else slice(None),
                               f"params step {i}")


def bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    a = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def test_bf16_train_step_matches_jax():
    """One step of command-r-plus-104b's smoke cell with its own bf16
    parameters (Adafactor, 2 microbatches accumulated in bf16) and a clip
    of 0.1 that binds: the clipped gradients reach the update in fp32 on
    both sides. Loss rtol 1e-4, ``grad_norm`` 5e-4; the factored moments
    rtol 1e-2: each package rounds its fp32 gradient to bf16, and sums in
    other orders can round an entry to the neighbouring bf16 value (2^-8
    of it), which moves its square by 2^-7 and a mean of such
    non-negative squares by at most as much, the clip's scale (within
    5e-4) adding 1e-3, and entries small against the leaf take the
    fp32 gradients' differences (1e-3 of the leaf's largest); each
    parameter's move within 2^-6 of itself plus one bf16 ulp of the
    result (its rounding): the accumulated gradient is the bf16 sum of
    two bf16 microbatch gradients, each of which may round to the
    neighbouring value (2^-8 of it), and the sum rounds once more."""
    arch_id = "command-r-plus-104b"
    jcfg, tcfg, np_params = pair(arch_id)
    jcfg = dataclasses.replace(jcfg, param_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, param_dtype=torch.bfloat16)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), np_params)
    np16 = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    tparams = jax.tree.map(
        lambda a: torch.from_numpy(a).to(torch.bfloat16), np16)
    jopt, topt = JO.adafactor(), TO.adafactor()
    kw = dict(accum_steps=2, clip_norm=0.1)
    batch = numpy_batch(jcfg.vocab, seed=12)
    jp, js, jm = jax.jit(j_train_step(
        functools.partial(JT.loss_fn, cfg=jcfg), jopt, **kw))(
        jparams, jopt.init(jparams), jax.tree.map(jnp.asarray, batch),
        jnp.float32(1e-3))
    tp, ts, tm = make_train_step(functools.partial(T.loss_fn, cfg=tcfg),
                                 topt, **kw)(tparams, topt.init(tparams),
                                             _t(batch), 1e-3)
    assert float(jm["grad_norm"]) > 1.0
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               **GRAD_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=5e-4)
    for a, b in zip(_leaves(ts), _jleaves(js)):
        np.testing.assert_allclose(a, b, rtol=1e-2,
                                   atol=1e-3 * float(np.abs(b).max()),
                                   err_msg="state")
    for a, b, p0 in zip(TO.tree_leaves(tp), jax.tree.leaves(jp),
                        jax.tree.leaves(np16)):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        got, want = a.float().numpy(), np.asarray(b, np.float32)
        bound = 2.0 ** -6 * np.abs(want - p0) + bf16_ulp(want)
        assert (np.abs(got - want) <= bound).all()


def test_fused_ce_matches_naive_and_jax():
    """Chunks of 8 against the full logits, in value and gradient (both in
    x and lm_head), and against the JAX package's ``fused_ce_loss``."""
    rng = np.random.default_rng(2)
    V, n_valid, D = 128, 97, 16
    x = rng.normal(size=(2, 32, D)).astype(np.float32)
    w = rng.normal(size=(D, V)).astype(np.float32)
    labels = rng.integers(0, n_valid, (2, 32)).astype(np.int32)

    def naive(x, w):
        logits = x @ w
        logits = logits.masked_fill(torch.arange(V) >= n_valid, -np.inf)
        lse = torch.logsumexp(logits, -1)
        return TC.cross_entropy(logits, torch.from_numpy(labels)), \
            (lse * lse).mean() * 1e-4

    xs = [torch.from_numpy(x).requires_grad_() for _ in range(2)]
    ws = [torch.from_numpy(w).requires_grad_() for _ in range(2)]
    ce, zl = TC.fused_ce_loss(xs[0], ws[0], torch.from_numpy(labels),
                              n_valid_vocab=n_valid, z_loss=1e-4, chunk=8)
    ce2, zl2 = naive(xs[1], ws[1])
    (ce + zl).backward()
    (ce2 + zl2).backward()
    np.testing.assert_allclose(ce.item(), ce2.item(), rtol=1e-6)
    np.testing.assert_allclose(zl.item(), zl2.item(), rtol=1e-6)
    for a, b in ((xs[0].grad, xs[1].grad), (ws[0].grad, ws[1].grad)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)
    jce, jzl = JC.fused_ce_loss(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(labels), n_valid_vocab=n_valid,
                                z_loss=1e-4, chunk=8)
    np.testing.assert_allclose(ce.item(), float(jce), rtol=1e-6)
    np.testing.assert_allclose(zl.item(), float(jzl), rtol=1e-6)


@pytest.mark.parametrize("arch_id", ["granite-3-2b", "dbrx-132b"])
def test_remat_is_bit_equal_to_no_remat(arch_id):
    _, tcfg, np_params = pair(arch_id)
    batch = _t(numpy_batch(tcfg.vocab, seed=3))
    params = convert.params_from_reference(np_params, device="cpu")
    out = []
    for remat in ("full", "none"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        out.append(value_and_grad(functools.partial(T.loss_fn, cfg=cfg),
                                  params, batch))
    (l1, _, g1), (l2, _, g2) = out
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_forward_matches_jax():
    """``forward``'s logits and aux loss (dbrx's sort dispatch)."""
    jcfg, tcfg, np_params = pair("dbrx-132b")
    tokens = numpy_batch(jcfg.vocab, seed=4)["tokens"]
    jl, ja = JT.forward(jax.tree.map(jnp.asarray, np_params),
                        jnp.asarray(tokens), jcfg)
    with torch.no_grad():
        tl, ta = T.forward(convert.params_from_reference(np_params,
                                                         device="cpu"),
                           torch.from_numpy(tokens), tcfg)
    assert_leaf_close(tl.numpy(), np.asarray(jl), "logits")
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


@pytest.mark.parametrize("arch_id,opt_name", [("granite-3-2b", "adamw"),
                                              ("command-r-plus-104b",
                                               "adafactor"),
                                              ("granite-3-2b", "sgd")])
def test_training_checkpoints_cross_packages(arch_id, opt_name, tmp_path):
    """A training state ``(params, opt_state)`` after one JAX step, written
    by the JAX package's ``CheckpointManager``, restores in the port equal
    to ``convert``'s carry of the same state; the port's state after its
    own first step, written by the port, restores in the JAX package equal
    to it; and step 2 from the carried-across state matches the JAX
    package's step 2."""
    jcfg, tcfg, np_params = pair(arch_id)
    jstep, tstep, jopt, topt = steps(arch_id, opt_name)
    b1, b2 = (numpy_batch(jcfg.vocab, seed=20 + i) for i in range(2))
    jp = jax.tree.map(jnp.asarray, np_params)
    jp, js, _ = jstep(jp, jopt.init(jp), jax.tree.map(jnp.asarray, b1),
                      jnp.float32(1e-3))
    JCkpt(str(tmp_path / "jax")).save(1, (jp, js))

    tp0 = convert.params_from_reference(np_params, device="cpu")
    template = (tp0, topt.init(tp0))
    (tp, ts), manifest = CheckpointManager(str(tmp_path / "jax")).restore(
        template)
    assert manifest["step"] == 1 and int(ts[-1] if opt_name != "sgd"
                                         else 1) == 1
    carried = (convert.params_from_reference(jax.tree.map(np.asarray, jp),
                                             device="cpu"),
               convert.opt_state_from_reference(
                   jax.tree.map(np.asarray, js), device="cpu"))
    for a, b, c in zip(_leaves((tp, ts)), _leaves(carried),
                       _jleaves((jp, js))):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)

    # step 2 on both sides from the carried-across non-zero state
    jp2, js2, jm = jstep(jp, js, jax.tree.map(jnp.asarray, b2),
                         jnp.float32(1e-3))
    tp, ts, tm = tstep(tp, ts, _t(b2), 1e-3)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               **GRAD_TOL)
    for a, b in zip(_leaves(ts), _jleaves(js2)):
        assert_leaf_close(a, b, "state", tol=1e-3)
    _, _, g2 = value_and_grad(functools.partial(T.loss_fn, cfg=tcfg),
                              carried[0], _t(b2))
    for a, b, p1, g in zip(_leaves(tp), _jleaves(jp2), _jleaves(jp), g2):
        keep = slice(None) if opt_name == "sgd" else \
            np.abs(g.numpy()) > 1e-5
        assert_moved_alike(a, b, p1, 1e-3, opt_name != "sgd", keep,
                           "step 2")

    # the port's own state, written by the port, read by the JAX package
    tp1 = convert.params_from_reference(np_params, device="cpu")
    tp1, ts1, _ = tstep(tp1, topt.init(tp1), _t(b1), 1e-3)
    CheckpointManager(str(tmp_path / "port")).save(1, (tp1, ts1))
    jp0 = jax.tree.map(jnp.asarray, np_params)
    (rp, rs), _ = JCkpt(str(tmp_path / "port")).restore(
        (jp0, jopt.init(jp0)))
    assert type(rs).__name__ == type(ts1).__name__
    for a, b in zip(_jleaves((rp, rs)), _leaves((tp1, ts1))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_flash_kernels_refuse_to_cut_the_graph():
    """The flash wrappers have no backward: with grad mode on and an input
    that requires grad they raise (naming the attention to train
    through), on the CPU as on the card; under no_grad they run."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(1, 2, 8, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 1, 8, 16)).astype(np.float32))
    lens = torch.tensor([8])
    for call in (lambda q: flash.flash_attention(q, k, k),
                 lambda q: flash.flash_decode(q[:, :, 0], k, k, lens)):
        with pytest.raises(RuntimeError, match="blocked_attention"):
            call(q.clone().requires_grad_())
        with torch.no_grad():
            call(q.clone().requires_grad_())
        call(q)


def test_train_cell_of_each_arch_steps_and_loss_falls():
    """``build_smoke("train_4k")`` of each arch: its optimizer, accum and
    lr; a few steps on one batch lower the loss."""
    for arch_id in ARCHS:
        c = get_arch(arch_id).build_smoke("train_4k", device="cpu")
        lm = _jax_lm(arch_id)
        assert (c["optimizer"].name, c["accum"], c["lr"]) == \
            (lm.optimizer, min(lm.accum, 2), 1e-3)
        assert get_arch(arch_id).TRAIN.lr == lm.lr
        losses = []
        p, s = c["params"], c["opt_state"]
        for _ in range(4):
            p, s, m = c["step"](p, s, c["batch"], 1e-2)
            losses.append(float(m["loss"]))
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
