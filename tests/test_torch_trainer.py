"""The port's train step (``repro_torch.train.trainer``) and training
launcher (``repro_torch.launch.train``): accumulation over 4 microbatches
equal to the full batch; the clip's bound; AdamW's weight decay; the step
against the JAX package's ``make_train_step`` (accumulation, clip,
``grad_norm``, a ``grad_transform``) on the JAX package's quadratic; the
accumulation dtype; the clip of bf16 gradients in fp32, bit-equal to the
JAX package's; the eval step; and the launcher on the CPU for every
trainable arch, a run with an injected failure ending bit-equal, in
parameters and optimizer state, to the uninterrupted run. Tolerances:
rtol 1e-5 / atol 1e-6 (fp32 sums in other orders)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import optimizer as JO  # noqa: E402
from repro.train.trainer import make_train_step as j_train_step  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train.trainer import (  # noqa: E402
    global_norm,
    make_eval_step,
    make_train_step,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, which only
    contend with the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-6)


def _quadratic(key=0, n=16):
    """The JAX package's test problem (tests/test_optim_trainer.py) as
    numpy, and its loss on either side."""
    x = np.array(jax.random.normal(jax.random.PRNGKey(key), (64, n)))
    w_true = np.array(jax.random.normal(jax.random.PRNGKey(key + 1), (n, 1)))
    batch = {"x": x, "y": x @ w_true}

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return ((pred - batch["y"]) ** 2).mean(), {"pred0": pred[0, 0]}

    return batch, loss_fn


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_accumulation_matches_full_batch():
    """accum_steps=4 (fp32 accumulation) equals the single-batch step."""
    batch, loss_fn = _quadratic()
    opt = TO.sgd(momentum=0.0)
    s1 = make_train_step(loss_fn, opt, accum_steps=1, clip_norm=None)
    s4 = make_train_step(loss_fn, opt, accum_steps=4, clip_norm=None,
                         accum_dtype=torch.float32)
    p1, p4 = {"w": torch.zeros((16, 1))}, {"w": torch.zeros((16, 1))}
    _, _, m1 = s1(p1, opt.init(p1), _t(batch), 0.1)
    _, _, m4 = s4(p4, opt.init(p4), _t(batch), 0.1)
    np.testing.assert_allclose(p1["w"].numpy(), p4["w"].numpy(), **TOL)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(loss_fn, opt, accum_steps=3)(
            p4, opt.init(p4), _t(batch), 0.1)


def test_grad_clipping_bounds_update():
    batch, loss_fn = _quadratic(key=5)
    big = {"x": batch["x"] * 100, "y": batch["y"] * 100}
    opt = TO.sgd(momentum=0.0)
    step = make_train_step(loss_fn, opt, clip_norm=1.0)
    p = {"w": torch.zeros((16, 1))}
    p, _, m = step(p, opt.init(p), _t(big), 1.0)
    assert float(m["grad_norm"]) > 1.0
    assert float(p["w"].abs().max()) <= 1.0 + 1e-5   # lr * clipped norm
    np.testing.assert_allclose(float(torch.linalg.vector_norm(p["w"])), 1.0,
                               rtol=1e-5)


def test_adamw_weight_decay_shrinks():
    p = {"w": torch.ones((4, 4)) * 10}
    opt = TO.adamw(weight_decay=0.1)
    opt.update({"w": torch.zeros((4, 4))}, opt.init(p), p, 0.1)
    assert float(p["w"][0, 0]) < 10.0
    np.testing.assert_allclose(p["w"].numpy(), 10.0 - 0.1 * 0.1 * 10.0,
                               rtol=1e-6)


@pytest.mark.parametrize("name,accum,clip", [
    ("adamw", 2, 1.0), ("sgd", 4, 0.5), ("adafactor", 1, None)])
def test_train_step_matches_jax(name, accum, clip):
    """Three steps on the quadratic (scaled so the clip binds) with a
    ``grad_transform`` that halves the gradients: loss, ``grad_norm``, the
    last microbatch's metric and the parameters after each."""
    batch, loss_fn = _quadratic(key=2)
    batch = {"x": batch["x"] * 3, "y": batch["y"] * 3}
    jopt, topt = JO.get_optimizer(name), TO.get_optimizer(name)

    def half(grads, state):
        return {k: v * 0.5 for k, v in grads.items()}, state

    jstep = jax.jit(j_train_step(loss_fn, jopt, accum_steps=accum,
                                 clip_norm=clip, grad_transform=half))
    tstep = make_train_step(loss_fn, topt, accum_steps=accum,
                            clip_norm=clip, grad_transform=half)
    jp = {"w": jnp.full((16, 1), 0.1)}
    js = jopt.init(jp)
    tp = {"w": torch.full((16, 1), 0.1)}
    ts = topt.init(tp)
    for _ in range(3):
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, batch),
                           jnp.float32(0.01))
        tp, ts, tm = tstep(tp, ts, _t(batch), 0.01)
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL,
                                       err_msg=k)
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                                   **TOL)


def test_accumulation_dtype_follows_params_unless_named():
    """bf16 parameters accumulate their gradients in bf16 by default (the
    JAX package's None), in fp32 when asked; the update keeps bf16. No
    clip, so the ``grad_transform`` sees the accumulated gradients."""
    batch, loss_fn = _quadratic(key=3)
    opt = TO.sgd(momentum=0.0)
    seen = []

    def spy(grads, state):
        seen.append(grads["w"].dtype)
        return grads, state

    for adt in (None, torch.float32):
        p = {"w": torch.zeros((16, 1), dtype=torch.bfloat16)}
        step = make_train_step(
            lambda p, b: loss_fn({"w": p["w"].float()}, b), opt,
            accum_steps=2, accum_dtype=adt, grad_transform=spy,
            clip_norm=None)
        step(p, opt.init(p), _t(batch), 0.1)
        assert p["w"].dtype == torch.bfloat16 and p["w"].abs().sum() > 0
    assert seen == [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("transform", [False, True])
def test_clip_scales_bf16_gradients_in_fp32_as_jax(transform):
    """bf16 parameters and a clip that binds: the clipped gradient is
    ``g * scale`` in fp32, as the JAX package's promotion gives it, not
    rounded back to bf16. Integer data over 64 rows make both packages'
    bf16 gradients and norms exact, so SGD's momentum after one step
    (the clipped gradient itself) and the parameters are bit-equal to
    the JAX package's; with a ``grad_transform``, it sees fp32 gradients
    on both sides."""
    rng = np.random.default_rng(7)
    x = rng.integers(-1, 2, (64, 16)).astype(np.float32)
    batch = {"x": x, "y": rng.integers(-2, 3, (64, 1)).astype(np.float32)}

    def loss_fn(up):
        def fn(params, batch):
            pred = batch["x"] @ up(params["w"])
            return ((pred - batch["y"]) ** 2).mean(), {}
        return fn

    seen = []

    def spy(grads, state):
        seen.append(str(grads["w"].dtype).split(".")[-1])
        return grads, state

    kw = dict(accum_steps=2, clip_norm=0.1,
              grad_transform=spy if transform else None)
    jopt, topt = JO.sgd(), TO.sgd()
    jp = {"w": jnp.zeros((16, 1), jnp.bfloat16)}
    jp, js, jm = jax.jit(j_train_step(
        loss_fn(lambda w: w.astype(jnp.float32)), jopt, **kw))(
        jp, jopt.init(jp), jax.tree.map(jnp.asarray, batch),
        jnp.float32(0.5))
    tp = {"w": torch.zeros((16, 1), dtype=torch.bfloat16)}
    tp, ts, tm = make_train_step(loss_fn(lambda w: w.float()), topt, **kw)(
        tp, topt.init(tp), _t(batch), 0.5)
    assert float(jm["grad_norm"]) > 1.0
    assert float(tm["grad_norm"]) == float(jm["grad_norm"])
    assert ts["w"].dtype == torch.float32
    np.testing.assert_array_equal(ts["w"].numpy(), np.asarray(js["w"]))
    # the JAX package's scaled gradient is not a bf16 value
    assert not np.array_equal(
        np.asarray(js["w"]),
        np.asarray(js["w"].astype(jnp.bfloat16).astype(jnp.float32)))
    assert tp["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["w"].float().numpy(),
                                  np.asarray(jp["w"], np.float32))
    assert seen == (["float32", "float32"] if transform else [])


def test_global_norm_and_eval_step():
    g = [torch.full((3, 4), 2.0), torch.full((5,), -1.0)]
    np.testing.assert_allclose(float(global_norm(g)), np.sqrt(48 + 5),
                               rtol=1e-6)
    batch, loss_fn = _quadratic()
    m = make_eval_step(loss_fn)({"w": torch.zeros((16, 1))}, _t(batch))
    np.testing.assert_allclose(float(m["loss"]),
                               float((batch["y"] ** 2).mean()), rtol=1e-5)
    assert "pred0" in m


TRAIN_ARCHS = ["granite-3-2b", "internlm2-1.8b", "command-r-plus-104b",
               "arctic-480b", "dbrx-132b", "dien"]


@pytest.mark.parametrize("arch_id", TRAIN_ARCHS)
def test_launcher_replay_after_failure_is_exact(arch_id, tmp_path):
    """Four steps with a checkpoint every 2 and a node failure injected at
    step 3 (restore step 2, replay from there: step 2 runs twice) end
    bit-equal, in parameters and optimizer state, to four uninterrupted
    steps."""
    runs = []
    for fail_at in (None, 3):
        state, report, shape = launcher.train(
            arch_id, steps=4, lr=1e-3, ckpt_dir=str(tmp_path / str(fail_at)),
            ckpt_every=2, fail_at=fail_at, device="cpu")
        runs.append((TO.tree_leaves(state), report))
    (a, ra), (b, rb) = runs
    assert ra.restarts == 0 and rb.restarts == 1
    assert rb.steps_run == ra.steps_run + 1
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert shape == ("train_batch" if arch_id == "dien" else "train_4k")


def test_launcher_main_prints_the_run(capsys):
    assert launcher.main(["--arch", "granite-3-2b", "--smoke", "--steps",
                          "4", "--ckpt-every", "2", "--fail-at", "3",
                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "arch=granite-3-2b shape=train_4k steps=5 restarts=1 ckpts=2" \
        in out and "steps/s on cpu" in out and "loss curve:" in out
    with pytest.raises(SystemExit):
        launcher.main(["--arch", "granite-3-2b", "--device", "cpu"])


def test_batches_are_a_function_of_the_step():
    b0 = {"tokens": torch.randint(0, 50, (2, 8)),
          "mask": torch.zeros((2, 8), dtype=torch.bool),
          "x": torch.zeros((2, 3))}
    make = launcher.batch_maker(b0)
    a, b, c = make(4), make(4), make(5)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tokens"], c["tokens"])
    assert a["mask"].all() and int(a["tokens"].max()) < 50
