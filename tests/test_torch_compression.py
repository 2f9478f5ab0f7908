"""The port's int8 gradient compression against the JAX package's:
``quantize_int8`` and 50 steps of ``compress_with_feedback`` bit-equal on
seeded inputs; ``compressed_all_reduce`` on a gloo group of world size 1
equal to ``compressed_psum`` under ``shard_map`` on a one-device mesh; and
the JAX package's own compression tests, mirrored (with the port's SGD)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.distributed import compression as JC  # noqa: E402
from repro_torch.distributed import compression as PC  # noqa: E402
from repro_torch.train.optimizer import get_optimizer  # noqa: E402


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(257).astype(np.float32),
            (rng.standard_normal((64, 33)) * 1e-3).astype(np.float32),
            (rng.standard_normal(1000) * 50).astype(np.float32),
            # exact halves of the scale: round half to even on both sides
            np.array([-127.0, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 127.0],
                     np.float32),
            np.zeros(5, np.float32)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_int8_bit_equal(seed):
    for x in _inputs(seed):
        qj, sj = JC.quantize_int8(jnp.asarray(x))
        qp, sp = PC.quantize_int8(torch.from_numpy(x))
        assert qp.dtype == torch.int8
        np.testing.assert_array_equal(qp.numpy(), np.asarray(qj))
        assert sp.item() == float(sj)
        np.testing.assert_array_equal(
            PC.dequantize_int8(qp, sp).numpy(),
            np.asarray(JC.dequantize_int8(qj, sj)))


def test_compress_with_feedback_50_steps_bit_equal():
    rng = np.random.default_rng(7)
    grads = [{"w": (rng.standard_normal((32, 16)) * 0.01).astype(np.float32),
              "n": {"b": rng.standard_normal(40).astype(np.float32)}}
             for _ in range(50)]
    to_j = lambda t: jax.tree.map(jnp.asarray, t)
    to_p = lambda t: {k: to_p(v) for k, v in t.items()} \
        if isinstance(t, dict) else torch.from_numpy(t)
    ej, ep = JC.init_error_state(to_j(grads[0])), \
        PC.init_error_state(to_p(grads[0]))
    for g in grads:
        cj, ej = JC.compress_with_feedback(to_j(g), ej)
        cp, ep = PC.compress_with_feedback(to_p(g), ep)
        for a, b in ((cp["w"], cj["w"]), (cp["n"]["b"], cj["n"]["b"]),
                     (ep["w"], ej["w"]), (ep["n"]["b"], ej["n"]["b"])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_compressed_all_reduce_equals_jax_psum(tmp_path):
    import torch.distributed as dist
    from jax.sharding import Mesh, PartitionSpec as Pspec

    x = (np.random.default_rng(3).standard_normal(300) * 3).astype(
        np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("x",))
    want = jax.shard_map(lambda v: JC.compressed_psum(v, "x"), mesh=mesh,
                         in_specs=Pspec("x"), out_specs=Pspec("x"))(
        jnp.asarray(x))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        got = PC.compressed_all_reduce(torch.from_numpy(x))
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------- tests/test_distributed.py, mirrored
def test_quantize_roundtrip_error_bound():
    x = torch.from_numpy(
        np.random.default_rng(0).normal(size=(256,)).astype(np.float32))
    q, s = PC.quantize_int8(x)
    err = (PC.dequantize_int8(q, s) - x).abs().max()
    assert float(err) <= float(s) / 2 + 1e-7


def test_error_feedback_unbiased_over_steps():
    """With error feedback the sum of the compressed grads tracks the sum
    of the true grads (the residual stays bounded)."""
    rng = np.random.default_rng(1)
    g_true = [torch.from_numpy(rng.normal(size=(64,)).astype(np.float32)
                               * 0.01) for _ in range(50)]
    err = PC.init_error_state({"g": g_true[0]})
    acc_c = torch.zeros(64)
    for g in g_true:
        cg, err = PC.compress_with_feedback({"g": g}, err)
        acc_c = acc_c + cg["g"]
    acc_t = sum(g_true[1:], g_true[0])
    resid = float((acc_c - acc_t).abs().max())
    # the residual equals the last carried error, within one step
    assert resid <= float(err["g"].abs().max()) + 1e-6


def test_compressed_training_converges():
    opt = get_optimizer("sgd", momentum=0.0)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((128, 8), generator=gen)
    w_true = torch.arange(8.0)[:, None] / 4
    y = x @ w_true
    params = {"w": torch.zeros((8, 1))}
    err = PC.init_error_state(params)
    opt_state = opt.init(params)
    for _ in range(300):
        w = params["w"].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(((x @ w - y) ** 2).mean(), [w])
        cg, err = PC.compress_with_feedback({"w": g}, err)
        params, opt_state = opt.update(cg, opt_state, params, 0.05)
    assert float((params["w"] - w_true).abs().max()) < 1e-2
