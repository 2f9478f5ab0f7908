"""The port's flash-attention layer against the JAX package's: the wrapper's
plain versions (what a CPU tensor runs) against the JAX oracles
``attention_ref``/``decode_ref`` and the interpret-mode Pallas kernel, and
the port's plain ``blocked_attention`` against the JAX package's, at a subset
of ``tests/test_kernels.py``'s shapes. Inputs are made with numpy from a
seed and handed to both sides. Tolerance 2e-5 (fp32, the bar of
``tests/test_kernels.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ops import flash_decode as jax_decode  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_attn_ref  # noqa: E402
from repro.kernels.flash_attention.ref import decode_ref as jax_decode_ref  # noqa: E402
from repro.models.common import blocked_attention as jax_blocked  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.models.common import blocked_attention  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(B, Hq, Hkv, Sq, Skv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Hq, Sq, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Skv, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Skv, D)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,Hq,Hkv,S,D,causal", [
    (1, 2, 1, 128, 32, True), (2, 4, 2, 256, 64, True),
    (2, 4, 2, 256, 64, False), (2, 6, 2, 200, 48, True)])
def test_prefill_matches_jax(B, Hq, Hkv, S, D, causal):
    q, k, v = _qkv(B, Hq, Hkv, S, S, D, seed=S + D)
    got = ops.flash_attention(*_t(q, k, v), causal=causal).numpy()
    ref = np.asarray(jax_attn_ref(*map(jnp.asarray, (q, k, v)), causal=causal))
    np.testing.assert_allclose(got, ref, **TOL)
    pallas = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal,
                                  q_blk=128, k_blk=128, interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)


@pytest.mark.parametrize("B,Hq,Hkv,Skv,D", [(2, 4, 2, 512, 64),
                                            (3, 6, 3, 300, 64)])
def test_decode_matches_jax(B, Hq, Hkv, Skv, D):
    rng = np.random.default_rng(Skv)
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    _, k, v = _qkv(B, Hq, Hkv, 1, Skv, D, seed=Skv + 1)
    lens = rng.integers(1, Skv, B).astype(np.int32)
    got = ops.flash_decode(*_t(q, k, v, lens)).numpy()
    args = [jnp.asarray(a) for a in (q, k, v, lens)]
    np.testing.assert_allclose(got, np.asarray(jax_decode_ref(*args)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jax_decode(*args, k_blk=128, interpret=True)), **TOL)


@pytest.mark.parametrize("Sq,Skv,causal,ragged", [
    (48, 48, True, False), (20, 70, True, False), (1, 64, False, True),
    (33, 80, True, True)])
def test_blocked_attention_matches_jax(Sq, Skv, causal, ragged):
    """Causal offset Skv - Sq, the lengths mask and chunking over q."""
    B, Hq, Hkv, D = 2, 4, 2, 16
    q, k, v = _qkv(B, Hq, Hkv, Sq, Skv, D, seed=Sq * Skv)
    lens = np.array([Skv // 3, Skv], np.int32) if ragged else None
    got = blocked_attention(*_t(q, k, v), causal=causal, q_chunk=16,
                            lengths=None if lens is None else
                            torch.from_numpy(lens))
    ref = jax_blocked(*map(jnp.asarray, (q, k, v)), causal=causal,
                      q_chunk=16,
                      lengths=None if lens is None else jnp.asarray(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the kernel's plain version agrees on these rows (every row has a key)
    plain = ops.flash_attention(*_t(q, k, v), causal=causal,
                                lengths=None if lens is None else
                                torch.from_numpy(lens))
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), **TOL)


def test_rows_without_live_keys_give_zero():
    """Zero lengths (and causal rows before the first key) come out 0, as
    the Pallas kernel's ``l > 0`` guard makes them; live rows are
    untouched."""
    q, k, v = _t(*_qkv(2, 4, 2, 1, 32, 16, seed=3))
    lens = torch.tensor([0, 9], dtype=torch.int32)
    out = ops.flash_decode(q[:, :, 0], k, v, lens)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    want = ops.flash_decode(q[1:, :, 0], k[1:], v[1:], lens[1:])
    torch.testing.assert_close(out[1:], want, rtol=0, atol=0)
    q2, k2, v2 = _t(*_qkv(1, 2, 1, 40, 24, 16, seed=4))
    out = ops.flash_attention(q2, k2, v2, causal=True)   # offset -16
    assert torch.equal(out[:, :, :16], torch.zeros_like(out[:, :, :16]))
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "groups", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = _t(*_qkv(1, 4, 2, 8, 8, 16, seed=5))
    if bad == "head_dim":
        q, k, v = q[..., :8], k[..., :8], v[..., :8]
    elif bad == "dtype":
        k = k.double()
    elif bad == "groups":
        q = q[:, :3]
    else:
        q, k, v = (t.to("meta") for t in (q, k, v))
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention(q, k, v, causal=True)


def test_cpu_path_counts_no_launch():
    ops.reset_launches()
    q, k, v = _t(*_qkv(1, 2, 1, 8, 8, 16, seed=6))
    ops.flash_attention(q, k, v, causal=True)
    ops.flash_decode(q[:, :, 0], k, v, torch.tensor([8]))
    assert ops.LAUNCHES == {"prefill": 0, "decode": 0}
