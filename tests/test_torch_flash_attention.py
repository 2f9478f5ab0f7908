"""The port's flash-attention layer against the JAX package's: the wrapper's
plain versions (what a CPU tensor runs) against the JAX oracles
``attention_ref``/``decode_ref`` and the interpret-mode Pallas kernel, and
the port's plain ``blocked_attention`` against the JAX package's, at a subset
of ``tests/test_kernels.py``'s shapes. Inputs are made with numpy from a
seed and handed to both sides. Tolerance 2e-5 (fp32, the bar of
``tests/test_kernels.py``)."""
import inspect

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
    assert ops.LAUNCHES == {"prefill": 0, "prefill_wgmma": 0, "decode": 0}


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.bfloat16, 48, "simt"),
    (torch.float32, 16, "simt"), (torch.float32, 32, "simt"),
    (torch.float32, 48, "simt"), (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt")])
def test_prefill_variant_choice(dtype, d, want):
    """The prefill kernel is a function of (dtype, head dim) alone: bf16 at
    granite's 64 and internlm2's 128 goes to the tensor cores, fp32 keeps
    full fp32 products on the CUDA cores, and every head dim has a kernel."""
    assert d in ops.HEAD_DIMS
    assert ops.prefill_variant(dtype, d) == want


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 128),
                                     (torch.float32, 64)])
def test_cpu_path_counts_no_launch_of_either_prefill_variant(dtype, d):
    """CPU tensors run the plain version whichever kernel their dtype and
    head dim would pick on the card, and count no launch of it."""
    ops.reset_launches()
    q, k, v = (t.to(dtype) for t in _t(*_qkv(1, 4, 2, 24, 24, d, seed=d)))
    out = ops.flash_attention(q, k, v, causal=True)
    assert out.dtype == dtype and out.shape == q.shape
    assert ops.LAUNCHES == {"prefill": 0, "prefill_wgmma": 0, "decode": 0}


def _bf16(a):
    """numpy fp32 values rounded to the nearest bf16 (as the card's bf16
    inputs hold them), kept in fp32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _attention_p_rounded(q, k, v, p_dtype=torch.bfloat16, causal=True):
    """``attention_ref`` as a tensor-core kernel computes it: fp32 scores,
    max and sum, the probabilities rounded to ``p_dtype`` (bf16 on the
    kernel) before P.V, the output rounded to bf16."""
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, Sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k) / np.sqrt(d)
    if causal:
        live = torch.arange(Sq)[:, None] + (Skv - Sq) >= torch.arange(Skv)
        s = s.masked_fill(~live, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bhgqk,bhkd->bhgqd", p.to(p_dtype).float(), v)
    out = out / p.sum(-1, keepdim=True)
    return out.reshape(B, Hq, Sq, d).bfloat16().float()


def test_bf16_probabilities_motivate_the_tensor_core_tolerance():
    """The tensor-core prefill rounds P to bf16 before P.V. At a granite-like
    shape (S 512, d 64, G 4) on bf16 inputs that rounding alone breaks the
    old elementwise bar (rtol 4e-3, atol 1e-5: one bf16 rounding of the
    output) on outputs near 0, and stays inside the new one (rtol 4e-3, atol
    2^-8 max|want|) against the exact fp32 reference (the JAX package's)."""
    q, k, v = (_bf16(a) for a in _qkv(1, 8, 2, 512, 512, 64, seed=13))
    want = np.array(jax_attn_ref(*map(jnp.asarray, (q, k, v)), causal=True))
    got = _attention_p_rounded(*_t(q, k, v)).numpy()
    atol = 2.0 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=4e-3, atol=atol)
    assert (np.abs(got - want) > 1e-5 + 4e-3 * np.abs(want)).any()
    # rounding only the output (the CUDA-core kernel's numerics) keeps the
    # old bar
    out_only = torch.from_numpy(want).bfloat16().float().numpy()
    np.testing.assert_allclose(out_only, want, rtol=4e-3, atol=1e-5)


@pytest.mark.parametrize("p_dtype,inside", [
    (torch.bfloat16, True), (torch.float16, True),
    (torch.float8_e4m3fn, False)])
def test_sdpa_floor_rejects_coarser_probabilities(p_dtype, inside):
    """The tensor-core prefill's max abs and normwise errors against the
    exact fp32 reference are held to at most twice SDPA's on the same bf16
    inputs. P rounded to bf16 (the kernel's numerics) or finer stays inside
    both limits; P rounded to e4m3 (3 mantissa bits) breaks them, the
    normwise one above all, which the many small outputs of the late causal
    rows set (S 512, d 64, G 4)."""
    q, k, v = (_bf16(a) for a in _qkv(1, 8, 2, 512, 512, 64, seed=17))
    want = np.array(jax_attn_ref(*map(jnp.asarray, (q, k, v)), causal=True))
    qt, kt, vt = (t.bfloat16() for t in _t(q, k, v))
    floor = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True).float().numpy() - want
    got = _attention_p_rounded(*_t(q, k, v), p_dtype=p_dtype).numpy() - want
    l2 = np.linalg.norm(got) / np.linalg.norm(want)
    l2_floor = np.linalg.norm(floor) / np.linalg.norm(want)
    assert (l2 <= 2 * l2_floor) == inside
    assert (np.abs(got).max() <= 2 * np.abs(floor).max()) == inside


def _split_decode(q, k, v, lengths, chunk):
    """The decode kernel's split-KV algorithm in plain PyTorch (fp32): each
    chunk of ``chunk`` keys gives its partial (m, l, acc), and a row's
    chunks are merged in chunk order; a row with no live key gives 0."""
    B, Hq, d = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    out = torch.zeros((B, Hq, d))
    for b in range(B):
        n = int(min(max(int(lengths[b]), 0), k.shape[2]))
        for hq in range(Hq):
            kk, vv = k[b, hq // G], v[b, hq // G]
            parts = []
            for c0 in range(0, n, chunk):
                s = kk[c0:min(c0 + chunk, n)] @ q[b, hq] / np.sqrt(d)
                m = s.max()
                p = torch.exp(s - m)
                parts.append((m, p.sum(), p @ vv[c0:min(c0 + chunk, n)]))
            if not parts:
                continue
            M = max(m for m, _, _ in parts)
            L, O = torch.tensor(0.0), torch.zeros(d)
            for m, l, acc in parts:
                L = L + l * torch.exp(m - M)
                O = O + acc * torch.exp(m - M)
            out[b, hq] = O / L
    return out


@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2), (8, 2)])
def test_split_kv_decode_matches_jax(Hq, Hkv):
    """Split KV with the wrapper's own chunk for a 600-row cache (256):
    lengths 0, 1, a chunk boundary and one past it either side, and the
    whole cache, at GQA groups 1, 2 and 4. The chunked merge equals the
    port's plain version and, on rows with a live key, the JAX package's
    ``decode_ref`` (2e-5, fp32)."""
    S, d = 600, 32
    chunk, n_chunks = ops.decode_split(S)
    assert (chunk, n_chunks) == (256, 3)
    lens = np.array([0, 1, chunk - 1, chunk, chunk + 1, 2 * chunk + 1, S],
                    np.int32)
    B = lens.size
    rng = np.random.default_rng(Hq * 10 + Hkv)
    q = rng.normal(size=(B, Hq, d)).astype(np.float32)
    _, k, v = _qkv(B, Hq, Hkv, 1, S, d, seed=S + Hq)
    got = _split_decode(*_t(q, k, v, lens), chunk)
    plain = ops.flash_decode(*_t(q, k, v, lens))
    torch.testing.assert_close(got, plain, **TOL)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    ref = np.asarray(jax_decode_ref(*map(jnp.asarray, (q, k, v, lens))))
    np.testing.assert_allclose(got.numpy()[1:], ref[1:], **TOL)


@pytest.mark.parametrize("S", [0, 1, 255, 256, 257, 2080, 16384, 16385,
                               32768, 65536, 100_000])
def test_decode_split_gives_each_live_key_one_item(S):
    """The decode kernel's work items, (chunk c, kv head, batch row) for c
    below ``n_chunks``, come from the cache's row count alone: the wrapper
    passes ``decode_split(S)`` and never reads ``lengths``. Every live key
    of any length up to S falls in exactly one item, the chunk is a
    multiple of the kernel's 16-key sub-tile in 256..1,024, and no chunk
    lies wholly past the cache."""
    assert list(inspect.signature(ops.decode_split).parameters) == ["S"]
    chunk, n_chunks = ops.decode_split(S)
    assert chunk % 16 == 0 and 256 <= chunk <= 1024
    assert n_chunks == max(1, -(-S // chunk))
    for n in sorted({0, 1, S // 3, max(S - 1, 0), S}):
        hits = np.zeros(n, np.int64)
        for c in range(n_chunks):
            lo, hi = c * chunk, min((c + 1) * chunk, n)
            hits[lo:hi] += 1
        assert (hits == 1).all()
