"""The port's MoE FFNs against the JAX package's, in fp32 on the CPU.

One layer's parameters are drawn with numpy from a seed and handed to JAX
as they are and to the port through ``convert.params_from_reference``; the
same numpy tokens go through both ``_ffn``s (einsum and sort dispatch, with
and without arctic's dense residual), over expert counts, top k and
capacity factors that drop assignments (0.5), drop a few (1.25) or none
(8.0). The JAX package's routing is read where it computes it (its
``jax.lax.top_k``, its dispatch row function under ``jax.vmap`` and its
dispatch/combine ``jnp.einsum`` operands, recorded for the call), so the
port's ``gate_idx``, slots and kept masks are held to it bit for bit;
outputs to rtol 1e-5 / atol 1e-6, the load-balance loss to 1e-6."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from test_torch_transformer import _jax_lm_cfg, numpy_params  # noqa: E402

B, S, D, FF = 3, 16, 32, 48
OUT_TOL = dict(rtol=1e-5, atol=1e-6)


def _cfgs(E, k, cf, residual, impl):
    kw = dict(name="m", n_layers=1, d_model=D, n_heads=2, n_kv_heads=1,
              d_ff=FF, vocab=31, head_dim=16, n_experts=E, top_k=k,
              capacity_factor=cf, moe_dense_residual=residual, moe_impl=impl)
    return (JT.TransformerConfig(**kw, compute_dtype=jnp.float32,
                                 param_dtype=jnp.float32),
            T.TransformerConfig(**kw, compute_dtype=torch.float32,
                                param_dtype=torch.float32))


def _layer_params(jcfg, seed):
    """One layer's leaves of JAX's specs, layer-stacked (L = 1), each matrix
    drawn at 1/sqrt of its input dim."""
    return numpy_params(JT.param_specs(jcfg), seed, per_matrix=True)["layers"]


class Recorder:
    """What the JAX package's MoE computed on the way: its ``top_k``
    outputs, its sort dispatch's per-row (slot, keep) and its einsum
    dispatch's dispatch and combine operands."""

    def __init__(self, monkeypatch):
        self.seen = {}
        top_k, vmap, einsum = jax.lax.top_k, jax.vmap, jnp.einsum

        def rec_top_k(x, k):
            vals, idx = top_k(x, k)
            self.seen["top_k"] = (np.asarray(vals), np.asarray(idx))
            return vals, idx

        def rec_vmap(f, *a, **kw):
            g = vmap(f, *a, **kw)
            if getattr(f, "__name__", "") != "dispatch_row":
                return g

            def call(*args):
                buf, slot, keep = g(*args)
                self.seen["sort"] = (np.asarray(slot), np.asarray(keep))
                return buf, slot, keep
            return call

        def rec_einsum(sub, *ops, **kw):
            if sub == "gsec,gsd->egcd":
                self.seen["disp"] = np.asarray(ops[0])
            if sub == "gsec,egcd->gsd":
                self.seen["comb"] = np.asarray(ops[0])
            return einsum(sub, *ops, **kw)

        monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
        monkeypatch.setattr(jax, "vmap", rec_vmap)
        monkeypatch.setattr(jnp, "einsum", rec_einsum)


def _run_both(monkeypatch, E, k, cf, residual, impl, seed=0, zero_router=False):
    jcfg, tcfg = _cfgs(E, k, cf, residual, impl)
    np_lp = _layer_params(jcfg, seed)
    if zero_router:
        np_lp["router"][:] = 0.0
    x = np.random.default_rng(seed + 1).normal(size=(B, S, D)).astype(
        np.float32)
    rec = Recorder(monkeypatch)
    want, want_aux = JT._ffn(jnp.asarray(x),
                             {n: jnp.asarray(v[0]) for n, v in np_lp.items()},
                             jcfg)
    monkeypatch.undo()
    tlp = convert.params_from_reference(np_lp, device="cpu")
    xt = torch.from_numpy(x)
    got, got_aux = T._ffn(xt, tlp, 0, tcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, x=xt, tlp=tlp, seen=rec.seen,
                want=np.asarray(want), want_aux=float(want_aux), got=got,
                got_aux=float(got_aux))


def _routing(r):
    """The port's routing of the run's tokens (gate_vals, gate_idx)."""
    _, gate_vals, gate_idx = T._route(r["x"], r["tlp"]["router"][0],
                                      r["tcfg"].top_k)
    return gate_vals, gate_idx


@pytest.mark.parametrize("impl", ["einsum", "sort"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("E", [4, 8])
def test_moe_ffn_matches_jax(monkeypatch, E, k, cf, residual, impl):
    r = _run_both(monkeypatch, E, k, cf, residual, impl)
    gate_vals, gate_idx = _routing(r)
    want_vals, want_idx = r["seen"]["top_k"]
    np.testing.assert_array_equal(gate_idx.numpy(), want_idx)
    np.testing.assert_allclose(
        gate_vals.numpy(),
        want_vals / np.maximum(want_vals.sum(-1, keepdims=True), 1e-9),
        rtol=1e-6, atol=1e-7)
    if impl == "sort":
        C = T._capacity_sort(r["tcfg"], S)
        *_, slot_sk, keep_sk = T._dispatch_sort(gate_idx, E, C)
        want_slot, want_keep = r["seen"]["sort"]
        np.testing.assert_array_equal(keep_sk.numpy(), want_keep)
        np.testing.assert_array_equal(slot_sk.numpy(), want_slot)
        kept = keep_sk
    else:
        C = T._capacity_einsum(r["tcfg"], S)
        disp, comb = T._dispatch_einsum(gate_idx, gate_vals, E, C,
                                        torch.float32)
        np.testing.assert_array_equal(disp.numpy(), r["seen"]["disp"])
        np.testing.assert_array_equal(comb.numpy() != 0,
                                      r["seen"]["comb"] != 0)
        np.testing.assert_allclose(comb.numpy(), r["seen"]["comb"],
                                   rtol=1e-6, atol=1e-7)
        kept = disp.sum(-1).gather(-1, gate_idx) > 0      # (B, S, k)
    # capacity 8.0 keeps every assignment; 0.5 must drop some
    if cf == 8.0:
        assert bool(kept.all())
    if cf == 0.5 and k * S / E > 4:
        assert not bool(kept.all())
    assert r["got"].shape == (B, S, D)
    np.testing.assert_allclose(r["got"].numpy(), r["want"], **OUT_TOL)
    assert abs(r["got_aux"] - r["want_aux"]) <= 1e-6


@pytest.mark.parametrize("impl", ["einsum", "sort"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_equal_probabilities_pick_the_lower_experts(monkeypatch, impl, k):
    """A zero router makes every probability 1/E: the top k must be experts
    0..k-1 for every token, as ``jax.lax.top_k`` gives them."""
    E = 8
    r = _run_both(monkeypatch, E, k, 1.25, False, impl, zero_router=True)
    gate_vals, gate_idx = _routing(r)
    want = np.broadcast_to(np.arange(k), (B, S, k))
    np.testing.assert_array_equal(r["seen"]["top_k"][1], want)
    np.testing.assert_array_equal(gate_idx.numpy(), want)
    np.testing.assert_array_equal(gate_vals.numpy(),
                                  np.full((B, S, k), 1.0 / k, np.float32))
    np.testing.assert_allclose(r["got"].numpy(), r["want"], **OUT_TOL)
    assert abs(r["got_aux"] - r["want_aux"]) <= 1e-6


def test_equal_bf16_logits_keep_index_order():
    """Router logits rounded to bf16 tie in earnest: the stable sort keeps
    the lower expert first among equal probabilities."""
    x = torch.ones((1, 2, 4), dtype=torch.bfloat16)
    router = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 1.0]] * 4,
                          dtype=torch.bfloat16) / 4
    _, _, gate_idx = T._route(x, router, 3)
    assert gate_idx.tolist() == [[[1, 2, 4]] * 2]


@pytest.mark.parametrize("impl", ["einsum", "sort"])
def test_decode_capacity_never_drops(impl):
    """At S = 1 (decode) both formulas give C = 4 >= k, so every choice is
    kept, whatever the capacity factor."""
    for cf in (0.01, 0.5, 1.25):
        for E, k in ((4, 4), (16, 4), (128, 2)):
            _, tcfg = _cfgs(E, k, cf, False, impl)
            cap = T._capacity_einsum if impl == "einsum" else T._capacity_sort
            assert cap(tcfg, 1) == 4 >= k


def test_unknown_moe_impl_raises():
    _, tcfg = _cfgs(4, 2, 1.25, False, "megablocks")
    jcfg, _ = _cfgs(4, 2, 1.25, False, "sort")
    lp = convert.params_from_reference(_layer_params(jcfg, 0), device="cpu")
    with pytest.raises(ValueError, match="moe_impl"):
        T._ffn(torch.zeros((1, 2, D)), lp, 0, tcfg)


def test_serving_params_cast_the_expert_leaves():
    jcfg, tcfg = _cfgs(4, 2, 1.25, True, "sort")
    lp = convert.params_from_reference(_layer_params(jcfg, 0), device="cpu")
    params = {"embed": torch.zeros((128, D)), "lm_head": torch.zeros((D, 128)),
              "final_norm": torch.ones(D), "layers": lp}
    cfg16 = dataclasses.replace(tcfg, compute_dtype=torch.bfloat16)
    sp = T.serving_params(params, cfg16)["layers"]
    for name in ("router", "we_gate", "we_up", "we_down", "w_gate"):
        assert sp[name].dtype == torch.bfloat16, name
    x = torch.randn((2, 5, D), generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    a, _ = T._ffn(x, lp, 0, cfg16)
    b, _ = T._ffn(x, sp, 0, cfg16)
    assert torch.equal(a, b)


def test_params_from_reference_carries_the_moe_leaves():
    """The JAX package's own init of arctic's reduced config in bf16
    (router, experts and the dense residual): every leaf reaches the port
    in its layout and dtype, value for value."""
    from repro.configs.lm_common import smoke_config
    from repro.models.common import init_from_specs
    from repro_torch.configs import arctic_480b

    jcfg = dataclasses.replace(smoke_config(_jax_lm_cfg("arctic-480b")),
                               param_dtype=jnp.bfloat16)
    jp = jax.tree.map(np.asarray, init_from_specs(JT.param_specs(jcfg),
                                                  jax.random.PRNGKey(0)))
    tp = convert.params_from_reference(jp, device="cpu")
    for name in ("router", "we_gate", "we_up", "we_down", "w_gate", "w_up",
                 "w_down", "wq", "ln1"):
        want, got = jp["layers"][name], tp["layers"][name]
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32))
    tcfg = arctic_480b.CFG
    assert set(tp["layers"]) == set(T.param_specs(tcfg)["layers"])

