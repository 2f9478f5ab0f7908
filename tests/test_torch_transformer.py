"""The port's transformer serve path against the JAX package's, on the
reduced (smoke) configurations of granite-3-2b and internlm2-1.8b in fp32:
parameters drawn with numpy from a seed, handed to JAX as they are and to
the port through ``convert.params_from_reference``,
``prefill`` logits and KV cache, then four ``decode_step``s with ragged
lengths (logits and greedy tokens). The port's attention runs the flash
wrapper, whose CPU path is the kernel's plain version. Tolerance 1e-4."""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.lm_common import smoke_config as jax_smoke  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.lm_common import smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import blocked_attention, init_from_specs  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["granite-3-2b", "internlm2-1.8b"]
B, S, S_MAX, STEPS = 3, 12, 20, 4


def _cfg_of(arch_module):
    """The full TransformerConfig of one of the JAX package's arch modules:
    the LMArch its ``build_smoke`` closes over."""
    return arch_module.ARCH.build_smoke.__closure__[0].cell_contents.cfg


def _jax_lm_cfg(arch_id):
    return _cfg_of(importlib.import_module(
        "repro.configs." + arch_id.replace("-", "_").replace(".", "_")))


def _port_lm_cfg(arch_id):
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_")).CFG


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX cfg, port cfg, JAX params, port params) of one smoke config."""
    jcfg = jax_smoke(_jax_lm_cfg(request.param))
    tcfg = smoke_config(_port_lm_cfg(request.param))
    np_params = numpy_params(JT.param_specs(jcfg), seed=0)
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = convert.params_from_reference(np_params, device="cpu")
    return jcfg, tcfg, jparams, tparams


def numpy_params(specs, seed):
    """A parameter tree of the JAX package's specs drawn with numpy by the
    fan-in rule of ``init_from_specs`` (handed to both sides)."""
    rng = np.random.default_rng(seed)

    def draw(s):
        fan_in = s.shape[0] if len(s.shape) > 1 else max(1, s.shape[-1])
        return (rng.normal(size=s.shape) * s.init_scale
                / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree.map(draw, specs, is_leaf=lambda x: hasattr(x,
                                                                 "init_scale"))


def test_configs_agree_with_jax():
    for a in ARCHS:
        j, t = _jax_lm_cfg(a), _port_lm_cfg(a)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab", "head_dim", "rope_base", "n_experts",
                  "vocab_pad_to"):
            assert getattr(j, f) == getattr(t, f), (a, f)
        assert t.compute_dtype == torch.bfloat16
        assert t.param_dtype == torch.float32


def test_param_specs_match_jax(pair):
    jcfg, tcfg, _, _ = pair
    js, ts = JT.param_specs(jcfg), T.param_specs(tcfg)
    jl = jax.tree_util.tree_leaves_with_path(
        js, is_leaf=lambda x: hasattr(x, "init_scale"))
    for path, spec in jl:
        node = ts
        for p in path:
            node = node[p.key]
        assert node.shape == spec.shape and node.axes == spec.axes
        assert node.init_scale == spec.init_scale


def test_prefill_and_ragged_decode_match_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    jl, jcache = JT.prefill(jparams, jnp.asarray(tokens), jcfg)
    tl, tcache = T.prefill(tparams, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for a, b in zip(tcache, jcache):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert (tl[:, jcfg.vocab:] == -1e9).all()

    # a live cache of S_MAX rows with ragged live prefixes
    pad = ((0, 0), (0, 0), (0, 0), (0, S_MAX - S), (0, 0))
    jk, jv = (jnp.pad(c, pad) for c in jcache)
    tk, tv = (torch.from_numpy(np.array(c)) for c in (jk, jv))
    lens = np.array([5, 12, 9], np.int32)
    jlen, tlen = jnp.asarray(lens), torch.from_numpy(lens)
    jtok = jnp.asarray(tokens[:, 0])
    ttok = torch.from_numpy(tokens[:, 0])
    for _ in range(STEPS):
        jlog, (jk, jv), jlen = JT.decode_step(jparams, (jk, jv), jtok, jlen,
                                              jcfg)
        tlog, (tk, tv), tlen = T.decode_step(tparams, (tk, tv), ttok, tlen,
                                             tcfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = torch.argmax(tlog, -1).to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        assert int(ttok.max()) < jcfg.vocab
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("attention", [blocked_attention, attention_ref])
def test_plain_attention_paths_match_jax(pair, attention):
    """The model with a plain attention called explicitly (the on-card
    comparison paths) against JAX too, prefill and one decode step."""
    jcfg, tcfg, jparams, tparams = pair
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 10))
    jl, jcache = JT.prefill(jparams, jnp.asarray(tokens, jnp.int32), jcfg)
    tl, tcache = T.prefill(tparams, torch.from_numpy(tokens), tcfg,
                           attention=attention)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    lens = np.array([4, 9], np.int32)
    jlog, _, _ = JT.decode_step(jparams, jcache, jnp.asarray(tokens[:, 0]),
                                jnp.asarray(lens), jcfg)
    tlog, _, _ = T.decode_step(tparams, tcache, torch.from_numpy(tokens[:, 0]),
                               torch.from_numpy(lens), tcfg,
                               attention=attention)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)


def test_serving_params_give_the_same_numbers(pair):
    _, tcfg, _, tparams = pair
    cfg16 = dataclasses.replace(tcfg, compute_dtype=torch.bfloat16)
    tokens = torch.arange(8).reshape(2, 4)
    a, ca = T.prefill(tparams, tokens, cfg16)
    sp = T.serving_params(tparams, cfg16)
    assert sp["layers"]["wq"].dtype == torch.bfloat16
    assert sp["layers"]["ln1"].dtype == torch.float32
    b, cb = T.prefill(sp, tokens, cfg16)
    assert torch.equal(a, b) and torch.equal(ca[0], cb[0])


def test_moe_config_raises():
    cfg = dataclasses.replace(smoke_config(_port_lm_cfg("granite-3-2b")),
                              n_experts=4)
    gen = torch.Generator().manual_seed(0)
    params = init_from_specs(T.param_specs(cfg), gen)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        T.prefill(params, torch.zeros((1, 4), dtype=torch.int32), cfg)


@pytest.mark.parametrize("arch", ["arctic-480b", "dbrx-132b", "graphcast"])
def test_archs_outside_the_slice_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_arch(arch)
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_runs_on_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--requests", "2",
                       "--decode-steps", "2", "--device", "cpu"]) == 0
    assert "tok/s on cpu" in capsys.readouterr().out
