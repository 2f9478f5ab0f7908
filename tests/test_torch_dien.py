"""The port's DIEN serve path against the JAX package's on ``SMOKE_CFG``:
parameters drawn with numpy from a seed (handed to the port through
``convert.params_from_reference``), one
numpy-made batch (ragged behaviour masks, partly masked profile bags) through
both ``serve``s, to 1e-5. The port's profile lookup runs the embedding-bag
wrapper, whose CPU path is the kernel's plain version."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.dien import SMOKE_CFG as JAX_SMOKE  # noqa: E402
from repro.models.recsys import dien as JD  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import dien as tconfigs  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as bag_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.recsys import dien as TD  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = tconfigs.SMOKE_CFG


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


@pytest.fixture(scope="module")
def params():
    np_params = numpy_params(JD.param_specs(JAX_SMOKE), seed=0)
    return (jax.tree.map(jnp.asarray, np_params),
            convert.params_from_reference(np_params, device="cpu"))


def _batch(B, seed):
    rng = np.random.default_rng(seed)
    S, nb = CFG.seq_len, CFG.profile_bag_size
    mask = rng.random((B, S)) < 0.8
    mask[0] = False                       # a user with no behaviour at all
    pmask = rng.random((B, nb)) < 0.6
    pmask[1] = False                      # a user with an empty profile
    return dict(
        item_ids=rng.integers(0, CFG.n_items, (B, S)).astype(np.int32),
        cat_ids=rng.integers(0, CFG.n_cats, (B, S)).astype(np.int32),
        mask=mask,
        target_item=rng.integers(0, CFG.n_items, B).astype(np.int32),
        target_cat=rng.integers(0, CFG.n_cats, B).astype(np.int32),
        profile_ids=rng.integers(0, CFG.n_profile_feats, (B, nb)).astype(
            np.int32),
        profile_mask=pmask)


def test_configs_agree_with_jax():
    from repro.configs import dien as jconfigs
    for name in ("CFG", "SMOKE_CFG"):
        j, t = getattr(jconfigs, name), getattr(tconfigs, name)
        for f in ("n_items", "n_cats", "embed_dim", "seq_len", "gru_dim",
                  "mlp_dims", "n_profile_feats", "profile_bag_size",
                  "att_hidden"):
            assert getattr(j, f) == getattr(t, f), (name, f)
    assert jconfigs.SHAPE_DEFS == tconfigs.SHAPE_DEFS


@pytest.mark.parametrize("partial_profiles", [False, True])
def test_serve_matches_jax(params, partial_profiles):
    """Full profile bags (as the launcher's batches draw them) and partly
    masked ones with an empty row."""
    jp, tp = params
    batch = _batch(8, seed=3)
    if not partial_profiles:
        batch["profile_mask"][:] = True
    want = np.asarray(JD.serve(jp, {k: jnp.asarray(v) for k, v in
                                    batch.items()}, JAX_SMOKE))
    got = TD.serve(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                   CFG)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_profile_embed_matches_jax_and_masked_row_is_zero(params):
    jp, tp = params
    b = _batch(6, seed=4)
    want = np.asarray(JD.profile_embed(jp, jnp.asarray(b["profile_ids"]),
                                       jnp.asarray(b["profile_mask"]),
                                       JAX_SMOKE))
    bag_ops.reset_launches()
    got = TD.profile_embed(tp, torch.from_numpy(b["profile_ids"]),
                           torch.from_numpy(b["profile_mask"]), CFG).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[1] == 0).all() and np.abs(got[0]).sum() > 0
    assert bag_ops.LAUNCHES["embedding_bag"] == 0   # CPU: the plain version


@pytest.mark.parametrize("shape", ["train_batch", "retrieval_cand"])
def test_shapes_outside_the_slice_raise(shape):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tconfigs.build_smoke(shape, device="cpu")


def test_launcher_runs_on_cpu(capsys):
    assert serve.main(["--arch", "dien", "--requests", "16",
                       "--device", "cpu"]) == 0
    assert "per batch of 8 on cpu" in capsys.readouterr().out
