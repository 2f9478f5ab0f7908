"""The port's NequIP against the JAX package's on the CPU: energies and
forces (``energy_and_forces``), the loss with and without the force term
and every gradient leaf (with forces a gradient of a gradient, through the
graph entry's gathers and sums of every order), one AdamW step; and in the
port alone the JAX package's own checks (tests/test_models_gnn.py):
energies invariant and forces equivariant under a rotation and a
translation, energies invariant under relabelling the atoms.

Both packages take the port's intertwiners here: the JAX package fixes an
intertwiner's sign by its largest entry, which for paths whose largest
entries tie in magnitude depends on the order of first use (see
tests/test_torch_gnn_common.py), so its ``nequip`` module is handed the
port's (order-free) ones.

Tolerances (fp32): energies, the loss and its energy term rtol 1e-5 (of
the largest magnitude for energies); forces and gradients rtol 1e-4 plus
1e-4 of the leaf's largest magnitude, the force term (a mean square of
forces) rtol 2e-3; the port's symmetry checks at the JAX package's own
bars (energies 2e-4, forces 2e-3, permutation 1e-4)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget  # noqa: E402
from repro.configs.nequip import SMOKE_CFG as J_SMOKE  # noqa: E402
from repro.models.common import init_from_specs as j_init  # noqa: E402
from repro.models.gnn import nequip as JN  # noqa: E402
from repro.train.optimizer import get_optimizer as j_opt  # noqa: E402
from repro.train.trainer import make_train_step as j_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models.gnn import equivariant as TE  # noqa: E402
from repro_torch.models.gnn import nequip as TN  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train.trainer import make_train_step, value_and_grad  # noqa: E402

CFG = TN.NequIPConfig(**{f.name: getattr(J_SMOKE, f.name)
                         for f in dataclasses.fields(TN.NequIPConfig)
                         if f.name != "compute_dtype"})
SMALL = dict(n_layers=2, d_hidden=8, n_species=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _port_intertwiners(monkeypatch):
    monkeypatch.setattr(JN, "intertwiner", TE.intertwiner)


def assert_leaves(got, want, rtol=1e-4, scale=1e-4):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = a.detach().float().numpy()
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape
        np.testing.assert_allclose(
            a, b, rtol=rtol, atol=scale * max(float(np.abs(b).max()), 1e-30))


def molecule(seed, N=24, E=80, G=2):
    """Atoms of G graphs (the first half graph 0), edges anywhere, self
    edges masked."""
    rng = np.random.default_rng(seed)
    es = rng.integers(0, N, E).astype(np.int32)
    ed = rng.integers(0, N, E).astype(np.int32)
    return dict(
        positions=rng.normal(size=(N, 3)).astype(np.float32) * 2,
        species=rng.integers(0, 4, N).astype(np.int32), edge_src=es,
        edge_dst=ed, edge_mask=es != ed, node_mask=rng.random(N) < 0.9,
        graph_ids=(np.arange(N) >= N // 2).astype(np.int32),
        energy_targets=rng.normal(size=G).astype(np.float32),
        force_targets=rng.normal(size=(N, 3)).astype(np.float32))


def params(seed):
    jp = j_init(JN.param_specs(JN.NequIPConfig(**SMALL)),
                jax.random.PRNGKey(seed))
    return jp, convert.params_from_reference(jax.tree.map(np.asarray, jp),
                                             device="cpu")


ARGS = ("positions", "species", "edge_src", "edge_dst", "edge_mask",
        "node_mask", "graph_ids")


def test_energies_and_forces_match_jax():
    jp, tp = params(5)
    b = molecule(6)
    jcfg, cfg = JN.NequIPConfig(**SMALL), TN.NequIPConfig(**SMALL)
    je, jf, jt = jax.jit(lambda p, *a: JN.energy_and_forces(p, *a, 2, jcfg))(
        jp, *(jnp.asarray(b[k]) for k in ARGS))
    te, tf, tt = TN.energy_and_forces(
        tp, *(torch.tensor(b[k]) for k in ARGS), 2, cfg)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5,
                               atol=1e-5 * np.abs(je).max())
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
    assert_leaves([tf], [jf])


@pytest.mark.parametrize("shape", ["molecule", "full_graph_sm"])
def test_loss_and_gradients_match_jax(shape):
    """The JAX package's smoke cell: with forces (molecule) the gradient
    of the force loss is a gradient of a gradient."""
    jp, _, jb, _ = jget("nequip").build_smoke(shape).args
    uf = shape == "molecule"
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        functools.partial(JN.loss_fn, cfg=J_SMOKE, use_forces=uf),
        has_aux=True))(jp, jb)
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp),
                                       device="cpu")
    tb = {k: torch.tensor(np.array(v)) for k, v in jb.items()}
    tl, tm, tg = value_and_grad(
        lambda p, b: TN.loss_fn(p, b, CFG, use_forces=uf), tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["e_mse"]), float(jm["e_mse"]),
                               rtol=1e-5)
    # the mean square of forces that sit within 1e-4 of their largest
    # magnitude: up to ~2e-4 max|F| / rms|F| of itself
    np.testing.assert_allclose(float(tm["f_mse"]), float(jm["f_mse"]),
                               rtol=2e-3)
    assert_leaves(tg, jax.tree.leaves(jg))


def test_force_training_step_matches_jax():
    """One AdamW step on energies and forces (normal targets)."""
    jp, tp = params(9)
    b = molecule(10)
    jcfg, cfg = JN.NequIPConfig(**SMALL), TN.NequIPConfig(**SMALL)
    jstep = jax.jit(j_step(functools.partial(JN.loss_fn, cfg=jcfg),
                           j_opt("adamw")))
    jp1, _, jm = jstep(jp, j_opt("adamw").init(jp),
                       {k: jnp.asarray(v) for k, v in b.items()},
                       jnp.float32(1e-3))
    opt = TO.get_optimizer("adamw")
    step = make_train_step(functools.partial(TN.loss_fn, cfg=cfg), opt)
    tp1, _, tm = step(tp, opt.init(tp),
                      {k: torch.tensor(v) for k, v in b.items()}, 1e-3)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert_leaves(TO.tree_leaves(tp1), jax.tree.leaves(jp1))


def test_energy_invariance_force_equivariance():
    """tests/test_models_gnn.py's check, on the port alone."""
    cfg = TN.NequIPConfig(**SMALL)
    _, tp = params(5)
    rng = np.random.default_rng(6)
    N, E, G = 24, 80, 2
    pos = rng.normal(size=(N, 3)).astype(np.float32) * 2
    spec = torch.tensor(rng.integers(0, 4, N).astype(np.int32))
    es = rng.integers(0, N, E).astype(np.int32)
    ed = rng.integers(0, N, E).astype(np.int32)
    rest = (torch.tensor(es), torch.tensor(ed), torch.tensor(es != ed),
            torch.ones(N, dtype=torch.bool),
            torch.tensor((np.arange(N) >= 12).astype(np.int32)), G, cfg)
    R = TE.random_rotation(np.random.default_rng(7)).astype(np.float32)
    t = rng.normal(size=(3,)).astype(np.float32)
    e1, f1, _ = TN.energy_and_forces(tp, torch.tensor(pos), spec, *rest)
    e2, f2, _ = TN.energy_and_forces(tp, torch.tensor(pos @ R.T + t), spec,
                                     *rest)
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(f1.numpy() @ R.T, f2.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_permutation_invariance():
    cfg = TN.NequIPConfig(**SMALL)
    _, tp = params(7)
    rng = np.random.default_rng(8)
    N, E = 16, 48
    pos = rng.normal(size=(N, 3)).astype(np.float32) * 2
    spec = rng.integers(0, 4, N).astype(np.int32)
    es = rng.integers(0, N, E).astype(np.int32)
    ed = rng.integers(0, N, E).astype(np.int32)
    gid = torch.zeros(N, dtype=torch.int32)
    ones = torch.ones(N, dtype=torch.bool)
    e1 = TN.forward_energy(tp, torch.tensor(pos), torch.tensor(spec),
                           torch.tensor(es), torch.tensor(ed),
                           torch.tensor(es != ed), ones, gid, 1, cfg)
    perm = rng.permutation(N)
    inv = np.argsort(perm)
    e2 = TN.forward_energy(tp, torch.tensor(pos[perm]),
                           torch.tensor(spec[perm]),
                           torch.tensor(inv[es].astype(np.int32)),
                           torch.tensor(inv[ed].astype(np.int32)),
                           torch.tensor(es != ed), ones, gid, 1, cfg)
    np.testing.assert_allclose(float(e1[0]), float(e2[0]), rtol=1e-4)


def test_bf16_energy_matches_jax():
    """``CFG_BF16``'s path (the shard_map shapes on one card): bf16 basis
    functions and messages, promoted to fp32 where the JAX package's
    arithmetic promotes; energies against the JAX package's bf16 forward
    within 1e-2 of their largest magnitude (bf16 rounding of the basis)."""
    jp, tp = params(11)
    b = molecule(12)
    jcfg = JN.NequIPConfig(**SMALL, compute_dtype=jnp.bfloat16)
    cfg = TN.NequIPConfig(**SMALL, compute_dtype=torch.bfloat16)
    je = np.asarray(jax.jit(lambda p, *a: JN.forward_energy(p, *a, 2, jcfg))(
        jp, *(jnp.asarray(b[k]) for k in ARGS)), np.float32)
    te = TN.forward_energy(tp, *(torch.tensor(b[k]) for k in ARGS), 2, cfg)
    assert te.dtype == torch.float32
    np.testing.assert_allclose(te.numpy(), je, rtol=0,
                               atol=1e-2 * np.abs(je).max())
