"""NequIP's destination-partitioned forward on a group of ranks
(``models.gnn.nequip.forward_energy_shardmap`` over
``launch.mesh.ShardMesh``): a 3-rank gloo group on the CPU against the JAX
package's ``shard_map`` path on 3 forced CPU devices (run under
``jax.jit`` in a subprocess) and against the one-card ``forward_energy``
run in the parent, on the same inputs: ``SMOKE_CFG``, 60 atoms drawn from
a numpy seed, the JAX package's parameters carried across by
``convert.params_from_reference``.

Cases: the energy and every gradient leaf of the energy-only loss against
``jax.grad`` through ``shard_map``; the parameters after one AdamW train
step of the cells' loss (``configs.nequip._loss_shardmap``) against the
JAX cell's step, and bit-equal on every rank; a batch that breaks the input
contract (uniform edges), whose foreign edges both packages drop; the
arranged batch against the one-card ``forward_energy``; a ``CFG_BF16``
run; uneven atoms or edges refused; and ``configs.nequip.build`` inside
the group routing a single-graph cell through the group.

Tolerances: energies rtol 1e-5 (fp32, against the JAX package and against
one card); gradient leaves rtol 1e-4 + atol 1e-6; parameters after the
step rtol 1e-5 + atol 1e-7 (an AdamW step moves each by about lr = 1e-3);
bf16 (``CFG_BF16``, whose energy readout is fp32): the group's energy
within 2^-8 (one bf16 rounding) of the one-card bf16 energy's magnitude,
the two differing only in the order of fp32 sums before their bf16
roundings, while both sit ~1% from the fp32 energy; the group's bf16
train step's loss within the same relative bar of the one-card step's on
the arranged batch.

One spawn of the group runs every case (each rank writes its results to a
file) while the parent runs the one-card cases and a subprocess the JAX
package; every collective has a timeout and the spawn a join deadline."""
import dataclasses
import functools
import os
import pickle
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.models.common import init_from_specs as j_init  # noqa: E402
from repro.models.gnn import nequip as JN  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import nequip as TC  # noqa: E402
from repro_torch.launch import mesh as PM  # noqa: E402
from repro_torch.models.gnn import nequip as TN  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train.trainer import make_train_step, value_and_grad  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 3
N_ATOMS = 60
N_EDGES = 200
LR = 1e-3
COLLECTIVE_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 240.0
BF16_BAR = 2.0 ** -8
ARGS = ("positions", "species", "edge_src", "edge_dst", "edge_mask",
        "node_mask", "graph_ids")
CFG = TC.SMOKE_CFG
CFG16 = dataclasses.replace(CFG, compute_dtype=torch.bfloat16)


# ------------------------------------------------------------- the inputs
def _batches():
    """The arranged batch (uniform edges grouped by their destination's
    node range, each rank's slice padded with masked edges) and a batch
    that breaks the contract (as many uniform edges, ungrouped, a few
    masked), as numpy."""
    d = dict(n=N_ATOMS, e=N_EDGES, graphs=0)
    b = TC._batch(np.random.default_rng(7), d, CFG, targets=True,
                  device="cpu")
    arranged = TC.arrange_to_contract(b, WORLD)
    rng = np.random.default_rng(8)
    e = arranged["edge_src"].shape[0]
    broken = dict(arranged)
    broken["edge_src"] = torch.as_tensor(rng.integers(0, N_ATOMS, e),
                                         dtype=torch.int32)
    broken["edge_dst"] = torch.as_tensor(rng.integers(0, N_ATOMS, e),
                                         dtype=torch.int32)
    broken["edge_mask"] = torch.as_tensor(rng.random(e) < 0.95)
    np_ = lambda bb: {k: v.numpy().copy() for k, v in bb.items()}
    return np_(arranged), np_(broken)


def _kept_mask(b):
    """The edges each rank keeps of ``b``: those of its slice whose
    destination lies in its node range (and live)."""
    e, n = b["edge_dst"].shape[0], b["positions"].shape[0]
    rank = np.arange(e) // (e // WORLD)
    return b["edge_mask"] & (b["edge_dst"] // (n // WORLD) == rank)


def _t(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _energy_loss(forward):
    def loss(p, b):
        e = forward(p, *(b[k] for k in ARGS))
        return ((e - b["energy_targets"].float()) ** 2).mean(), {"e": e}
    return loss


def _np(tree):
    return [x.detach().float().numpy().copy() for x in TO.tree_leaves(tree)]


# ------------------------------------------------------------ the group
def _rank(rank, work):
    """One rank of the group: every case, results to ``rank{rank}.pkl``."""
    torch.set_num_threads(1)
    PM.init_group(rank, WORLD, os.path.join(work, "store"), backend="gloo",
                  timeout_s=COLLECTIVE_TIMEOUT_S)
    import torch.distributed as dist

    try:
        with open(os.path.join(work, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        mesh = TC.group_mesh("cpu")
        arranged, broken = _t(inp["arranged"]), _t(inp["broken"])
        params = convert.params_from_reference(inp["params"], device="cpu")

        def fwd(cfg):
            return lambda p, *a: TN.forward_energy_shardmap(p, *a, 1, cfg,
                                                            mesh)

        loss, m, grads = value_and_grad(_energy_loss(fwd(CFG)), params,
                                        arranged)
        out = dict(energy=m["e"].numpy(), loss=float(loss),
                   grads=[g.numpy() for g in grads])
        with torch.no_grad():
            out["broken"] = fwd(CFG)(params, *(broken[k]
                                               for k in ARGS)).numpy()
            out["bf16"] = fwd(CFG16)(params, *(arranged[k] for k in ARGS)) \
                .float().numpy()
        # the cells' loss, one AdamW step
        opt = TO.get_optimizer("adamw")
        step = make_train_step(functools.partial(TC._loss_shardmap, cfg=CFG,
                                                 mesh=mesh), opt)
        p1 = convert.params_from_reference(inp["params"], device="cpu")
        p1, _, met = step(p1, opt.init(p1), arranged, LR)
        out["step"] = dict(params=_np(p1), loss=float(met["loss"]),
                           grad_norm=float(met["grad_norm"]))
        # uneven atoms or edges: refused before any collective
        errors = []
        for k, cut in (("positions", 1), ("edge_src", 1)):
            bad = dict(arranged)
            for key in (ARGS[:2] + ARGS[5:] if k == "positions"
                        else ARGS[2:5]):
                bad[key] = arranged[key][:-cut]
            try:
                fwd(CFG)(params, *(bad[a] for a in ARGS))
            except ValueError as e:
                errors.append(str(e))
        out["uneven"] = errors
        # the cell inside the group: full_graph_sm at one layer
        cell = TC.build("full_graph_sm", device="cpu",
                        reduced={"n_layers": 1})
        _, _, cm = cell.fn(*cell.args)
        out["cell"] = dict(notes=cell.notes, loss=float(cm["loss"]),
                           e_mse=float(cm["e_mse"]),
                           keys=sorted(cm), params=_np(cell.args[0]))
        with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


_JAX = textwrap.dedent("""
    import functools, pickle, sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import nequip as JC
    from repro.models.gnn import nequip as JN
    from repro.train.optimizer import get_optimizer
    from repro.train.trainer import make_train_step
    from repro_torch.models.gnn import equivariant as TE
    # the port's (order-free) intertwiners: the JAX package's signs depend
    # on the order of first use (tests/test_torch_gnn_nequip.py)
    JN.intertwiner = TE.intertwiner
    work, world = sys.argv[1], int(sys.argv[2])
    assert len(jax.devices()) == world
    with open(work + "/inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    params = jax.tree.map(jnp.asarray, inp["params"])
    mesh = Mesh(np.asarray(jax.devices()), ("data",))
    args = ("positions", "species", "edge_src", "edge_dst", "edge_mask",
            "node_mask", "graph_ids")
    cfg = JC.SMOKE_CFG

    def loss(p, b):
        e = JN.forward_energy_shardmap(p, *(b[k] for k in args), 1, cfg,
                                       mesh, ("data",))
        return jnp.mean((e - b["energy_targets"]) ** 2), e

    vg = jax.jit(jax.value_and_grad(loss, has_aux=True))
    out = {}
    for name in ("arranged", "broken"):
        b = {k: jnp.asarray(v) for k, v in inp[name].items()}
        (l, e), g = vg(params, b)
        out[name] = dict(loss=float(l), energy=np.asarray(e),
                         grads=[np.asarray(x) for x in jax.tree.leaves(g)])
    opt = get_optimizer("adamw")
    step = jax.jit(make_train_step(functools.partial(
        JC._loss_shardmap, cfg=cfg, mesh=mesh, axis_names=("data",)), opt))
    b = {k: jnp.asarray(v) for k, v in inp["arranged"].items()}
    p1, _, met = step(params, opt.init(params), b, jnp.float32(%r))
    out["step"] = dict(params=[np.asarray(x) for x in jax.tree.leaves(p1)],
                       loss=float(met["loss"]),
                       grad_norm=float(met["grad_norm"]))
    with open(work + "/jax.pkl", "wb") as f:
        pickle.dump(out, f)
""" % LR)


def _one_card(inp) -> dict:
    """The parent's cases: ``forward_energy`` on one device."""
    arranged, broken = _t(inp["arranged"]), _t(inp["broken"])
    params = convert.params_from_reference(inp["params"], device="cpu")
    one = lambda cfg: lambda p, *a: TN.forward_energy(p, *a, 1, cfg)
    out = {}
    with torch.no_grad():
        out["energy"] = one(CFG)(params, *(arranged[k] for k in ARGS)).numpy()
        out["bf16"] = one(CFG16)(params, *(arranged[k] for k in ARGS)) \
            .float().numpy()
        kept = dict(broken, edge_mask=torch.as_tensor(
            _kept_mask(inp["broken"])))
        out["kept"] = one(CFG)(params, *(kept[k] for k in ARGS)).numpy()
        out["broken_whole"] = one(CFG)(params, *(broken[k]
                                                 for k in ARGS)).numpy()
    # the same cell on one card, its batch arranged as the group's
    cell = TC.build("full_graph_sm", device="cpu", reduced={"n_layers": 1})
    params, opt_state, batch, lr = cell.args
    _, _, cm = cell.fn(params, opt_state,
                       TC.arrange_to_contract(batch, WORLD), lr)
    out["cell"] = dict(notes=cell.notes, loss=float(cm["loss"]))
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The group's results by rank, the one-card results and the JAX
    package's."""
    work = str(tmp_path_factory.mktemp("nequip_shardmap"))
    jp = j_init(JN.param_specs(JN.NequIPConfig(
        **{f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)
           if f.name != "compute_dtype"})), jax.random.PRNGKey(3))
    arranged, broken = _batches()
    inp = dict(params=jax.tree.map(np.asarray, jp), arranged=arranged,
               broken=broken)
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    ref = subprocess.Popen([sys.executable, "-c", _JAX, work, str(WORLD)],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    errors = []

    def group():
        try:
            PM.spawn_group(_rank, WORLD, args=(work,),
                           join_timeout_s=JOIN_TIMEOUT_S)
        except BaseException as e:  # re-raised in the parent below
            errors.append(e)

    t = threading.Thread(target=group)
    t.start()
    try:
        one = _one_card(inp)
    finally:
        t.join()
        log, _ = ref.communicate(timeout=JOIN_TIMEOUT_S)
    if errors:
        raise errors[0]
    assert ref.returncode == 0, log
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    with open(os.path.join(work, "jax.pkl"), "rb") as f:
        jx = pickle.load(f)
    return dict(ranks=ranks, one=one, jax=jx, inp=inp)


# ------------------------------------------------------------- the tests
def test_energy_equals_jax_shard_map(runs):
    want = runs["jax"]["arranged"]["energy"]
    for out in runs["ranks"]:
        assert out["energy"].shape == (1,)
        np.testing.assert_allclose(out["energy"], want, rtol=1e-5)
        np.testing.assert_allclose(out["loss"],
                                   runs["jax"]["arranged"]["loss"],
                                   rtol=1e-5)


def test_gradients_equal_jax_grad(runs):
    want = runs["jax"]["arranged"]["grads"]
    for r, out in enumerate(runs["ranks"]):
        assert len(out["grads"]) == len(want)
        for i, (a, b) in enumerate(zip(out["grads"], want)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6,
                                       err_msg=f"rank {r} leaf {i}")


def test_train_step_equals_jax_cell_step(runs):
    want = runs["jax"]["step"]
    for r, out in enumerate(runs["ranks"]):
        got = out["step"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-5)
        assert len(got["params"]) == len(want["params"])
        for i, (a, b) in enumerate(zip(got["params"], want["params"])):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7,
                                       err_msg=f"rank {r} leaf {i}")


@pytest.mark.parametrize("what", ["step", "cell"])
def test_ranks_bit_equal_after_step(runs, what):
    first = runs["ranks"][0][what]["params"]
    for out in runs["ranks"][1:]:
        for a, b in zip(out[what]["params"], first):
            assert a.tobytes() == b.tobytes()


def test_contract_breaking_batch_drops_as_jax(runs):
    """Uniform edges: each rank drops the edges of its slice whose
    destination is another rank's, as the JAX package's sink row does; the
    energy is the one-card energy of the edges kept, not of all."""
    want = runs["jax"]["broken"]["energy"]
    kept, whole = runs["one"]["kept"], runs["one"]["broken_whole"]
    kept_share = _kept_mask(runs["inp"]["broken"]).sum() \
        / runs["inp"]["broken"]["edge_mask"].sum()
    assert 0.2 < kept_share < 0.5
    assert abs(float(whole[0] - kept[0])) > 1e-2 * abs(float(whole[0]))
    for out in runs["ranks"]:
        np.testing.assert_allclose(out["broken"], want, rtol=1e-5)
        np.testing.assert_allclose(out["broken"], kept, rtol=1e-5)


def test_arranged_batch_equals_one_card(runs):
    for out in runs["ranks"]:
        np.testing.assert_allclose(out["energy"], runs["one"]["energy"],
                                   rtol=1e-5)


def test_bf16_within_bar(runs):
    e32 = float(runs["one"]["energy"][0])
    one16 = float(runs["one"]["bf16"][0])
    assert abs(one16 - e32) > BF16_BAR * abs(e32)     # it ran in bf16
    for out in runs["ranks"]:
        got = float(out["bf16"][0])
        assert abs(got - one16) <= BF16_BAR * abs(one16), (got, one16, e32)


@pytest.mark.parametrize("which", [0, 1])
def test_uneven_split_raises(runs, which):
    what = ("atoms", "edges")[which]
    for out in runs["ranks"]:
        assert len(out["uneven"]) == 2
        assert f"do not split into {WORLD}" in out["uneven"][which]
        assert what in out["uneven"][which]


def test_cell_inside_group_routes_through_group(runs):
    one = runs["one"]["cell"]
    assert "forward_energy on one card" in one["notes"]
    for out in runs["ranks"]:
        cell = out["cell"]
        assert "forward_energy_shardmap over 3 ranks (gloo)" in cell["notes"]
        assert cell["keys"] == ["e_mse", "grad_norm", "loss"]
        assert np.isfinite(cell["loss"]) and cell["loss"] == cell["e_mse"]
        assert abs(cell["loss"] - one["loss"]) <= BF16_BAR * one["loss"]


def test_arrange_to_contract_groups_by_destination_range():
    b = _t(_batches()[0])
    n_local = N_ATOMS // WORLD
    e = b["edge_dst"].shape[0]
    assert e % (WORLD * 512) == 0
    rank = torch.arange(e) // (e // WORLD)
    live = b["edge_mask"]
    assert bool((b["edge_dst"][live] // n_local == rank[live]).all())
    assert int(live.sum()) == N_EDGES
    # the pad edges: masked self edges on the range's first atom
    assert bool((b["edge_src"][~live] == b["edge_dst"][~live]).all())
    assert bool((b["edge_dst"][~live] % n_local == 0).all())
    # relative order kept within a range
    raw = TC._batch(np.random.default_rng(7), dict(n=N_ATOMS, e=N_EDGES,
                                                   graphs=0),
                    CFG, targets=True, device="cpu")
    for r in range(WORLD):
        sel = (raw["edge_dst"] // n_local) == r
        keep = live & (rank == r)
        assert torch.equal(b["edge_src"][keep], raw["edge_src"][sel])
        assert torch.equal(b["edge_dst"][keep], raw["edge_dst"][sel])
    with pytest.raises(ValueError, match="do not split"):
        TC.arrange_to_contract(raw, 7)
