"""The MoE LM train cells placed on a device mesh (``CellPlan.on_mesh`` of
``train_4k``: the expert gradients through both dispatches and the
global load-balance loss): a 4-rank gloo group on the CPU on the meshes
(2, 2) and (1, 4) of (data, model), against the JAX package's
partitioned train step (its ``lm_common.build_cell``: the arch's
optimizer, rule preset and accumulation, jitted on 4 forced CPU devices
in a subprocess) and against the port's one-device step run in the
parent, on the same inputs: dbrx-132b's smoke config (2 layers, d 64, 4
experts top-2, fp32, Adafactor) with the sort dispatch and with the
einsum dispatch, arctic-480b's (sort, the dense residual FFN,
``residual_sp``) and dbrx's with 6 experts (3 a rank on (2, 2); on
(1, 4) the divisibility guard replicates them); batch 8 x seq 64,
accumulation min(the arch's, 2) as ``build_smoke`` cuts it, parameters
and batches drawn with numpy from a seed.

The ranks run as on the card's gloo group
(``tests/test_torch_placed_train.py``'s ``_card_like``): every all-gather
and reduce-scatter staged through the host, a functional all-gather or
reduce-scatter raises, and the backward runs on a thread of its own, as
autograd runs it for CUDA tensors.

Cases: every placed argument's local shard (the expert leaves and
Adafactor's factored moments included) bit-equal to the JAX package's
``addressable_shards``; after one and two steps the loss, ``ce``,
``aux``, ``grad_norm``, every parameter and every optimizer-state leaf
within ``tests/test_torch_train_lm.py``'s tolerances of the JAX package's
partitioned step and of the port's one-device step; the metrics and every
gathered leaf bit-equal on all ranks; the gradients of the placed leaves
(before any step) each rank's slice of the one-device gradients; ``aux``
one device's value over the whole batch, not one computed over a rank's
rows alone; each layer's routing in the forward and in the checkpoint's
recompute (run on the backward's own thread) bit-equal on the ranks
that hold the same rows, the recompute the forward's, and the data
ranks' rows together one device's; no rank loads ``jax``.

One spawn of the group runs every case (each rank writes its results to
a file) while the parent runs the one-device steps and a subprocess the
JAX package; every collective has a timeout and the spawn a join
deadline."""
import collections
import contextlib
import dataclasses
import functools
import importlib
import os
import pickle
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_placed_train import (  # noqa: E402
    _card_like,
    _check_step,
    _leaves,
    _shards,
    _whole,
    assert_leaf_close,
)

from repro_torch import convert  # noqa: E402
from repro_torch.configs import lm_common  # noqa: E402
from repro_torch.launch import mesh as PM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train.optimizer import get_optimizer  # noqa: E402
from repro_torch.train.trainer import value_and_grad  # noqa: E402
from repro_torch.tree import tree_unflatten  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 4
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
# config name -> (the arch's config module, fields replaced in its smoke
# config)
CONFIGS = {"dbrx": ("dbrx_132b", {}),
           "dbrx_einsum": ("dbrx_132b", {"moe_impl": "einsum"}),
           "arctic": ("arctic_480b", {}),
           "dbrx_6_experts": ("dbrx_132b", {"n_experts": 6})}
B, S, STEPS, LR = 8, 64, 2, 1e-3
COLLECTIVE_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 420.0


def _setting(name: str):
    """(smoke config, train setting with the accumulation cut as
    ``build_smoke`` cuts it)."""
    mod, fields = CONFIGS[name]
    arch = importlib.import_module(f"repro_torch.configs.{mod}")
    return (dataclasses.replace(lm_common.smoke_config(arch.CFG), **fields),
            dataclasses.replace(arch.TRAIN, accum=min(arch.TRAIN.accum, 2)))


# ------------------------------------------------------------- the inputs
def _inputs() -> dict:
    """Every config's parameters by the rule of ``init_from_specs`` and
    STEPS batches, as numpy."""
    rng = np.random.default_rng(32)
    out = {}
    for name in CONFIGS:
        cfg, _ = _setting(name)
        params = {}
        for path, s in _leaves(T.param_specs(cfg)):
            fan_in = s.shape[0] if len(s.shape) > 1 else max(1, s.shape[-1])
            node = params
            keys = path.strip("/").split("/")
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = (rng.normal(size=s.shape) * s.init_scale
                              / np.sqrt(fan_in)).astype(np.float32)
        batches = [{k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
                    for k in ("labels", "tokens")} for _ in range(STEPS)]
        out[name] = dict(params=params, batches=batches)
    return out


def _batch(inp, name: str, i: int) -> dict:
    return {k: torch.from_numpy(v.copy())
            for k, v in inp[name]["batches"][i].items()}


def _plan(inp, name: str, params=None, opt_state=None, i: int = 0):
    """The port's ``train_4k`` cell at the config ``name`` with these
    parameters (the inputs' unless given), optimizer state (a fresh one
    unless given), batch ``i`` and lr."""
    cfg, train = _setting(name)
    plan = lm_common.build_cell(cfg, train, "train_4k", device="meta",
                                reduced={"batch": B})
    assert plan.notes.startswith(f"accum={train.accum} ")
    params = params if params is not None else \
        convert.params_from_reference(inp[name]["params"], device="cpu")
    if opt_state is None:
        opt_state = get_optimizer(train.optimizer).init(params)
    return dataclasses.replace(plan, args=(
        params, opt_state, _batch(inp, name, i), torch.tensor(LR)))


@contextlib.contextmanager
def _routing(tape: list):
    """Every routing of the block appends (``gate_idx``, the thread that
    ran it) to ``tape``."""
    route = T._route

    def taped(x, router, k):
        got = route(x, router, k)
        tape.append((got[2].detach().numpy().copy(), threading.get_ident()))
        return got

    T._route = taped
    try:
        yield
    finally:
        T._route = route


def _grads(cfg, params, batch, rules=None, mesh=None):
    """The loss, ``aux``, the gradients and the routing tape (forward
    and recompute) at ``params`` on ``batch``, placed under ``rules``
    where ``mesh``."""
    from repro_torch.distributed.sharding import RULE_SETS, activation_sharding

    tape = []
    ctx = contextlib.nullcontext() if mesh is None else \
        activation_sharding(mesh, RULE_SETS[rules or "default"])
    with ctx, _routing(tape):
        loss, met, grads = value_and_grad(functools.partial(T.loss_fn,
                                                            cfg=cfg),
                                          params, batch)
    return loss.item(), float(met["aux"]), grads, tape


# ------------------------------------------------------------- the group
def _rank(rank: int, work: str) -> None:
    """One rank: every config on both meshes (placed arguments' local
    shards, the gradients and routing at the first state, two steps'
    metrics, parameters and state gathered, and their local shards); to
    ``rank{rank}.pkl``."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import MeshShape

    torch.set_num_threads(1)
    calls = _card_like()
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {}
    for m, shape_of in MESHES.items():
        PM.init_group(rank, WORLD, os.path.join(work, f"store_{m}"),
                      timeout_s=COLLECTIVE_TIMEOUT_S)
        try:
            mesh = PM.make_device_mesh(MeshShape(("data", "model"),
                                                 shape_of),
                                       device_type="cpu")
            coord = tuple(mesh.get_coordinate())
            for name in CONFIGS:
                cfg, train = _setting(name)
                placed = _plan(inp, name).on_mesh(mesh)
                args = {p: t.to_local().numpy().copy()
                        for p, t in _leaves(placed.args)}
                params, _, batch, _ = placed.args
                before = calls["reduce_scatter"]
                loss, aux, grads, tape = _grads(cfg, params, batch,
                                                train.train_rules, mesh)
                grad = dict(loss=loss, aux=aux, tape=tape, shards=_shards(
                    tree_unflatten(params, grads)),
                    reduce_scatters=calls["reduce_scatter"] - before,
                    thread=threading.get_ident())
                steps = [_record(*placed.fn(*placed.args))]
                # step 2 from the JAX package's state after its step 1 on
                # this mesh, as tests/test_torch_train_lm.py goes on
                p1, o1 = _jax_step1(work)[(m, name)]
                again = _plan(inp, name, convert.params_from_reference(
                    p1, device="cpu"), convert.opt_state_from_reference(
                    o1, device="cpu"), 1).on_mesh(mesh)
                steps.append(_record(*again.fn(*again.args)))
                out[(m, name)] = dict(args=args, grad=grad, steps=steps,
                                      coord=coord)
        finally:
            dist.destroy_process_group()
    out["modules"] = [k for k in sys.modules if k == "jax"
                      or k.startswith("jax.")]
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _record(params, opt_state, metrics) -> dict:
    """A placed step's metrics, its parameters and state gathered, and
    their local shards."""
    return dict(metrics={k: v.numpy().copy() for k, v in metrics.items()},
                params={p: _whole(t) for p, t in _leaves(params)},
                state={p: _whole(t) for p, t in _leaves(opt_state)},
                shards=_shards((params, opt_state)))


def _jax_step1(work: str) -> dict:
    """The JAX package's (params, opt_state) after step 1, by (mesh,
    config), as numpy, once its subprocess has written them."""
    path = os.path.join(work, "jax_step1.pkl")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError("no step 1 from the JAX package")
        time.sleep(0.2)
    with open(path, "rb") as f:
        got = pickle.load(f)
    return {k: (p, collections.namedtuple("State", fields)(*values))
            for k, (p, (fields, values)) in got.items()}


# -------------------------------------------------------- the JAX package
_JAX = textwrap.dedent("""
    import dataclasses, importlib, os, pickle, sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import lm_common as JL
    from repro.distributed.sharding import activation_sharding
    from repro.train.optimizer import get_optimizer

    work = sys.argv[1]
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    meshes, configs, B, S, lr = pickle.loads(bytes.fromhex(sys.argv[2]))
    JL.SHAPE_DEFS["train_4k"] = dict(JL.SHAPE_DEFS["train_4k"], batch=B,
                                     seq=S)

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], path + "/" + k)
        elif isinstance(tree, (list, tuple)):
            for i, t in enumerate(tree):
                yield from leaves(t, path + "/" + str(i))
        else:
            yield path, tree

    def record(p, o, met):
        return dict(metrics={k: np.asarray(v) for k, v in met.items()},
                    params={q: np.asarray(t) for q, t in leaves(p)},
                    state={q: np.asarray(t) for q, t in leaves(o)})

    out, cells, step1 = {}, {}, {}
    for name, (mod, fields) in configs.items():
        lm = importlib.import_module("repro.configs." + mod) \\
            .ARCH.build_smoke.__closure__[0].cell_contents
        lm = dataclasses.replace(
            lm, cfg=dataclasses.replace(JL.smoke_config(lm.cfg), **fields),
            accum=min(lm.accum, 2))
        for m, shape_of in meshes.items():
            mesh = Mesh(np.array(jax.devices()).reshape(shape_of),
                        ("data", "model"))
            plan = JL.build_cell(lm, "train_4k", mesh)
            params = jax.tree.map(jnp.asarray, inp[name]["params"])
            opt_state = get_optimizer(lm.optimizer).init(params)
            batches = inp[name]["batches"]
            args = (params, opt_state, batches[0], np.float32(lr))
            shards = {}
            for (p, a), (_, sh) in zip(leaves(args),
                                       leaves(plan.in_shardings)):
                put = jax.device_put(a, sh)
                shards[p] = {s.device.id: np.asarray(s.data)
                             for s in put.addressable_shards}
            fn = jax.jit(plan.fn, in_shardings=plan.in_shardings,
                         out_shardings=plan.out_shardings)
            with mesh, activation_sharding(mesh, plan.rules):
                p, o, met = fn(*args)
            out[(m, name)] = dict(shards=shards, steps=[record(p, o, met)])
            cells[(m, name)] = (mesh, plan, fn, p, o)
            # the state's NamedTuple as (field names, values): unpickling
            # the JAX package's class would import JAX in the ranks
            step1[(m, name)] = (jax.tree.map(np.asarray, p), (
                o._fields, tuple(jax.tree.map(np.asarray, x) for x in o)))
    with open(os.path.join(work, "jax_step1.tmp"), "wb") as f:
        pickle.dump(step1, f)
    os.replace(os.path.join(work, "jax_step1.tmp"),
               os.path.join(work, "jax_step1.pkl"))
    for (m, name), (mesh, plan, fn, p, o) in cells.items():
        with mesh, activation_sharding(mesh, plan.rules):
            p, o, met = fn(p, o, inp[name]["batches"][1], np.float32(lr))
        out[(m, name)]["steps"].append(record(p, o, met))
    with open(os.path.join(work, "jax.pkl"), "wb") as f:
        pickle.dump(out, f)
""")


# ------------------------------------------------------------- the runs
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _one_device(inp, work: str) -> dict:
    """Each config's one-device results: the gradients, ``aux`` and
    routing at the first state (and ``aux`` over each half of the batch's
    rows alone), step 1 from the inputs, and on each mesh's behalf step 2
    from the JAX package's state after its step 1 on that mesh (metrics,
    parameters and state after each, the parameters before it and its
    gradients)."""
    out = {}
    for name in CONFIGS:
        cfg, train = _setting(name)
        plan = _plan(inp, name)
        loss, aux, g, tape = _grads(cfg, plan.args[0], _batch(inp, name, 0))
        half = [_grads(cfg, plan.args[0], {k: v[i * B // 2:(i + 1) * B // 2]
                                           for k, v in _batch(
                                               inp, name, 0).items()})[1]
                for i in range(2)]
        first_grad = dict(loss=loss, aux=aux, half_aux=half, tape=tape,
                          grads={p: x.numpy() for (p, _), x in zip(
                              _leaves(plan.args[0]), g)})

        def step(params, opt_state, i):
            g = _grads(cfg, params, _batch(inp, name, i))[2]
            before = {p: t.numpy().copy() for p, t in _leaves(params)}
            params, opt_state, metrics = plan.fn(params, opt_state,
                                                 _batch(inp, name, i),
                                                 torch.tensor(LR))
            return dict(
                metrics={k: v.numpy().copy() for k, v in metrics.items()},
                params={p: t.numpy().copy() for p, t in _leaves(params)},
                state={p: t.numpy().copy() for p, t in _leaves(opt_state)},
                before=before,
                grads={p: x.numpy() for (p, _), x in zip(_leaves(params),
                                                          g)})

        first = step(*_plan(inp, name).args[:2], 0)
        for m in MESHES:
            p1, o1 = _jax_step1(work)[(m, name)]
            out[(m, name)] = [first, step(
                convert.params_from_reference(p1, device="cpu"),
                convert.opt_state_from_reference(o1, device="cpu"), 1)]
        out[name] = first_grad
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The group's results by rank, the one-device results and the JAX
    package's."""
    work = str(tmp_path_factory.mktemp("placed_moe_train"))
    inp = _inputs()
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    ref = subprocess.Popen(
        [sys.executable, "-c", _JAX, work,
         pickle.dumps((MESHES, CONFIGS, B, S, LR)).hex()], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
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
        one = _one_device(inp, work)
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
CASES = [(n, m) for n in CONFIGS for m in MESHES]


@pytest.mark.parametrize("name,mesh", CASES)
def test_local_shards_equal_jax_addressable_shards(runs, name, mesh):
    """Parameters (the expert leaves and the router included), Adafactor's
    factored moments, batch and lr: rank i's local shard is device i's."""
    want = runs["jax"][(mesh, name)]["shards"]
    assert any("/we_gate" in p for p in want)
    for r, out in enumerate(runs["ranks"]):
        got = out[(mesh, name)]["args"]
        assert sorted(got) == sorted(want)
        for p in got:
            np.testing.assert_array_equal(got[p], want[p][r],
                                          err_msg=f"rank {r} {p}")


@pytest.mark.parametrize("name,mesh", CASES)
def test_placed_steps_equal_jax_partitioned_steps(runs, name, mesh):
    want = runs["jax"][(mesh, name)]["steps"]
    for r, out in enumerate(runs["ranks"]):
        for i, got in enumerate(out[(mesh, name)]["steps"]):
            _check_step(got, want[i], runs["one"][(mesh, name)], i,
                        f"rank {r} step {i} vs jax")


@pytest.mark.parametrize("name,mesh", CASES)
def test_placed_steps_equal_one_device(runs, name, mesh):
    want = runs["one"][(mesh, name)]
    for r, out in enumerate(runs["ranks"]):
        for i, got in enumerate(out[(mesh, name)]["steps"]):
            _check_step(got, want[i], want, i,
                        f"rank {r} step {i} vs one device")


@pytest.mark.parametrize("name,mesh", CASES)
def test_replicated_outputs_are_bit_equal_on_every_rank(runs, name, mesh):
    """The metrics and every gathered leaf bit-equal on all ranks, the
    factored moments included."""
    outs = [out[(mesh, name)] for out in runs["ranks"]]
    for i in range(STEPS):
        first = outs[0]["steps"][i]
        for o in outs[1:]:
            got = o["steps"][i]
            for k in first["metrics"]:
                np.testing.assert_array_equal(got["metrics"][k],
                                              first["metrics"][k])
            for part in ("params", "state"):
                for p in first[part]:
                    np.testing.assert_array_equal(got[part][p],
                                                  first[part][p])


@pytest.mark.parametrize("name,mesh", CASES)
def test_gradients_are_slices_of_one_device(runs, name, mesh):
    """Before any step, each rank's gradient of every placed leaf (the
    router and the experts included) is its slice of the one-device
    gradient, on the leaf's placements; the FSDP gathers' backward
    reduce-scattered the rows' partial gradients."""
    from repro_torch.distributed.sharding import RULE_SETS, MeshShape, spec_for

    shape = MeshShape(("data", "model"), MESHES[mesh])
    cfg, train = _setting(name)
    rules = RULE_SETS[train.train_rules or "default"]
    specs = dict(_leaves(T.param_specs(cfg)))
    want = runs["one"][name]["grads"]
    for r, out in enumerate(runs["ranks"]):
        got = out[(mesh, name)]["grad"]
        assert (got["reduce_scatters"] > 0) == (
            MESHES[mesh][0] > 1 or train.train_rules == "residual_sp")
        coord = out[(mesh, name)]["coord"]
        for p, g in got["shards"].items():
            full = want[p]
            entries = spec_for(full.shape, specs[p].axes, shape, rules)
            axes_of = [() if e is None else (e if isinstance(e, tuple)
                                             else (e,)) for e in entries]
            for d, axes in enumerate(axes_of):
                idx, n = 0, 1
                for ax in axes:
                    j = shape.axis_names.index(ax)
                    idx, n = idx * shape.shape[j] + coord[j], \
                        n * shape.shape[j]
                size = full.shape[d] // n
                full = full.take(range(idx * size, (idx + 1) * size), axis=d)
            assert [k for k, _ in g["placements"]] == [
                "Shard" if any(shape.axis_names[j] in a for a in axes_of)
                else "Replicate" for j in range(len(shape.shape))], \
                (p, g["placements"])
            assert_leaf_close(g["local"], full, f"{name} rank {r} grad {p}")


@pytest.mark.parametrize("name,mesh", CASES)
def test_aux_is_the_global_load_balance_loss(runs, name, mesh):
    """Every rank's ``aux`` (and loss) at the first state is one device's
    over the whole batch, within fp32 reassociation, and not the loss of
    the rows a data rank holds (each half of the batch alone, one
    device's), which differ from it."""
    one = runs["one"][name]
    for r, out in enumerate(runs["ranks"]):
        got = out[(mesh, name)]["grad"]
        np.testing.assert_allclose(got["aux"], one["aux"], rtol=1e-5)
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
        for half in one["half_aux"]:
            assert abs(half - one["aux"]) > 100 * abs(got["aux"] - one["aux"])


@pytest.mark.parametrize("name,mesh", CASES)
def test_routing_is_one_device_in_the_forward_and_the_recompute(runs, name,
                                                                mesh):
    """Each layer's ``gate_idx``, in the forward and in the checkpoint's
    recompute (layers in reverse, on the backward's own thread): the
    recompute bit-equal to the forward, every call bit-equal on the ranks
    that hold the same rows, and the data ranks' rows in order one
    device's."""
    cfg, _ = _setting(name)
    L = cfg.n_layers
    want = runs["one"][name]["tape"]
    assert len(want) == 2 * L
    by_rows = {}
    for r, out in enumerate(runs["ranks"]):
        got = out[(mesh, name)]["grad"]
        tape = [idx for idx, _ in got["tape"]]
        threads = [th for _, th in got["tape"]]
        assert len(tape) == 2 * L
        assert all(th == got["thread"] for th in threads[:L])
        assert all(th != got["thread"] for th in threads[L:])
        for layer in range(L):
            np.testing.assert_array_equal(tape[2 * L - 1 - layer],
                                          tape[layer])
        first = by_rows.setdefault(out[(mesh, name)]["coord"][0], tape)
        for a, b in zip(tape, first):
            np.testing.assert_array_equal(a, b)
    for i, w in enumerate(want):
        parts = [by_rows[d][i] for d in sorted(by_rows)]
        got = parts[0] if parts[0].shape == w[0].shape \
            else np.concatenate(parts)
        np.testing.assert_array_equal(got, w[0], err_msg=f"call {i}")


def test_no_rank_loads_jax(runs):
    assert all(out["modules"] == [] for out in runs["ranks"])
