"""The dense LM train cells placed on a device mesh (``CellPlan.on_mesh``
of ``train_4k``: parameters, optimizer state and batch on their
placements, the step under the arch's ``train_rules``): a 4-rank gloo
group on the CPU on the meshes (2, 2) and (1, 4) of (data, model),
against the JAX package's partitioned train step (its
``lm_common.build_cell``: ``state_and_shardings``, ``make_train_step``,
the arch's rule preset, jitted on 4 forced CPU devices in a subprocess)
and against the port's one-device step run in the parent, on the same
inputs: each arch's smoke config (2 layers, d 64, 4 heads, 2 kv heads,
vocab 128, fp32) for granite-3-2b (AdamW), internlm2-1.8b (AdamW) and
command-r-plus-104b (Adafactor, ``residual_sp``), batch 8 x seq 64,
accumulation cut to min(the arch's, 2) as ``build_smoke`` cuts it,
parameters and batches drawn with numpy from a seed.

The (1, 4) mesh shards the 4 query heads over ``model`` while the 2 kv
heads stay replicated: each rank slices the kv head its query head reads,
and the kv projections' gradients are partial sums over ``model``.

The ranks run as on the card's gloo group: every all-gather and
reduce-scatter staged through the host's non-functional collectives
(``launch.mesh.host_staged`` patched to say so for CPU tensors), any
functional all-gather or reduce-scatter, which only DTensor's own
redistributions would issue, raises (on the card the functional
all-gather of CUDA tensors kills a gloo process), and the backward runs
on a thread of its own, as autograd runs it for CUDA tensors.

Cases: every placed argument's local shard (optimizer state included)
bit-equal to the JAX package's ``addressable_shards``; after one and two
steps the loss, the metrics, every parameter and every optimizer-state
leaf within ``tests/test_torch_train_lm.py``'s tolerances of the JAX
package's partitioned step and of the port's one-device step; the
metrics and every replicated leaf bit-equal on all ranks, and the local
shards of ranks that hold the same shard bit-equal; the gradients of the
placed leaves (before any step) each rank's slice of the one-device
gradients, the FSDP gathers' backward having reduce-scattered them;
``forward``'s logits on the placed parameters one device's; no rank
loads ``jax``.

One spawn of the group runs every case (each rank writes its results to
a file) while the parent runs the one-device steps and a subprocess the
JAX package; every collective has a timeout and the spawn a join
deadline."""
import collections
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
ARCHS = ("granite-3-2b", "internlm2-1.8b", "command-r-plus-104b")
B, S, STEPS, LR = 8, 64, 2, 1e-3
SCALAR_TOL = dict(rtol=1e-4, atol=1e-6)
COLLECTIVE_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 420.0


def _module(arch_id: str):
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))


def _setting(arch_id: str):
    """(smoke config, train setting with the accumulation cut as
    ``build_smoke`` cuts it)."""
    mod = _module(arch_id)
    return (lm_common.smoke_config(mod.CFG),
            dataclasses.replace(mod.TRAIN, accum=min(mod.TRAIN.accum, 2)))


# ------------------------------------------------------------- the inputs
def _inputs() -> dict:
    """Every arch's parameters by the rule of ``init_from_specs`` and
    STEPS batches, as numpy."""
    rng = np.random.default_rng(30)
    out = {}
    for arch_id in ARCHS:
        cfg, _ = _setting(arch_id)
        params = {}
        specs = T.param_specs(cfg)
        for path, s in _leaves(specs):
            fan_in = s.shape[0] if len(s.shape) > 1 else max(1, s.shape[-1])
            node = params
            keys = path.strip("/").split("/")
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = (rng.normal(size=s.shape) * s.init_scale
                              / np.sqrt(fan_in)).astype(np.float32)
        batches = [{k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
                    for k in ("labels", "tokens")} for _ in range(STEPS)]
        out[arch_id] = dict(params=params, batches=batches)
    return out


def _leaves(tree, path=""):
    """(path, leaf) of nested dicts (sorted keys), tuples and
    NamedTuples."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{path}/{i}")
    else:
        yield path, tree


def _plan(inp, arch_id: str):
    """The port's ``train_4k`` cell at the smoke config with these
    parameters, a fresh optimizer state, the first batch and lr (the meta
    build gives its step, logical axes and rules)."""
    cfg, train = _setting(arch_id)
    plan = lm_common.build_cell(cfg, train, "train_4k", device="meta",
                                reduced={"batch": B})
    assert plan.notes.startswith(f"accum={train.accum} ")
    params = convert.params_from_reference(inp[arch_id]["params"],
                                           device="cpu")
    opt_state = get_optimizer(train.optimizer).init(params)
    return dataclasses.replace(plan, args=(
        params, opt_state, _batch(inp, arch_id, 0), torch.tensor(LR)))


def _batch(inp, arch_id: str, i: int) -> dict:
    return {k: torch.from_numpy(v.copy())
            for k, v in inp[arch_id]["batches"][i].items()}


# ------------------------------------------------------------- the group
def _card_like() -> dict:
    """Collectives as on the card's gloo group: all-gathers and
    reduce-scatters staged through the host's non-functional collectives,
    and a functional all-gather or reduce-scatter (DTensor's own) raises.
    Returns the calls of the reduce-scatter the gathers' backward takes."""
    import torch.distributed._functional_collectives as funcol

    def refuse(name):
        def call(*args, **kwargs):
            raise AssertionError(f"a functional {name}: gloo refuses it on "
                                 f"the card's CUDA tensors")
        return call

    for name in ("all_gather_single", "all_gather_tensor",
                 "reduce_scatter_tensor", "reduce_scatter_single"):
        if hasattr(funcol, name):
            setattr(funcol, name, refuse(name))
    PM.host_staged = lambda t, mesh, i: PM._backend(mesh, i) == "gloo"
    # autograd runs the backward of CUDA tensors on a thread of its own,
    # where no thread-local context of the forward is set
    grad = torch.autograd.grad

    def grad_elsewhere(*args, **kwargs):
        got = {}

        def run():
            try:
                got["out"] = grad(*args, **kwargs)
            except BaseException as e:  # re-raised in the caller's thread
                got["err"] = e
        t = threading.Thread(target=run)
        t.start()
        t.join()
        if "err" in got:
            raise got["err"]
        return got["out"]
    torch.autograd.grad = grad_elsewhere
    calls = {"reduce_scatter": 0}
    raw = PM.reduce_scatter_raw

    def counted(*args, **kwargs):
        calls["reduce_scatter"] += 1
        return raw(*args, **kwargs)
    PM.reduce_scatter_raw = counted
    return calls


def _whole(t):
    """A DTensor gathered to a numpy array (through ``redistribute``, so
    the host-staged all-gather)."""
    from torch.distributed.tensor import Replicate

    from repro_torch.distributed.sharding import redistribute

    return redistribute(t, [Replicate()] * t.device_mesh.ndim).to_local() \
        .detach().numpy().copy()


def _shards(tree) -> dict:
    return {p: dict(local=t.to_local().detach().numpy().copy(),
                    placements=[(type(x).__name__, getattr(x, "dim", None))
                                for x in t.placements])
            for p, t in _leaves(tree)}


def _rank(rank: int, work: str) -> None:
    """One rank: every arch on both meshes (placed arguments' local
    shards, two steps' metrics, parameters and state gathered, and the
    outputs' local shards), and the placed gradients at the first state;
    to ``rank{rank}.pkl``."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import (
        RULE_SETS,
        MeshShape,
        activation_sharding,
    )

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
            for arch_id in ARCHS:
                plan = _plan(inp, arch_id)
                placed = plan.on_mesh(mesh)
                args = {p: t.to_local().numpy().copy()
                        for p, t in _leaves(placed.args)}
                # the gradients at the first state
                cfg, train = _setting(arch_id)
                params, opt_state, batch, lr = placed.args
                before = calls["reduce_scatter"]
                with activation_sharding(
                        mesh, RULE_SETS[train.train_rules or "default"]):
                    loss, _, grads = value_and_grad(
                        functools.partial(T.loss_fn, cfg=cfg), params,
                        batch)
                with torch.no_grad(), activation_sharding(
                        mesh, RULE_SETS[train.train_rules or "default"]):
                    logits = _whole(T.forward(params, batch["tokens"],
                                              cfg)[0])
                grad = dict(loss=loss.item(), logits=logits, shards=_shards(
                    tree_unflatten(params, grads)),
                    reduce_scatters=calls["reduce_scatter"] - before)
                steps = [_record(*placed.fn(*placed.args))]
                # step 2 from the JAX package's state after its step 1 on
                # this mesh, as tests/test_torch_train_lm.py goes on
                p1, o1 = _jax_step1(work)[(m, arch_id)]
                again = dataclasses.replace(plan, args=(
                    convert.params_from_reference(p1, device="cpu"),
                    convert.opt_state_from_reference(o1, device="cpu"),
                    _batch(inp, arch_id, 1), torch.tensor(LR))).on_mesh(mesh)
                steps.append(_record(*again.fn(*again.args)))
                out[(m, arch_id)] = dict(args=args, grad=grad, steps=steps,
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
    """The JAX package's (params, opt_state) after step 1, by (mesh, arch),
    as numpy, once its subprocess has written them."""
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
    meshes = pickle.loads(bytes.fromhex(sys.argv[2]))
    archs, B, S, steps, lr = pickle.loads(bytes.fromhex(sys.argv[3]))
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
    for arch_id in archs:
        mod = importlib.import_module(
            "repro.configs." + arch_id.replace("-", "_").replace(".", "_"))
        lm = mod.ARCH.build_smoke.__closure__[0].cell_contents
        lm = dataclasses.replace(lm, cfg=JL.smoke_config(lm.cfg),
                                 accum=min(lm.accum, 2))
        for m, shape_of in meshes.items():
            mesh = Mesh(np.array(jax.devices()).reshape(shape_of),
                        ("data", "model"))
            plan = JL.build_cell(lm, "train_4k", mesh)
            params = jax.tree.map(jnp.asarray, inp[arch_id]["params"])
            opt_state = get_optimizer(lm.optimizer).init(params)
            batches = inp[arch_id]["batches"]
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
            out[(m, arch_id)] = dict(shards=shards, steps=[record(p, o, met)])
            cells[(m, arch_id)] = (mesh, plan, fn, p, o)
            # the state's NamedTuple as (field names, values): unpickling
            # the JAX package's class would import JAX in the ranks
            step1[(m, arch_id)] = (jax.tree.map(np.asarray, p), (
                o._fields, tuple(jax.tree.map(np.asarray, x) for x in o)))
    with open(os.path.join(work, "jax_step1.tmp"), "wb") as f:
        pickle.dump(step1, f)
    os.replace(os.path.join(work, "jax_step1.tmp"),
               os.path.join(work, "jax_step1.pkl"))
    for (m, arch_id), (mesh, plan, fn, p, o) in cells.items():
        with mesh, activation_sharding(mesh, plan.rules):
            p, o, met = fn(p, o, inp[arch_id]["batches"][1], np.float32(lr))
        out[(m, arch_id)]["steps"].append(record(p, o, met))
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
    """Each arch's one-device steps: step 1 from the inputs, and on each
    mesh's behalf step 2 from the JAX package's state after its step 1 on
    that mesh (metrics, parameters and state after each, the parameters
    before it and its gradients)."""
    out = {}
    for arch_id in ARCHS:
        cfg, train = _setting(arch_id)
        plan = _plan(inp, arch_id)
        loss_fn = functools.partial(T.loss_fn, cfg=cfg)

        def step(params, opt_state, i):
            batch = _batch(inp, arch_id, i)
            _, _, g = value_and_grad(loss_fn, params, batch)
            before = {p: t.numpy().copy() for p, t in _leaves(params)}
            params, opt_state, metrics = plan.fn(params, opt_state, batch,
                                                 torch.tensor(LR))
            return dict(
                metrics={k: v.numpy().copy() for k, v in metrics.items()},
                params={p: t.numpy().copy() for p, t in _leaves(params)},
                state={p: t.numpy().copy() for p, t in _leaves(opt_state)},
                before=before,
                grads={p: x.numpy() for (p, _), x in zip(_leaves(params),
                                                          g)})

        with torch.no_grad():
            logits = T.forward(plan.args[0], _batch(inp, arch_id, 0)["tokens"],
                               cfg)[0].numpy()
        first = step(*plan.args[:2], 0)
        first["logits"] = logits
        for m in MESHES:
            p1, o1 = _jax_step1(work)[(m, arch_id)]
            out[(m, arch_id)] = [first, step(
                convert.params_from_reference(p1, device="cpu"),
                convert.opt_state_from_reference(o1, device="cpu"), 1)]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The group's results by rank, the one-device results and the JAX
    package's."""
    work = str(tmp_path_factory.mktemp("placed_train"))
    inp = _inputs()
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    ref = subprocess.Popen(
        [sys.executable, "-c", _JAX, work, pickle.dumps(MESHES).hex(),
         pickle.dumps((ARCHS, B, S, STEPS, LR)).hex()], env=env,
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


# --------------------------------------------- tolerances of train_lm's
def assert_leaf_close(got, want, what="", tol=1e-4):
    """Elementwise within rtol ``tol`` plus ``tol`` of the leaf's largest
    magnitude (``tests/test_torch_train_lm.py``'s)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def assert_moved_alike(got, want, before, keep, what):
    """The parameters after a step of AdamW or Adafactor, which divide each
    entry by its own RMS: each side's move from ``before`` within 1e-4 of
    itself, 1e-2 of lr and two ulps of the parameter, on the entries
    ``keep`` (``tests/test_torch_train_lm.py``'s)."""
    got, want, before = (np.asarray(x, np.float64)[keep]
                         for x in (got, want, before))
    bound = 1e-4 * np.abs(want - before) + 1e-2 * LR \
        + 2 * np.spacing(np.abs(want).astype(np.float32))
    bad = np.abs(got - want) > bound
    assert not bad.any(), (f"{what}: {int(bad.sum())} of {bad.size} entries "
                           f"moved apart, worst {np.abs(got - want).max():.3g}")


def _check_step(got, want, one_step, i, what):
    """One step's metrics, parameters and state against ``want`` (the JAX
    package's or one device's)."""
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   **SCALAR_TOL, err_msg=f"{what} {k}")
    np.testing.assert_allclose(got["metrics"]["grad_norm"],
                               want["metrics"]["grad_norm"], rtol=5e-4,
                               err_msg=f"{what} grad_norm")
    assert sorted(got["state"]) == sorted(want["state"])
    for p in want["state"]:
        assert_leaf_close(got["state"][p], want["state"][p],
                          f"{what} state {p}", tol=1e-3)
    assert sorted(got["params"]) == sorted(want["params"])
    for p in want["params"]:
        # entries whose gradient at this step's state is above 1e-5
        keep = np.abs(one_step[i]["grads"][p]) > 1e-5
        assert_moved_alike(got["params"][p], want["params"][p],
                           one_step[i]["before"][p], keep,
                           f"{what} params {p}")


# ------------------------------------------------------------- the tests
@pytest.mark.parametrize("arch_id", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_local_shards_equal_jax_addressable_shards(runs, mesh, arch_id):
    """Parameters, optimizer state (Adafactor's factored moments
    included), batch and lr: rank i's local shard is device i's."""
    want = runs["jax"][(mesh, arch_id)]["shards"]
    for r, out in enumerate(runs["ranks"]):
        got = out[(mesh, arch_id)]["args"]
        assert sorted(got) == sorted(want)
        for p in got:
            np.testing.assert_array_equal(got[p], want[p][r],
                                          err_msg=f"rank {r} {p}")


@pytest.mark.parametrize("arch_id", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_placed_steps_equal_jax_partitioned_steps(runs, mesh, arch_id):
    want = runs["jax"][(mesh, arch_id)]["steps"]
    for r, out in enumerate(runs["ranks"]):
        for i, got in enumerate(out[(mesh, arch_id)]["steps"]):
            _check_step(got, want[i], runs["one"][(mesh, arch_id)], i,
                        f"rank {r} step {i} vs jax")


@pytest.mark.parametrize("arch_id", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_placed_steps_equal_one_device(runs, mesh, arch_id):
    want = runs["one"][(mesh, arch_id)]
    for r, out in enumerate(runs["ranks"]):
        for i, got in enumerate(out[(mesh, arch_id)]["steps"]):
            _check_step(got, want[i], want, i,
                        f"rank {r} step {i} vs one device")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_replicated_outputs_are_bit_equal_on_every_rank(runs, mesh):
    """The metrics and every gathered leaf bit-equal on all ranks; ranks
    whose coordinates differ only on the mesh dims that replicate a leaf
    hold the same local bits."""
    for arch_id in ARCHS:
        outs = [out[(mesh, arch_id)] for out in runs["ranks"]]
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
            for p, x in first["shards"].items():
                sharded = [j for j, (kind, _) in enumerate(x["placements"])
                           if kind == "Shard"]
                for a in outs:
                    for b in outs:
                        if all(a["coord"][j] == b["coord"][j]
                               for j in sharded):
                            np.testing.assert_array_equal(
                                a["steps"][i]["shards"][p]["local"],
                                b["steps"][i]["shards"][p]["local"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gradients_are_slices_of_one_device(runs, mesh):
    """Before any step, each rank's gradient of every placed leaf is its
    slice of the one-device gradient, on the leaf's placements; the FSDP
    gathers' backward reduce-scattered the partial gradients."""
    from repro_torch.distributed.sharding import RULE_SETS, MeshShape, spec_for

    shape = MeshShape(("data", "model"), MESHES[mesh])
    for arch_id in ARCHS:
        cfg, train = _setting(arch_id)
        rules = RULE_SETS[train.train_rules or "default"]
        specs = dict(_leaves(T.param_specs(cfg)))
        want = runs["one"][(mesh, arch_id)][0]["grads"]
        for r, out in enumerate(runs["ranks"]):
            got = out[(mesh, arch_id)]["grad"]
            # the FSDP gathers run over data (one rank there on (1, 4)),
            # residual_sp's sequence gathers over model
            assert (got["reduce_scatters"] > 0) == (
                MESHES[mesh][0] > 1 or train.train_rules == "residual_sp")
            coord = out[(mesh, arch_id)]["coord"]
            for p, g in got["shards"].items():
                full = want[p]
                entries = spec_for(full.shape, specs[p].axes, shape, rules)
                for d, e in enumerate(entries):
                    axes = () if e is None else (
                        e if isinstance(e, tuple) else (e,))
                    idx, n = 0, 1
                    for ax in axes:
                        j = shape.axis_names.index(ax)
                        idx, n = idx * shape.shape[j] + coord[j], \
                            n * shape.shape[j]
                    size = full.shape[d] // n
                    full = full.take(range(idx * size, (idx + 1) * size),
                                     axis=d)
                assert [k for k, _ in g["placements"]] == [
                    "Shard" if any(shape.axis_names[j] in (
                        () if e is None else (e if isinstance(e, tuple)
                                              else (e,)))
                        for e in entries) else "Replicate"
                    for j in range(len(shape.shape))], (p, g["placements"])
                assert_leaf_close(g["local"], full,
                                  f"{arch_id} rank {r} grad {p}")


def test_kv_heads_replicated_on_one_by_four(runs):
    """On (1, 4) the 2 kv heads stay whole on every rank while the 4
    query heads are sharded over ``model``, and the steps still equal one
    device's (above): the projections' placements say so."""
    shards = runs["ranks"][0][("1x4", "granite-3-2b")]["steps"][0]["shards"]
    for leaf in ("wk", "wv"):
        assert shards[f"/0/layers/{leaf}"]["placements"][1] == \
            ("Replicate", None)
    assert shards["/0/layers/wq"]["placements"][1] == ("Shard", 2)


def test_no_rank_loads_jax(runs):
    assert all(out["modules"] == [] for out in runs["ranks"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_placed_forward_logits_equal_one_device(runs, mesh):
    """``forward`` (the logits entry) on the placed parameters: ``lm_head``
    gathered over its FSDP axes, each rank its vocab columns; gathered,
    the logits are one device's within 1e-4."""
    for arch_id in ARCHS:
        want = runs["one"][(mesh, arch_id)][0]["logits"]
        for r, out in enumerate(runs["ranks"]):
            np.testing.assert_allclose(
                out[(mesh, arch_id)]["grad"]["logits"], want, rtol=1e-4,
                atol=1e-4, err_msg=f"{arch_id} rank {r}")
