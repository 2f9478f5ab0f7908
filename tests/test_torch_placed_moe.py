"""The MoE LM serve cells placed on a device mesh (``CellPlan.on_mesh``:
the ``"expert"`` / ``"act_expert"`` placements through both dispatches):
a 4-rank gloo group on the CPU on the meshes (2, 2) and (1, 4) of (data,
model), against the JAX package's partitioned step (its
``lm_common.build_cell`` shardings, jitted under ``activation_sharding``
on 4 forced CPU devices in a subprocess) and against the port's
one-device step run in the parent, on the same inputs: dbrx-132b's smoke
config (sort dispatch, 4 experts top-2), the same with
``moe_impl="einsum"``, and arctic-480b's (sort dispatch plus the dense
residual FFN), and dbrx's with 6 experts (replicated on (1, 4) by the
divisibility guard); 2 layers, d 64, 4 heads, 2 kv heads, fp32;
parameters, tokens and caches drawn with numpy from a seed.

On (2, 2) each rank holds 2 of the 4 experts and half the batch rows; on
(1, 4) one expert and every row. The ranks run as on the card's gloo
group (``tests/test_torch_placed_train.py``'s ``_card_like``): every
all-gather staged through the host, and a functional all-gather or
reduce-scatter (only DTensor's own redistributions issue them) raises.

Cases: every argument's local shard on rank i (the expert leaves
included) bit-equal to the JAX package's ``addressable_shards`` of device
i; prefill, decode and the B = 1 decode (logits, cache, lengths) within
1e-4 (rtol and atol) of the JAX package's partitioned step and of the
port's one-device step; each layer's routing (``gate_idx``) bit-equal on
the ranks that hold the same rows, and the ranks' rows together the
one-device step's; every output bit-equal on all ranks; in bf16 on (2, 2)
dbrx's sort prefill bit-equal to one device's with the attention's
row-parallel product split as the ranks split it
(``chip_smoke.split_rows``; the MoE output is gathered, not summed); no
rank loads ``jax``; the
port's collective bytes a device printed beside the JAX package's
compiled step's (``pytest -s -k beside``).

One spawn of the group runs every case (each rank writes its results to a
file) while the parent runs the one-device steps and a subprocess the JAX
package; every collective has a timeout and the spawn a join deadline."""
import contextlib
import dataclasses
import importlib
import os
import pickle
import subprocess
import sys
import textwrap
import threading
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import lm_common  # noqa: E402
from repro_torch.launch import mesh as PM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 4
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
TOL = dict(rtol=1e-4, atol=1e-4)
COLLECTIVE_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 420.0
# config name -> (the arch's config module, fields replaced in its smoke
# config)
CONFIGS = {"dbrx": ("dbrx_132b", {}),
           "dbrx_einsum": ("dbrx_132b", {"moe_impl": "einsum"}),
           "arctic": ("arctic_480b", {}),
           # 6 experts: 3 a rank on (2, 2); on (1, 4) the divisibility
           # guard replicates them, and no expert output is gathered
           "dbrx_6_experts": ("dbrx_132b", {"n_experts": 6})}
# (shape, batch, sequence / cache rows) of each step; decode lengths
STEPS = {"prefill_32k": (4, 16), "decode_32k": (4, 32), "long_500k": (1, 32)}
LENGTHS = {"decode_32k": [5, 17, 30, 9], "long_500k": [12]}
BF16 = ("dbrx", "prefill_32k")


def _cfg(name: str, dtype=torch.float32):
    mod, fields = CONFIGS[name]
    arch = importlib.import_module(f"repro_torch.configs.{mod}")
    return dataclasses.replace(lm_common.smoke_config(arch.CFG),
                               compute_dtype=dtype, **fields), arch.TRAIN


# ------------------------------------------------------------- the inputs
def _inputs() -> dict:
    """Each config's parameters by the rule of ``init_from_specs`` and
    every step's other arguments, as numpy."""
    rng = np.random.default_rng(31)
    out = {}
    for name in CONFIGS:
        cfg, _ = _cfg(name)
        params = {}
        for path, s in _leaves(T.param_specs(cfg)):
            fan_in = s.shape[0] if len(s.shape) > 1 else max(1, s.shape[-1])
            node = params
            keys = path.strip("/").split("/")
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = (rng.normal(size=s.shape) * s.init_scale
                              / np.sqrt(fan_in)).astype(np.float32)
        steps = {}
        for shape, (B, S) in STEPS.items():
            if shape == "prefill_32k":
                steps[shape] = (rng.integers(0, cfg.vocab, (B, S)).astype(
                    np.int32),)
                continue
            kv = (cfg.n_layers, B, cfg.n_kv_heads, S, cfg.head_dim)
            cache = tuple(rng.normal(size=kv).astype(np.float32)
                          for _ in range(2))
            steps[shape] = (cache, rng.integers(0, cfg.vocab, (B,)).astype(
                np.int32), np.asarray(LENGTHS[shape], np.int32))
        out[name] = dict(params=params, steps=steps)
    return out


def _leaves(tree, path=""):
    """(path, leaf) of nested dicts (sorted keys) and tuples."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{path}/{i}")
    else:
        yield path, tree


def _plan(inp, name: str, shape: str, dtype=torch.float32):
    """The port's cell of ``shape`` at the config ``name`` with these
    arguments (its caches in the compute dtype)."""
    cfg, train = _cfg(name, dtype)
    plan = lm_common.build_cell(cfg, train, shape, device="meta")

    def t(x):
        if isinstance(x, tuple):
            return tuple(t(y) for y in x)
        x = torch.from_numpy(np.array(x))
        return x.to(dtype) if x.is_floating_point() else x

    return dataclasses.replace(plan, args=(
        convert.params_from_reference(inp[name]["params"], device="cpu"),)
        + tuple(t(x) for x in inp[name]["steps"][shape]))


@contextlib.contextmanager
def _routing(tape: list):
    """Every routing of the block appends its ``gate_idx`` to ``tape``."""
    route = T._route

    def taped(x, router, k):
        got = route(x, router, k)
        tape.append(got[2].numpy().copy())
        return got

    with mock.patch.object(T, "_route", taped):
        yield


# ------------------------------------------------------------- the group
def _rank(rank: int, work: str) -> None:
    """One rank: every config and step on both meshes (placed arguments'
    local shards, outputs, routing) and dbrx's bf16 prefill on (2, 2); to
    ``rank{rank}.pkl``."""
    import torch.distributed as dist
    from test_torch_placed_train import _card_like

    from repro_torch.distributed.sharding import MeshShape

    torch.set_num_threads(1)
    _card_like()
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
                for shape in STEPS:
                    placed = _plan(inp, name, shape).on_mesh(mesh)
                    args = {p: t.to_local().numpy().copy()
                            for p, t in _leaves(placed.args)}
                    tape = []
                    with torch.no_grad(), _routing(tape):
                        res = placed.fn(*placed.args)
                    outs = {p: dict(local=t.to_local().numpy(),
                                    placements=[(type(x).__name__,
                                                 getattr(x, "dim", None))
                                                for x in t.placements])
                            for p, t in _leaves(res)}
                    out[(m, name, shape)] = dict(args=args, outs=outs,
                                                 coord=coord, tape=tape)
                # gathered for the comparisons, once every rank is past
                # the steps (through the host-staged all-gather)
                for shape in STEPS:
                    for p, o in out[(m, name, shape)]["outs"].items():
                        o["full"] = _full(o["local"], o["placements"], mesh)
            if m == "2x2":
                placed = _plan(inp, *BF16, dtype=torch.bfloat16).on_mesh(mesh)
                with torch.no_grad():
                    res = placed.fn(*placed.args)
                out["bf16"] = {p: _full(t.to_local(), [
                    (type(x).__name__, getattr(x, "dim", None))
                    for x in t.placements], mesh).float().numpy()
                    for p, t in _leaves(res)}
        finally:
            dist.destroy_process_group()
    out["modules"] = [k for k in sys.modules if k == "jax"
                      or k.startswith("jax.")]
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _full(local, placements, mesh):
    """A local shard with ``placements`` gathered whole (numpy in, or a
    tensor in and out)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import from_local, redistribute

    as_np = isinstance(local, np.ndarray)
    t = torch.from_numpy(local) if as_np else local
    pl = [Shard(d) if kind == "Shard" else Replicate()
          for kind, d in placements]
    shape = list(t.shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            shape[p.dim] *= mesh.size(i)
    whole = redistribute(from_local(t, mesh, pl, shape),
                         [Replicate()] * mesh.ndim).to_local()
    return whole.numpy().copy() if as_np else whole


# -------------------------------------------------------- the JAX package
_JAX = textwrap.dedent("""
    import dataclasses, importlib, os, pickle, sys
    import numpy as np
    import jax
    from jax.sharding import Mesh
    from repro.configs import lm_common as JL
    from repro.distributed.sharding import activation_sharding

    work = sys.argv[1]
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    meshes, configs, steps = pickle.loads(bytes.fromhex(sys.argv[2]))
    for shape, (B, S) in steps.items():
        JL.SHAPE_DEFS[shape] = dict(JL.SHAPE_DEFS[shape], batch=B, seq=S)

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], path + "/" + k)
        elif isinstance(tree, (list, tuple)):
            for i, t in enumerate(tree):
                yield from leaves(t, path + "/" + str(i))
        else:
            yield path, tree

    jax.devices()   # 4 forced devices, before the dry run's module sets
    from repro.launch.dryrun import collective_bytes   # its own count
    out = {}
    for name, (mod, fields) in configs.items():
        lm = importlib.import_module("repro.configs." + mod) \\
            .ARCH.build_smoke.__closure__[0].cell_contents
        lm = JL.LMArch(cfg=dataclasses.replace(JL.smoke_config(lm.cfg),
                                               **fields))
        for m, shape_of in meshes.items():
            mesh = Mesh(np.array(jax.devices()).reshape(shape_of),
                        ("data", "model"))
            for shape in steps:
                plan = JL.build_cell(lm, shape, mesh)
                args = (inp[name]["params"],) + tuple(inp[name]["steps"][shape])
                shards = {}
                for (p, a), (_, sh) in zip(leaves(args),
                                           leaves(plan.in_shardings)):
                    put = jax.device_put(a, sh)
                    shards[p] = {s.device.id: np.asarray(s.data)
                                 for s in put.addressable_shards}
                fn = jax.jit(plan.fn, in_shardings=plan.in_shardings,
                             out_shardings=plan.out_shardings)
                with mesh, activation_sharding(mesh, plan.rules):
                    step = fn.lower(*args).compile()
                    res = step(*args)
                out[(m, name, shape)] = dict(
                    shards=shards,
                    outs={p: np.asarray(t) for p, t in leaves(res)},
                    collectives=collective_bytes(step.as_text()))
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


def _one_device(inp) -> dict:
    """Every config's steps on one device (outputs and routing), and
    dbrx's bf16 prefill as it is and with the row-parallel products split
    as (2, 2)'s ranks split them."""
    sys.path.insert(0, os.path.abspath(os.path.join(SRC, "..")))
    import chip_smoke

    out = {}
    for name in CONFIGS:
        for shape in STEPS:
            plan = _plan(inp, name, shape)
            tape = []
            with torch.no_grad(), _routing(tape):
                res = plan.fn(*plan.args)
            out[(name, shape)] = dict(outs={p: x.numpy()
                                            for p, x in _leaves(res)},
                                      tape=tape)
    for split in (False, True):
        rows = mock.patch.object(
            T, "_row_product",
            chip_smoke.split_rows(torch, MESHES["2x2"][1])) if split \
            else contextlib.nullcontext()
        plan = _plan(inp, *BF16, dtype=torch.bfloat16)
        with rows, torch.no_grad():
            res = plan.fn(*plan.args)
        out[("bf16", split)] = {p: x.float().numpy()
                                for p, x in _leaves(res)}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The group's results by rank, the one-device results and the JAX
    package's."""
    work = str(tmp_path_factory.mktemp("placed_moe"))
    inp = _inputs()
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    ref = subprocess.Popen(
        [sys.executable, "-c", _JAX, work,
         pickle.dumps((MESHES, CONFIGS, STEPS)).hex()], env=env,
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
        one = _one_device(inp)
    finally:
        t.join()
        log, _ = ref.communicate(timeout=JOIN_TIMEOUT_S)
    if errors:
        raise errors[0]
    assert ref.returncode == 0, log
    counted = _counted(inp)
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    with open(os.path.join(work, "jax.pkl"), "rb") as f:
        jx = pickle.load(f)
    return dict(ranks=ranks, one=one, jax=jx, counted=counted)


def _counted(inp) -> dict:
    """The port's collective bytes of every config and step on each mesh
    (``dryrun.collective_bytes``: the step on meta tensors over a fake
    group of the mesh's ranks), after the group has ended."""
    from torch.utils._pytree import tree_map

    from repro_torch.distributed.sharding import MeshShape
    from repro_torch.launch import dryrun

    out = {}
    for name in CONFIGS:
        for shape in STEPS:
            plan = _plan(inp, name, shape)
            plan = dataclasses.replace(plan, args=tree_map(
                lambda t: t.to("meta"), plan.args))
            for m, shape_of in MESHES.items():
                out[(m, name, shape)] = dryrun.collective_bytes(
                    plan, MeshShape(("data", "model"), shape_of))[0]
    return out


# ------------------------------------------------------------- the tests
CASES = [(n, m, s) for n in CONFIGS for m in MESHES for s in STEPS]


@pytest.mark.parametrize("name,mesh,shape", CASES)
def test_local_shards_equal_jax_addressable_shards(runs, name, mesh, shape):
    want = runs["jax"][(mesh, name, shape)]["shards"]
    assert any("/we_gate" in p for p in want)
    for r, out in enumerate(runs["ranks"]):
        got = out[(mesh, name, shape)]["args"]
        assert sorted(got) == sorted(want)
        for p in got:
            np.testing.assert_array_equal(got[p], want[p][r],
                                          err_msg=f"rank {r} {p}")


@pytest.mark.parametrize("name,mesh,shape", CASES)
def test_placed_step_equals_jax_partitioned_step(runs, name, mesh, shape):
    want = runs["jax"][(mesh, name, shape)]["outs"]
    for r, out in enumerate(runs["ranks"]):
        got = out[(mesh, name, shape)]["outs"]
        assert sorted(got) == sorted(want)
        for p in got:
            np.testing.assert_allclose(got[p]["full"], want[p], **TOL,
                                       err_msg=f"rank {r} {p}")


@pytest.mark.parametrize("name,mesh,shape", CASES)
def test_placed_step_equals_one_device(runs, name, mesh, shape):
    want = runs["one"][(name, shape)]["outs"]
    for r, out in enumerate(runs["ranks"]):
        got = out[(mesh, name, shape)]["outs"]
        for p in want:
            np.testing.assert_allclose(got[p]["full"], want[p], **TOL,
                                       err_msg=f"rank {r} {p}")


@pytest.mark.parametrize("name,mesh,shape", CASES)
def test_routing_is_the_one_device_routing_on_every_rank(runs, name, mesh,
                                                         shape):
    """Each layer's ``gate_idx``: bit-equal on the ranks that hold the
    same batch rows (the same data coordinate), and the data ranks' rows
    in order the one-device step's."""
    outs = [out[(mesh, name, shape)] for out in runs["ranks"]]
    want = runs["one"][(name, shape)]["tape"]
    cfg, _ = _cfg(name)
    assert len(want) == cfg.n_layers
    by_rows = {}
    for o in outs:
        assert len(o["tape"]) == len(want)
        first = by_rows.setdefault(o["coord"][0], o["tape"])
        for a, b in zip(o["tape"], first):
            np.testing.assert_array_equal(a, b)
    for layer, w in enumerate(want):
        parts = [by_rows[d][layer] for d in sorted(by_rows)]
        got = parts[0] if parts[0].shape == w.shape \
            else np.concatenate(parts)
        np.testing.assert_array_equal(got, w, err_msg=f"layer {layer}")


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_outputs_are_bit_equal_on_every_rank(runs, mesh, name):
    for shape in STEPS:
        outs = [out[(mesh, name, shape)] for out in runs["ranks"]]
        for p in outs[0]["outs"]:
            for o in outs[1:]:
                np.testing.assert_array_equal(o["outs"][p]["full"],
                                              outs[0]["outs"][p]["full"])


def test_bf16_sort_prefill_is_one_device_with_split_row_products(runs):
    """In bf16 on (2, 2) dbrx's sort prefill is bit for bit one device's
    with the attention's out product split at the ranks' halves
    (``chip_smoke.split_rows``, the partials added in bf16 in rank
    order): the experts' outputs are gathered, not summed, so the MoE FFN
    adds no other reassociation; and its logits are not one device's
    unsplit step's."""
    want = runs["one"][("bf16", True)]
    for r, out in enumerate(runs["ranks"]):
        got = out["bf16"]
        assert sorted(got) == sorted(want)
        for p in want:
            np.testing.assert_array_equal(got[p], want[p],
                                          err_msg=f"rank {r} {p}")
    assert not np.array_equal(want["/0"], runs["one"][("bf16", False)]["/0"])


def test_no_rank_loads_jax(runs):
    assert all(out["modules"] == [] for out in runs["ranks"])


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_collective_bytes_beside_the_jax_package(runs, mesh, name):
    """The port's collective bytes a device of each step (counted on a
    fake group) printed beside those of the JAX package's compiled
    partitioned step (its dry run's ``collective_bytes`` of the HLO), kind
    by kind. Printed, not compared: GSPMD on the CPU picks its own
    strategies (the sort's pick from the expert-sharded ``y`` as an
    all-reduce over ``model`` of each row's picked outputs, where the port
    all-gathers ``y``; at the B = 1 decode no weight gathered). Both steps
    move something."""
    for shape in STEPS:
        got = runs["counted"][(mesh, name, shape)]
        jx = {k: v for k, v in runs["jax"][(mesh, name, shape)]
              ["collectives"].items() if v}
        print(f"{name} {mesh} {shape}: port "
              f"{ {k: got[k] for k in sorted(got)} }, JAX package "
              f"{ {k: jx[k] for k in sorted(jx)} }")
        assert sum(got.values()) > 0 and sum(jx.values()) > 0
