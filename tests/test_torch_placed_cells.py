"""The dense LM serve cells placed on a device mesh (``CellPlan.on_mesh``:
DTensor placements from the sharding rules, ``constrain`` in the model,
the flash kernels' placed entries): a 4-rank gloo group on the CPU on the
meshes (2, 2) and (1, 4) of (data, model), against the JAX package's
partitioned step (its ``lm_common.build_cell`` shardings, jitted under
``activation_sharding`` on 4 forced CPU devices in a subprocess) and
against the port's one-device step run in the parent, on the same inputs:
granite-3-2b's smoke config (2 layers, d 64, 4 heads, 2 kv heads, fp32),
parameters, tokens and caches drawn with numpy from a seed.

The (1, 4) mesh shards the query heads over ``model`` while the 2 kv heads
stay replicated (2 does not divide by 4), and shards a decode cache's rows
over ``model``: each rank then takes its partial over its rows and the
ranks' partials are merged. The B = 1 decode puts the cache's rows on
``data`` at (2, 2) and on ``model`` at (1, 4), with live rows on some
ranks only.

Cases: every argument's local shard on rank i bit-equal to the JAX
package's ``addressable_shards`` of device i; prefill, decode and the
B = 1 decode (logits, cache, lengths) within 1e-4 (rtol and atol, the
tolerance ``tests/test_torch_transformer.py`` holds the one-device step
to) of the JAX package's partitioned step and of the port's one-device
step; every output gathered bit-equal on all ranks, and the local shards
of ranks that hold the same shard bit-equal; no rank loads ``jax``. In
bf16 on (2, 2), the prefill and the B = 4 decode bit-equal to one
device's with the row-parallel products split as the ranks split them
(``chip_smoke.split_rows``: GSPMD's bf16 partials added in rank order),
which the card's serve bar takes as its floor.

One spawn of the group runs every case (each rank writes its results to a
file) while the parent runs the one-device steps and a subprocess the JAX
package; every collective has a timeout and the spawn a join deadline."""
import contextlib
import dataclasses
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
from repro_torch.configs.granite_3_2b import CFG, TRAIN  # noqa: E402
from repro_torch.launch import mesh as PM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 4
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
TOL = dict(rtol=1e-4, atol=1e-4)
COLLECTIVE_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 240.0
# (shape, batch, sequence / cache rows) of each step; decode lengths
STEPS = {"prefill_32k": (4, 16), "decode_32k": (4, 32), "long_500k": (1, 32)}
LENGTHS = {"decode_32k": [5, 17, 30, 9], "long_500k": [12]}
TCFG = lm_common.smoke_config(CFG)
# the bf16 steps on (2, 2): no cache rows sharded, so only the row-parallel
# products add in another order than one device's
BCFG = dataclasses.replace(TCFG, compute_dtype=torch.bfloat16)
BF16_STEPS = ("prefill_32k", "decode_32k")


# ------------------------------------------------------------- the inputs
def _inputs() -> dict:
    """Every step's arguments as numpy: parameters by the rule of
    ``init_from_specs`` (one tree for every step), tokens, caches."""
    rng = np.random.default_rng(29)
    params = {}

    def draw(path, s):
        fan_in = s.shape[0] if len(s.shape) > 1 else max(1, s.shape[-1])
        x = (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x

    specs = T.param_specs(TCFG)
    for k in sorted(specs):
        if k == "layers":
            for j in sorted(specs[k]):
                draw((k, j), specs[k][j])
        else:
            draw((k,), specs[k])
    steps = {}
    for shape, (B, S) in STEPS.items():
        if shape == "prefill_32k":
            steps[shape] = (rng.integers(0, TCFG.vocab, (B, S)).astype(
                np.int32),)
            continue
        kv = (TCFG.n_layers, B, TCFG.n_kv_heads, S, TCFG.head_dim)
        cache = tuple(rng.normal(size=kv).astype(np.float32)
                      for _ in range(2))
        steps[shape] = (cache, rng.integers(0, TCFG.vocab, (B,)).astype(
            np.int32), np.asarray(LENGTHS[shape], np.int32))
    return dict(params=params, steps=steps)


def _leaves(tree, path=""):
    """(path, leaf) of nested dicts (sorted keys) and tuples."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{path}/{i}")
    else:
        yield path, tree


def _torch_args(inp, shape, dtype=torch.float32):
    """The step's arguments, its caches in ``dtype``."""
    def t(x):
        if isinstance(x, tuple):
            return tuple(t(y) for y in x)
        x = torch.from_numpy(np.array(x))
        return x.to(dtype) if x.is_floating_point() else x
    return (convert.params_from_reference(inp["params"], device="cpu"),) \
        + tuple(t(x) for x in inp["steps"][shape])


def _plan(inp, shape, cfg=TCFG):
    """The port's cell of ``shape`` at ``cfg`` (the smoke config) with
    these arguments (the meta build gives its step and logical axes)."""
    plan = lm_common.build_cell(cfg, TRAIN, shape, device="meta")
    return dataclasses.replace(
        plan, args=_torch_args(inp, shape, cfg.compute_dtype))


# ------------------------------------------------------------- the group
def _rank(rank: int, work: str) -> None:
    """One rank: every step on both meshes; local shards of the placed
    arguments and outputs, the gathered outputs, to ``rank{rank}.pkl``."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import MeshShape

    torch.set_num_threads(1)
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
            for shape in STEPS:
                placed = _plan(inp, shape).on_mesh(mesh)
                args = {p: t.to_local().numpy().copy()
                        for p, t in _leaves(placed.args)}
                with torch.no_grad():
                    res = placed.fn(*placed.args)
                outs = {p: dict(local=t.to_local().numpy(),
                                placements=[(type(x).__name__,
                                             getattr(x, "dim", None))
                                            for x in t.placements],
                                full=t.full_tensor().numpy())
                        for p, t in _leaves(res)}
                out[(m, shape)] = dict(args=args, outs=outs, coord=coord)
            for shape in BF16_STEPS if m == "2x2" else ():
                placed = _plan(inp, shape, BCFG).on_mesh(mesh)
                with torch.no_grad():
                    res = placed.fn(*placed.args)
                out[("bf16", shape)] = {p: t.full_tensor().float().numpy()
                                        for p, t in _leaves(res)}
        finally:
            dist.destroy_process_group()
    out["modules"] = [k for k in sys.modules if k == "jax"
                      or k.startswith("jax.")]
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# -------------------------------------------------------- the JAX package
_JAX = textwrap.dedent("""
    import os, pickle, sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import granite_3_2b as JG, lm_common as JL
    from repro.distributed.sharding import activation_sharding

    work = sys.argv[1]
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    meshes = pickle.loads(bytes.fromhex(sys.argv[2]))
    steps = pickle.loads(bytes.fromhex(sys.argv[3]))
    cfg = JL.smoke_config(JG.ARCH.build_smoke.__closure__[0]
                          .cell_contents.cfg)
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

    out = {}
    for m, shape_of in meshes.items():
        mesh = Mesh(np.array(jax.devices()).reshape(shape_of),
                    ("data", "model"))
        for shape in steps:
            plan = JL.build_cell(JL.LMArch(cfg=cfg), shape, mesh)
            args = (inp["params"],) + tuple(inp["steps"][shape])
            shards = {}
            for (p, a), (_, sh) in zip(leaves(args),
                                       leaves(plan.in_shardings)):
                put = jax.device_put(a, sh)
                shards[p] = {s.device.id: np.asarray(s.data)
                             for s in put.addressable_shards}
            fn = jax.jit(plan.fn, in_shardings=plan.in_shardings,
                         out_shardings=plan.out_shardings)
            with mesh, activation_sharding(mesh, plan.rules):
                res = fn(*args)
            out[(m, shape)] = dict(
                shards=shards,
                outs={p: np.asarray(t) for p, t in leaves(res)})
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The group's results by rank, the one-device results and the JAX
    package's."""
    work = str(tmp_path_factory.mktemp("placed_cells"))
    inp = _inputs()
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    ref = subprocess.Popen(
        [sys.executable, "-c", _JAX, work, pickle.dumps(MESHES).hex(),
         pickle.dumps(STEPS).hex()], env=env, stdout=subprocess.PIPE,
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
        one = {}
        for shape in STEPS:
            plan = _plan(inp, shape)
            with torch.no_grad():
                res = plan.fn(*plan.args)
            one[shape] = {p: x.numpy() for p, x in _leaves(res)}
        bf16 = _one_device_bf16(inp)
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
    return dict(ranks=ranks, one=one, jax=jx, inp=inp, bf16=bf16)


def _one_device_bf16(inp) -> dict:
    """The bf16 steps on one device, as they are and with the row-parallel
    products split as (2, 2)'s ranks split them."""
    sys.path.insert(0, os.path.abspath(os.path.join(SRC, "..")))
    import chip_smoke

    out = {}
    for split in (False, True):
        rows = mock.patch.object(
            T, "_row_product",
            chip_smoke.split_rows(torch, MESHES["2x2"][1])) if split \
            else contextlib.nullcontext()
        for shape in BF16_STEPS:
            plan = _plan(inp, shape, BCFG)
            with rows, torch.no_grad():
                res = plan.fn(*plan.args)
            out[(split, shape)] = {p: x.float().numpy()
                                   for p, x in _leaves(res)}
    return out


# ------------------------------------------------------------- the tests
@pytest.mark.parametrize("shape", list(STEPS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_local_shards_equal_jax_addressable_shards(runs, mesh, shape):
    want = runs["jax"][(mesh, shape)]["shards"]
    for r, out in enumerate(runs["ranks"]):
        got = out[(mesh, shape)]["args"]
        assert sorted(got) == sorted(want)
        for p in got:
            np.testing.assert_array_equal(got[p], want[p][r],
                                          err_msg=f"rank {r} {p}")


@pytest.mark.parametrize("shape", list(STEPS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_placed_step_equals_jax_partitioned_step(runs, mesh, shape):
    want = runs["jax"][(mesh, shape)]["outs"]
    for r, out in enumerate(runs["ranks"]):
        got = out[(mesh, shape)]["outs"]
        assert sorted(got) == sorted(want)
        for p in got:
            np.testing.assert_allclose(got[p]["full"], want[p], **TOL,
                                       err_msg=f"rank {r} {p}")


@pytest.mark.parametrize("shape", list(STEPS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_placed_step_equals_one_device(runs, mesh, shape):
    want = runs["one"][shape]
    for r, out in enumerate(runs["ranks"]):
        got = out[(mesh, shape)]["outs"]
        for p in want:
            np.testing.assert_allclose(got[p]["full"], want[p], **TOL,
                                       err_msg=f"rank {r} {p}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_replicated_outputs_are_bit_equal_on_every_rank(runs, mesh):
    for shape in STEPS:
        outs = [out[(mesh, shape)] for out in runs["ranks"]]
        for p in outs[0]["outs"]:
            for o in outs[1:]:
                np.testing.assert_array_equal(o["outs"][p]["full"],
                                              outs[0]["outs"][p]["full"])
            # ranks whose coordinates differ only on the mesh dims that
            # replicate the output hold the same local bits
            sharded = [i for i, (kind, _) in enumerate(outs[0]["outs"][p][
                "placements"]) if kind == "Shard"]
            for a in outs:
                for b in outs:
                    if all(a["coord"][i] == b["coord"][i] for i in sharded):
                        np.testing.assert_array_equal(
                            a["outs"][p]["local"], b["outs"][p]["local"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sequence_sharded_decode_with_an_empty_rank(runs, mesh):
    """The B = 1 decode's cache rows lie on several ranks, some of which
    hold no live row; the step still equals one device's."""
    out = runs["ranks"][0][(mesh, "long_500k")]["outs"]
    cache_pl = out["/1/0"]["placements"]
    seq = [i for i, pl in enumerate(cache_pl) if pl == ("Shard", 3)]
    assert seq, cache_pl
    S = STEPS["long_500k"][1]
    n = int(np.prod([MESHES[mesh][i] for i in seq]))
    live = LENGTHS["long_500k"][0] + 1
    assert live < S - S // n        # the last rank of the rows holds none
    want = runs["one"]["long_500k"]
    for r, o in enumerate(runs["ranks"]):
        got = o[(mesh, "long_500k")]["outs"]
        for p in want:
            np.testing.assert_allclose(got[p]["full"], want[p], **TOL,
                                       err_msg=f"rank {r} {p}")


@pytest.mark.parametrize("shape", BF16_STEPS)
def test_bf16_placed_step_is_one_device_with_split_row_products(runs,
                                                                shape):
    """In bf16 each rank's row-parallel product is a bf16 partial and the
    all-reduce adds the partials in bf16, as GSPMD does: the placed step
    on (2, 2) is bit for bit one device's with those products split at the
    ranks' halves (``chip_smoke.split_rows``), on every rank, and its
    logits are not one device's unsplit step's."""
    want = runs["bf16"][(True, shape)]
    for r, out in enumerate(runs["ranks"]):
        got = out[("bf16", shape)]
        assert sorted(got) == sorted(want)
        for p in want:
            np.testing.assert_array_equal(got[p], want[p],
                                          err_msg=f"rank {r} {p}")
    assert not np.array_equal(want["/0"], runs["bf16"][(False, shape)]["/0"])


def test_no_rank_loads_jax(runs):
    assert all(out["modules"] == [] for out in runs["ranks"])
