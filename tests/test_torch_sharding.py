"""The port's sharding rules and mesh shapes against the JAX package's:
``spec_for`` gives the JAX package's ``PartitionSpec`` entries for every
parameter leaf of every cell, on both production meshes and under every
rule set (the JAX side reads a stand-in mesh: its ``spec_for`` reads only
``axis_names`` and ``devices.shape``); the placements' per-device shapes
follow; and the JAX package's own sharding tests, mirrored."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as J  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
import repro_torch.configs as P  # noqa: E402
from repro_torch.distributed import sharding as PS  # noqa: E402
from repro_torch.launch import mesh as PM  # noqa: E402
from repro_torch.models.common import ParamSpec  # noqa: E402

CELLS = J.all_cells()
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def _jax_mesh(names, shape):
    """What the JAX package's spec_for reads of a mesh."""
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))


def _param_specs(arch_id, shape):
    """The parameter specs of a cell (its placed ones: NequIP's
    single-graph shapes replicate them, as the JAX package does)."""
    return P.get_arch(arch_id).ARCH.build(shape, device="meta").arg_axes[0]


def _leaves(tree, path=""):
    if isinstance(tree, ParamSpec):
        yield path, tree
    else:
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")


@pytest.mark.parametrize("rules", list(PS.RULE_SETS))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch_id,shape", CELLS)
def test_spec_for_equals_jax(arch_id, shape, mesh, rules):
    names, sizes = MESHES[mesh]
    pm, jm = PS.MeshShape(names, sizes), _jax_mesh(names, sizes)
    p_rules, j_rules = PS.RULE_SETS[rules], JS.RULE_SETS[rules]
    assert p_rules == j_rules
    specs = _param_specs(arch_id, shape)
    placed = PS.param_placements(specs, pm, p_rules)
    n = 0
    for path, s in _leaves(specs):
        want = tuple(JS.spec_for(s.shape, s.axes, jm, j_rules))
        got = PS.spec_for(s.shape, s.axes, pm, p_rules)
        assert got == want, path
        # the per-device shape: each dim over the product of its axes
        pl = placed
        for k in path.strip("/").split("/"):
            pl = pl[k]
        div = [int(np.prod([dict(zip(names, sizes))[a] for a in
                            ((e,) if isinstance(e, str) else (e or ()))]))
               for e in want]
        assert pl.local_shape == tuple(d // q for d, q in zip(s.shape, div))
        n += 1
    assert n > 0


def test_rule_sets_equal_jax():
    assert PS.RULE_SETS == JS.RULE_SETS
    assert PS.DEFAULT_RULES == JS.DEFAULT_RULES


# ------------------------------------ tests/test_substrate.py, mirrored
def test_spec_for_divisibility_guard():
    mesh = PM.make_host_mesh()
    # 1-device mesh: everything divisible, axes of size 1
    s = PS.spec_for((8, 16), ("embed", "vocab"), mesh)
    assert len(s) == 2


def test_spec_for_drops_nondividing_axis():
    mesh = PS.MeshShape(("data",), (1,))
    assert PS.spec_for((7,), ("vocab",), mesh) == (None,)   # no 'model'
    # 7 rows over a 16-way model axis: replicated
    assert PS.spec_for((7, 32), ("vocab", "mlp"),
                       PM.make_production_mesh()) == (None, "model")


def test_param_spec_validation():
    with pytest.raises(ValueError):
        ParamSpec((4, 4), ("embed",))


# ------------------------------------------------------------------ meshes
def test_production_meshes_match_jax_shapes():
    assert PM.make_production_mesh() == PS.MeshShape(("data", "model"),
                                                     (16, 16))
    multi = PM.make_production_mesh(multi_pod=True)
    assert multi.axis_names == ("pod", "data", "model")
    assert multi.shape == (2, 16, 16) and multi.size == 512
    assert PM.make_host_mesh().shape == (1, 1)
    assert PM.SHARD_AXIS == "shard"


def test_shard_mesh_needs_enough_ranks(tmp_path):
    import torch.distributed as dist

    assert PM.make_shard_mesh(1) is None       # not initialised
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        # a rank of the group: the shard mesh, with its rank, device and
        # the device its collectives stage on (the CPU under gloo)
        m = PM.make_shard_mesh(1, device="cpu")
        assert isinstance(m, PS.MeshShape)
        assert (m.axis_names, m.shape) == (("shard",), (1,))
        cpu = torch.device("cpu")
        assert (m.rank, m.world, m.device, m.comm, m.backend) == \
            (0, 1, cpu, cpu, "gloo")
        assert PM.make_shard_mesh(2) is None
    finally:
        dist.destroy_process_group()


def test_placed_bytes_and_explain():
    mesh = PM.make_production_mesh()
    plan = P.get_arch("granite-3-2b").ARCH.build("decode_32k", device="meta")
    specs = plan.arg_axes[0]
    params = sum(pl.bytes_per_device for _, pl in _placed_leaves(
        PS.param_placements(specs, mesh)))
    text = PS.explain_sharding(specs, mesh)
    assert text.splitlines()[-1] == \
        f"TOTAL per-device param bytes: {params / 1e9:.2f} GB"
    # the (40, 128, 8, 32768, 64) bf16 cache: batch over data, kv heads
    # over model (8 of 16 do not divide: replicated), sequence over model
    cache = 40 * 128 * 8 * 32768 * 64 * 2 // (16 * 16)
    total = PS.placed_bytes(plan.args, plan.arg_axes, mesh)
    assert total == params + 2 * cache + 2 * (128 // 16) * 4


def _placed_leaves(tree, path=""):
    if isinstance(tree, PS.Placement):
        yield path, tree
    else:
        for k in sorted(tree):
            yield from _placed_leaves(tree[k], f"{path}/{k}")


# ------------------------------------------------ placing on a device mesh
def test_placements_for_shards_a_dim_by_each_of_its_axes_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    got = PS.placements_for((("pod", "data"), None, "model"), mesh)
    assert got == (Shard(0), Shard(0), Shard(2))
    assert PS.placements_for((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        PS.placements_for((("data", "pod"),), mesh)


def test_constrain_is_the_identity_outside_a_context():
    x = torch.ones(4, 3)
    assert PS.constrain(x, ("act_batch", "act_embed")) is x
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    with PS.activation_sharding(mesh):
        assert PS.current_sharding()[1] is PS.DEFAULT_RULES
        with pytest.raises(TypeError, match="DTensor"):
            PS.constrain(x, ("act_batch", "act_embed"))
        with PS.no_constrain():
            assert PS.constrain(x, ("act_batch", "act_embed")) is x
    assert PS.current_sharding() is None


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_place_gives_the_placements_local_shapes(shape):
    """Every granite-3-2b decode_32k argument placed on a fake (data, model)
    group (meta tensors): its local shape is ``placement_for``'s, its
    placements ``placements_for``'s of ``spec_for``'s entries."""
    import torch.distributed as dist

    plan = P.get_arch("granite-3-2b").ARCH.build("decode_32k", device="meta")
    ms = PS.MeshShape(("data", "model"), shape)
    with PM.fake_group(ms.size):
        mesh = PM.make_device_mesh(ms, fake=True)
        placed = PS.place(plan.args, plan.arg_axes, mesh)
        leaves = list(zip(_arg_leaves(plan.args, plan.arg_axes),
                          _arg_leaves(placed, plan.arg_axes)))
        assert leaves
        for (full, ax), (dt, _) in leaves:
            pl = PS.placement_for(full.shape, full.dtype, ax, ms)
            assert tuple(dt.to_local().shape) == pl.local_shape
            assert tuple(dt.shape) == tuple(full.shape)
            assert tuple(dt.placements) == PS.placements_for(pl.spec, mesh)
            assert dt.to_local().is_meta
    assert not dist.is_initialized()


def _arg_leaves(tree, axes):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _arg_leaves(tree[k], axes[k])
    elif isinstance(tree, (list, tuple)):
        for t, a in zip(tree, axes):
            yield from _arg_leaves(t, a)
    else:
        ax = axes.axes if isinstance(axes, ParamSpec) else axes
        yield tree, ax
