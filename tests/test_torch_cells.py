"""The port's cell registry against the JAX package's: the same 40 (arch x
shape) cells in the same order; every cell's full-size build on the meta
device has the JAX plan's arguments leaf for leaf (shape and dtype, hence
the same total bytes) and holds no storage; the optimizer-state specs of
AdamW, Adafactor and SGD equal the JAX package's and what the port's
optimizers make."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as J  # noqa: E402
from repro.configs.cell import opt_state_specs as j_opt_state_specs  # noqa: E402
from repro.configs.graphcast import CFG as J_GC_CFG  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import transformer as J_T  # noqa: E402
from repro.models.common import ParamSpec as JParamSpec  # noqa: E402
from repro.models.gnn import graphcast as J_GCM  # noqa: E402
from repro.train.optimizer import get_optimizer as j_get_optimizer  # noqa: E402
import repro_torch.configs as P  # noqa: E402
from repro_torch.configs import cell, lm_common  # noqa: E402
from repro_torch.configs import graphcast as T_GC  # noqa: E402
from repro_torch.models import transformer as T_T  # noqa: E402
from repro_torch.models.common import ParamSpec, init_from_specs  # noqa: E402
from repro_torch.models.gnn import graphcast as T_GCM  # noqa: E402
from repro_torch.train.optimizer import get_optimizer, tree_leaves  # noqa: E402

CELLS = J.all_cells()
# the notes that differ by design: the JAX package runs NequIP's
# single-graph shapes through its shard_map forward over a mesh of devices;
# on one card the port runs forward_energy (energy only) and says so
NOTES_DIFFER = {("nequip", s): "shard_map forward -> forward_energy"
                for s in ("full_graph_sm", "minibatch_lg", "ogb_products")}


@pytest.fixture(scope="module")
def host_mesh():
    return make_host_mesh()


def _jax_leaves(tree):
    return [(tuple(x.shape), np.dtype(x.dtype).name)
            for x in jax.tree_util.tree_leaves(tree)]


def _port_leaves(tree):
    return [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for t in cell.tree_tensors(tree)]


def test_all_cells_equal_jax():
    assert P.all_cells() == CELLS
    assert len(CELLS) == 40
    assert P.ARCH_IDS == J.ARCH_IDS
    for a in P.ARCH_IDS + ["eagr"]:
        assert P.get_arch(a).ARCH.shapes == J.get_arch(a).shapes, a
        assert P.get_arch(a).ARCH.family == J.get_arch(a).family, a


@pytest.mark.parametrize("arch_id,shape", CELLS)
def test_meta_build_matches_jax_plan(arch_id, shape, host_mesh):
    jp = J.get_arch(arch_id).build(shape, host_mesh)
    pp = P.get_arch(arch_id).ARCH.build(shape, device="meta")
    want, got = _jax_leaves(jp.args), _port_leaves(pp.args)
    assert got == want
    nbytes = sum(int(np.prod(s)) * np.dtype(jnp.dtype(d)).itemsize
                 for s, d in want)
    assert cell.tree_bytes(pp.args) == nbytes
    # nothing allocated: every argument is a meta tensor
    assert all(t.device.type == "meta" for t in cell.tree_tensors(pp.args))
    assert pp.kind == jp.kind and pp.arch_id == jp.arch_id
    assert pp.reduced == {}
    if (arch_id, shape) not in NOTES_DIFFER:
        assert pp.notes == jp.notes


def test_meta_builds_hold_no_storage():
    """A meta tensor has no data (a null pointer), and building every cell
    (some 9 TB of arguments in all) leaves the process's peak resident
    memory where it was but for a few hundred MB."""
    import resource

    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    total = 0
    for a, s in CELLS:
        for t in cell.tree_tensors(P.get_arch(a).ARCH.build(
                s, device="meta").args):
            assert t.is_meta and t.data_ptr() == 0
            total += t.numel() * t.element_size()
    grown_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    assert total > 5e12
    assert grown_kb < 300_000


def test_reduced_build_cuts_batch_and_depth():
    pp = P.get_arch("granite-3-2b").ARCH.build(
        "train_4k", device="meta", reduced={"batch": 8, "n_layers": 2})
    params, _, batch, _ = pp.args
    assert batch["tokens"].shape == (8, 4096)
    assert params["layers"]["wq"].shape[0] == 2
    assert pp.reduced == {"batch": 8, "n_layers": 2}
    assert pp.notes == "accum=4 opt=adamw"
    dec = P.get_arch("granite-3-2b").ARCH.build(
        "decode_32k", device="meta", reduced={"batch": 8})
    assert dec.args[1][0].shape == (40, 8, 8, 32768, 64)


def _dtype_name(d) -> str:
    if isinstance(d, torch.dtype):
        return str(d).removeprefix("torch.")
    return np.dtype(d).name


def _spec_leaves(tree, is_spec):
    """(shape, axes, dtype name) of each ParamSpec, dict keys sorted."""
    out = []

    def visit(t):
        if is_spec(t):
            out.append((tuple(t.shape), tuple(t.axes), _dtype_name(t.dtype)))
        elif isinstance(t, dict):
            for k in sorted(t):
                visit(t[k])
        else:
            for x in t:
                visit(x)
    visit(tree)
    return out


def _jax_lm_cfg(arch_id):
    """The JAX package's config of an LM arch (its cell builder's)."""
    return [c.cell_contents for c in J.get_arch(arch_id).build.__closure__
            if hasattr(c.cell_contents, "cfg")][0].cfg


SPEC_TREES = {
    "graphcast": (lambda: J_GCM.param_specs(J_GC_CFG),
                  lambda: T_GCM.param_specs(T_GC.CFG)),
    "arctic-480b": (lambda: J_T.param_specs(_jax_lm_cfg("arctic-480b")),
                    lambda: T_T.param_specs(P.get_arch("arctic-480b").CFG)),
}


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor", "sgd"])
@pytest.mark.parametrize("tree", list(SPEC_TREES))
def test_opt_state_specs_match_jax(opt_name, tree):
    j_specs, p_specs = (f() for f in SPEC_TREES[tree])
    j_is = lambda x: isinstance(x, JParamSpec)
    p_is = lambda x: isinstance(x, ParamSpec)
    assert _spec_leaves(p_specs, p_is) == _spec_leaves(j_specs, j_is)
    j_o = j_opt_state_specs(j_get_optimizer(opt_name), j_specs)
    p_o = cell.opt_state_specs(opt_name, p_specs)
    assert _spec_leaves(p_o, p_is) == _spec_leaves(j_o, j_is)
    assert type(p_o).__name__ == type(j_o).__name__ or opt_name == "sgd"


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor", "sgd"])
def test_opt_state_specs_match_port_init(opt_name):
    """The specs are leaf for leaf what the port's optimizer makes."""
    specs = T_T.param_specs(lm_common.smoke_config(
        P.get_arch("dbrx-132b").CFG))
    gen = torch.Generator().manual_seed(0)
    params = init_from_specs(specs, gen)
    state = get_optimizer(opt_name).init(params)
    metas = cell.spec_to_meta(cell.opt_state_specs(opt_name, specs))
    got = [(tuple(t.shape), t.dtype) for t in tree_leaves(state)]
    want = [(tuple(t.shape), t.dtype) for t in tree_leaves(metas)]
    assert got == want


def test_state_specs_places_under_a_mesh():
    from repro_torch.launch.mesh import make_production_mesh

    specs = T_T.param_specs(P.get_arch("granite-3-2b").CFG)
    p, o, p_pl, o_pl = cell.state_specs("adamw", specs,
                                        make_production_mesh())
    assert p["layers"]["wq"].is_meta and o.mu["layers"]["wq"].is_meta
    # d_model over data (16), heads over model (16)
    assert p_pl["layers"]["wq"].spec == (None, "data", "model", None)
    assert p_pl["layers"]["wq"].local_shape == (40, 128, 2, 64)
    assert p_pl["layers"]["wq"].bytes_per_device == 40 * 128 * 2 * 64 * 4
    assert o_pl.count.spec == ()
    assert cell.state_specs("sgd", specs)[2:] == (None, None)
