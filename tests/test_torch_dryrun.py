"""The port's dry run: a measured smoke-size LM and GNN cell on the CPU
give the JAX package's record keys; every kernel wrapper counts each
call's operations and bytes (its cost function at the call's shapes) on
the CPU path, so a step's counters are the per-call formulas summed over
its calls; the plain versions' own matmuls are not counted a second time;
the CLI's ``--json`` round trip through the roofline; the dense LM serve
cells placed on a fake group of the production mesh's ranks carry their
per-device collective bytes, which at the smoke widths equal a closed form
of the shapes and placements."""
import json

import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import all_cells, get_arch  # noqa: E402
from repro_torch.configs.cell import tree_bytes  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as bag  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.segment_agg import ops as seg  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

# the JAX package's dry-run record (src/repro/launch/dryrun.py run_cell)
JAX_KEYS = {"arch", "shape", "mesh", "seconds", "temp_bytes", "arg_bytes",
            "out_bytes", "alias_bytes", "flops", "bytes_accessed",
            "collective_bytes", "notes"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch_id,shape", [("granite-3-2b", "prefill_32k"),
                                           ("gat-cora", "full_graph_sm")])
def test_measured_smoke_record_has_jax_keys(arch_id, shape):
    rec = dryrun.run_cell(arch_id, shape, make_production_mesh(),
                          measure=True, device="cpu", smoke=True, repeats=2)
    assert JAX_KEYS <= set(rec)
    assert rec["measured"] and rec["reduced"] == {"smoke": True}
    assert rec["seconds"] > 0 and len(rec["step_seconds"]) == 2
    assert rec["flops"] == rec["aten_flops"] + rec["kernel_ops"] > 0
    assert rec["bytes_accessed"] == rec["aten_bytes"] + rec["kernel_bytes"]
    assert rec["collective_bytes"] == {}
    assert rec["kernels"]            # the step reached its kernels' wrappers
    row = roofline.analyze([rec])[0]
    assert row["chips"] == 1 and row["mfu"] is None   # a smoke cell


def test_unmeasured_record():
    rec = dryrun.run_cell("dbrx-132b", "train_4k", make_production_mesh(),
                          "residual_sp")
    assert JAX_KEYS <= set(rec)
    assert not rec["measured"] and rec["flops"] is None
    assert rec["mesh"] == {"data": 16, "model": 16}
    assert rec["fits_one_card"] is False
    assert 0 < rec["per_device_arg_bytes"] < rec["arg_bytes"] / 100
    assert rec["model_flops"] == roofline.model_flops("dbrx-132b",
                                                      "train_4k")[0]


@pytest.mark.parametrize("arch_id,shape,want", [
    # the measured cells of chip_smoke.py's phase 13 (PERF.md's cuts)
    ("granite-3-2b", "prefill_32k", {"batch": 1}),     # model FLOPs
    ("granite-3-2b", "decode_32k", {"batch": 8}),      # the KV cache
    ("dien", "serve_p99", {}),
    ("gat-cora", "minibatch_lg", {}),
    ("graphcast", "minibatch_lg", {}),
    # the batch down to 1 first, then the depth
    ("arctic-480b", "train_4k", {"batch": 1, "n_layers": 1}),
    ("nequip", "full_graph_sm", {}),
])
def test_fit_cuts_batch_then_depth(arch_id, shape, want):
    arch = get_arch(arch_id).ARCH
    got = dryrun.fit(arch, shape)
    assert got == want
    assert _within(arch, shape, got)
    if got:   # the cut one halving short of it would not do
        k = list(got)[-1]
        assert not _within(arch, shape, {**got, k: got[k] * 2})


def _within(arch, shape, reduced) -> bool:
    plan = arch.build(shape, device="meta", reduced=reduced or None)
    assert plan.reduced == reduced
    return tree_bytes(plan.args) <= dryrun.ARG_SHARE * 80e9 and \
        roofline.model_flops(arch.arch_id, shape, reduced)[0] <= \
        dryrun.STEP_S * cost.BF16_OPS_PER_S


def test_every_plan_declares_its_cuttable_dims():
    """The dry run cuts a cell through the dims its plan declares (no arch
    name in the dry run): LMs their batch and depth, DIEN its batch, the
    GNNs their depth, eagr nothing."""
    for arch_id, shape in all_cells():
        arch = get_arch(arch_id).ARCH
        plan = arch.build(shape, device="meta")
        want = {"lm": ("batch", "n_layers"), "recsys": ("batch",),
                "gnn": ("n_layers",)}[arch.family]
        assert tuple(plan.dims) == want, (arch_id, shape, plan.dims)
        if max(plan.dims.values()) == 1:        # dien's retrieval_cand
            with pytest.raises(RuntimeError, match="no cut left"):
                dryrun.halve(plan)
            continue
        cut = dryrun.halve(plan)
        assert arch.build(shape, device="meta", reduced=cut).dims == {
            **plan.dims, **cut}
    eagr = get_arch("eagr").ARCH.build_smoke("stream_mixed", device="meta")
    assert eagr.dims == {}
    with pytest.raises(RuntimeError, match="no cut left"):
        dryrun.halve(eagr)


def test_eagr_smoke_record_on_meta():
    """eagr's reduced cell, the one of phase 13's meta builds that is not
    one of the 40: built on the meta device, nothing measured."""
    rec = dryrun.run_cell("eagr", "stream_mixed", make_production_mesh(),
                          smoke=True)
    assert JAX_KEYS <= set(rec) and not rec["measured"]
    assert rec["reduced"] == {"smoke": True} and rec["model_flops"] is None
    assert 0 < rec["per_device_arg_bytes"] <= rec["arg_bytes"]


def _step_counts(plan):
    return dryrun.count_step(plan, "cpu")["kernels"]


def test_lm_counters_are_the_formula_times_the_calls():
    for shape in ("prefill_32k", "decode_32k"):
        plan = get_arch("granite-3-2b").ARCH.build_smoke(shape, device="cpu")
        got = _step_counts(plan)["flash_attention"]
        params = plan.args[0]
        L = params["layers"]["wq"].shape[0]
        cfg = plan.fn.keywords["cfg"]
        if shape == "prefill_32k":
            B, S = plan.args[1].shape
            w = flash.prefill_cost(B, cfg.n_heads, cfg.n_kv_heads, S, S,
                                   cfg.head_dim, True, 4)
            key = "prefill"
        else:
            k = plan.args[1][0]
            B, S = k.shape[1], k.shape[3]
            w = flash.decode_cost(B, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.head_dim, B * S, 4)
            key = "decode"
        assert got == {key: dict(calls=L, ops=L * w.ops, bytes=L * w.bytes)}


def test_each_wrapper_adds_its_formula():
    gen = torch.Generator().manual_seed(0)
    cost.reset_all()
    # prefill, decode
    q = torch.randn(2, 4, 10, 16, generator=gen)
    k = torch.randn(2, 2, 12, 16, generator=gen)
    lens = torch.tensor([3, 12])
    flash.flash_attention(q, k, k, causal=True)     # counting off
    assert flash.WORK.snapshot() == {}
    with cost.counting():
        flash.flash_attention(q, k, k, causal=True)
        flash.flash_decode(q[:, :, 0], k, k, lens)
    assert flash.WORK.snapshot() == {
        "prefill": dict(calls=1, **_ob(flash.prefill_cost(2, 4, 2, 10, 12, 16,
                                                          True, 4))),
        "decode": dict(calls=1, **_ob(flash.decode_cost(2, 4, 2, 16, 24, 4)))}
    # the bag, forward and backward
    table = torch.randn(50, 6, generator=gen, requires_grad=True)
    ids = torch.tensor([1, 4, -1, 7, 7, 9])
    offs = torch.tensor([0, 2, 2])
    with cost.counting():
        bag.embedding_bag(table, ids, offs, n_bags=3).sum().backward()
    assert bag.WORK.snapshot() == {
        "embedding_bag": dict(calls=1, **_ob(bag.bag_cost(6, 6, 3, 6,
                                                          False))),
        "embedding_bag_backward": dict(calls=1, **_ob(
            bag.bag_backward_cost(6, 6, 3, 50, 6, False)))}
    # the graph entry: exact counts from its plan
    index = torch.tensor([0, 3, 3, 5, 1, 0, 9])
    plan = seg.edge_plan(index, 6)          # 9 is out of range: dropped
    x = torch.randn(7, 5, generator=gen)
    with cost.counting():
        seg.segment_agg_graph(x, plan, "sum")
        seg.segment_agg_graph(x, plan, "max")
    w = seg.graph_cost(6, 6, 5)
    assert plan.n_live == 6
    assert seg.WORK.snapshot() == {"sum_gnn": dict(calls=1, **_ob(w)),
                                   "max_gnn": dict(calls=1, **_ob(w))}


def _ob(w):
    return dict(ops=w.ops, bytes=w.bytes)


def test_eagr_entries_count_their_shapes():
    """The EAGr entries read no table back: every slot counted live,
    every row written."""
    plan = get_arch("eagr").ARCH.build_smoke("stream_mixed", device="cpu")
    cost.reset_all()
    with cost.counting():
        plan.fn(*plan.args)
    snap = seg.WORK.snapshot()
    assert snap and all(e["calls"] > 0 for e in snap.values())
    # one dense level by hand: level_cost at its shapes
    x = torch.randn(2 * seg.E_BLK, 3)
    segv = torch.full((2 * seg.E_BLK,), -1, dtype=torch.int32)
    segv[:5] = torch.tensor([0, 0, 1, 2, 2], dtype=torch.int32)
    tob = torch.zeros(2, dtype=torch.int32)
    fot = torch.tensor([1, 0], dtype=torch.int32)
    cost.reset_all()
    with cost.counting():
        seg.segment_agg_level(x, segv, tob, fot, n_rows=3, n_row_tiles=1)
    w = seg.level_cost(2 * seg.E_BLK, 2 * seg.E_BLK, 2, 3, 3)
    assert w.bytes == 512 * 4 + 2 * 8 + 512 * 4 * 3 + 3 * 4 * 3
    assert seg.WORK.snapshot() == {"sum": dict(calls=1, **_ob(w))}


def test_plain_matmuls_are_not_counted_twice():
    """Inside a counting mode the plain attention's matmuls run outside it:
    the mode sees none of them, and the wrapper's formula stands alone."""
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(1, 4, 64, 16, generator=gen)
    k = torch.randn(1, 2, 64, 16, generator=gen)
    with FlopCounterMode(display=False) as plain:
        attention_ref(q, k, k, causal=True)
    assert plain.get_total_flops() > 0          # the plain version's own
    cost.reset_all()
    with cost.counting(), FlopCounterMode(display=False) as fc, \
            dryrun.OperandBytes() as ob:
        out = flash.flash_attention(q, k, k, causal=True)
    assert fc.get_total_flops() == 0 and ob.bytes == 0
    assert flash.WORK.ops["prefill"] == flash.prefill_cost(
        1, 4, 2, 64, 64, 16, True, 4).ops
    torch.testing.assert_close(out, attention_ref(q, k, k, causal=True))
    # and in a whole step: the aten count is the step's other matmuls only
    plan = get_arch("granite-3-2b").ARCH.build_smoke("prefill_32k",
                                                     device="cpu")
    counted = dryrun.count_step(plan, "cpu")
    cfg = plan.fn.keywords["cfg"]
    with FlopCounterMode(display=False) as whole:
        from repro_torch.models import transformer as T
        with torch.no_grad():
            T.prefill(plan.args[0], plan.args[1], cfg,
                      attention=_counted_plain)
    # the step with a plain attention the mode cannot see counts what the
    # step through the wrapper counted; the plain attention's own flops
    # (set aside) would have been counted twice
    assert counted["aten_flops"] == whole.get_total_flops()
    assert _PLAIN_FLOPS[0] > 0


_PLAIN_FLOPS = [0]


def _counted_plain(q, k, v, *, causal, lengths):
    """attention_ref with its own flops set aside (they are what a
    counting mode would have added on top of the wrapper's formula)."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        with FlopCounterMode(display=False) as fc:
            out = attention_ref(q, k, v, causal=causal, lengths=lengths)
    _PLAIN_FLOPS[0] += fc.get_total_flops()
    return out


def test_cli_json_round_trip(tmp_path, capsys):
    path = tmp_path / "cells.json"
    rc = dryrun.main(["--arch", "gat-cora", "--shape", "molecule",
                      "--measure", "--smoke", "--device", "cpu",
                      "--repeats", "1", "--json", str(path)])
    assert rc == 0
    recs = json.loads(path.read_text())
    assert len(recs) == 1 and JAX_KEYS <= set(recs[0])
    assert recs[0]["kernels"]["segment_agg"]["sum_gnn"]["calls"] > 0
    out = tmp_path / "rows.json"
    roofline.main([str(path), "--out", str(out)])
    rows = json.loads(out.read_text())
    assert rows[0]["arch"] == "gat-cora" and rows[0]["chips"] == 1
    # every cell on the meta device, without --measure
    path2 = tmp_path / "all.json"
    assert dryrun.main(["--device", "cpu", "--json", str(path2)]) == 0
    recs = json.loads(path2.read_text())
    assert [(r["arch"], r["shape"]) for r in recs] == all_cells()
    assert "40 cells OK, 0 failed" in capsys.readouterr().out
    assert sum(r["arg_bytes"] for r in recs) > 5e12


def test_cli_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "dien"])


# ------------------------------------------- placed cells: collective bytes
PLACED = [(a, s) for a in ("granite-3-2b", "internlm2-1.8b",
                           "command-r-plus-104b", "dbrx-132b", "arctic-480b")
          for s in ("prefill_32k", "decode_32k", "long_500k")]


class _Host(TorchDispatchMode):
    """The largest tensor off the meta device that an operation makes."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.numel = max([self.numel] + [
            t.numel() for t in tree_leaves(out)
            if isinstance(t, torch.Tensor) and t.device.type != "meta"])
        return out


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch_id,shape", PLACED)
def test_placed_record_carries_collective_bytes(arch_id, shape, multi_pod):
    """The 30 placed serve records: built and run on a fake group of the
    production mesh's ranks with meta tensors (nothing allocated but the
    mesh's table of ranks),
    the per-device bytes under the JAX package's collective kinds, every
    step gathering its FSDP weights and all-reducing its row-parallel
    products; the roofline gives them a collective term. On the (16, 16)
    mesh the bytes are the closed form's at the arch's published widths
    (bf16: the row-parallel partials all-reduced in bf16, as GSPMD adds
    them)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert dryrun.placed(arch_id, shape)
    with _Host() as host:
        rec = dryrun.run_cell(arch_id, shape, mesh)
        assert rec["collective_bytes"] == {}
        dryrun.add_collective_bytes(rec, mesh)
    assert host.numel <= mesh.size    # the mesh's table of ranks, no more
    assert not torch.distributed.is_initialized()    # the fake group ended
    cb = rec["collective_bytes"]
    assert tuple(cb) == dryrun.COLLECTIVE_KINDS
    assert cb["all-gather"] > 0 and cb["all-reduce"] > 0
    assert cb["reduce-scatter"] == cb["all-to-all"] == 0
    assert "collective_calls=" in rec["notes"]
    assert roofline.analyze([rec])[0]["t_collective_s"] > 0
    if not multi_pod:      # (data 16, model 16): the closed form's mesh
        assert cb == _closed_form(get_arch(arch_id).CFG, shape, 16, 16)


def test_unplaced_records_say_so():
    for arch_id, shape in [("gatedgcn", "minibatch_lg"),
                           ("gat-cora", "full_graph_sm"),
                           ("dien", "train_batch"),
                           ("dien", "serve_p99")]:
        assert not dryrun.placed(arch_id, shape)
        mesh = make_production_mesh()
        rec = dryrun.add_collective_bytes(
            dryrun.run_cell(arch_id, shape, mesh), mesh)
        assert rec["collective_bytes"] == {}
        assert "not placed yet" in rec["notes"]
        assert roofline.analyze([rec])[0]["t_collective_s"] == 0


def _closed_form(cfg, shape: str, data: int, model: int) -> dict:
    """A placed serve step's collective bytes per device on a (data, model)
    mesh under the default rules, from the shapes alone: the FSDP gathers
    (each weight, cast to the compute dtype, gathered over data to its
    model shard), the vocab-parallel lookup's sum and a layer's
    row-parallel all-reduces (partials in the compute dtype, as GSPMD adds
    them) of the (batch shard, tokens, D) activations: the attention's
    out product where ``model`` shards the query heads, the FFN's down
    product where it shards the FFN columns; and a decode over a cache
    whose rows are sharded: the query heads gathered over the rows' mesh
    dims where those shard them, and each layer's partials (d + 2 fp32 a
    query row) gathered over them.

    An MoE layer gathers its router (D x E) and each rank's experts
    (3 of div(E, model) x D x Fd) over data, and arctic's dense residual
    FFN as a dense layer's. The sort dispatch all-gathers the expert
    outputs over ``model``, B_l x E x C x D with C the per-row capacity
    of the step's tokens (S at prefill, 1 at decode), and sums nothing:
    without a dense FFN a layer all-reduces only its attention product.
    The einsum dispatch's combine is partial over ``model`` and
    all-reduced in the dense FFN's place."""
    from repro_torch.configs.lm_common import SHAPE_DEFS
    from repro_torch.models.transformer import _capacity_sort

    def div(n, k):
        return n // k if n % k == 0 else n

    d = SHAPE_DEFS[shape]
    B, S = d["batch"], d["seq"]
    e = torch.empty((), dtype=cfg.compute_dtype).element_size()
    D, Fd, V, L = cfg.d_model, cfg.d_ff, cfg.padded_vocab, cfg.n_layers
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    E = cfg.n_experts
    dense = not cfg.is_moe or cfg.moe_dense_residual
    experts_split = cfg.is_moe and E % model == 0
    layer = D * (2 * div(Hq, model) * hd + 2 * div(Hkv, model) * hd) * e
    layer += 3 * D * div(Fd, model) * e if dense else 0
    if cfg.is_moe:
        layer += D * E * e + 3 * div(E, model) * D * Fd * e
    gather = L * layer + 2 * div(V, model) * D * e
    B_l = div(B, data)
    rows = B_l * (S if d["kind"] == "prefill" else 1)
    if cfg.is_moe and cfg.moe_impl == "sort" and experts_split:
        C = _capacity_sort(cfg, S if d["kind"] == "prefill" else 1)
        gather += L * B_l * E * C * D * e
    # the lookup's sum and the row-parallel products' partials, all in the
    # compute dtype
    ffn = (Fd % model == 0) if dense else (
        cfg.moe_impl == "einsum" and experts_split)
    reduce = rows * D * e * (1 + L * ((Hq % model == 0) + ffn))
    if d["kind"] == "decode":
        # cache_seq takes the axes the batch and the kv heads left
        seq = {ax: n for ax, n, free in (("data", data, B % data),
                                         ("model", model, Hkv % model))
               if free and n > 1}
        q_split = Hq % model == 0 and model > 1
        heads = Hq // model if q_split and "model" not in seq else Hq
        if q_split and "model" in seq:
            gather += L * B_l * Hq * hd * e      # q's heads over model
        n = 1
        for k in reversed(seq.values()):
            n *= k
            gather += L * n * B_l * heads * (hd + 2) * 4
    return {"all-gather": float(gather), "all-reduce": float(reduce),
            "reduce-scatter": 0.0, "all-to-all": 0.0,
            "collective-permute": 0.0}


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k",
                                   "long_500k"])
def test_smoke_collective_bytes_equal_the_closed_form(shape):
    """granite-3-2b's smoke widths (2 layers, d 64, 4 heads, 2 kv heads,
    vocab 128, fp32) at the cells' batch and sequence on a fake (2, 2)
    group: the counted bytes are the closed form's, kind by kind."""
    from repro_torch.configs import lm_common
    from repro_torch.configs.granite_3_2b import CFG, TRAIN
    from repro_torch.distributed.sharding import MeshShape

    cfg = lm_common.smoke_config(CFG)
    plan = lm_common.build_cell(cfg, TRAIN, shape, device="meta")
    got, calls = dryrun.collective_bytes(plan, MeshShape(("data", "model"),
                                                         (2, 2)))
    assert got == _closed_form(cfg, shape, 2, 2)
    # the gathers: 7 weights a layer, the table and the head; B = 1 decode
    # also each layer's partials
    assert calls["all-gather"] == 7 * 2 + 2 + (2 if shape == "long_500k"
                                               else 0)
    assert calls["all-reduce"] == 2 * 2 + 1


MOE_SMOKE = {"sort": ("dbrx-132b", {}),
             "einsum": ("dbrx-132b", {"moe_impl": "einsum"}),
             "sort_dense_residual": ("arctic-480b", {})}


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k",
                                   "long_500k"])
@pytest.mark.parametrize("dispatch", list(MOE_SMOKE))
def test_moe_smoke_collective_bytes_equal_the_closed_form(dispatch, shape):
    """The MoE serve cells at the smoke widths (2 layers, d 64, 4 experts
    top-2, fp32) at the cells' batch and sequence on a fake (2, 2) group,
    through each dispatch (dbrx-132b's config, sort and einsum, and
    arctic-480b's sort with its dense residual FFN): the counted bytes are
    the closed form's, kind by kind."""
    import dataclasses

    from repro_torch.configs import lm_common
    from repro_torch.distributed.sharding import MeshShape

    arch_id, fields = MOE_SMOKE[dispatch]
    mod = get_arch(arch_id)
    cfg = dataclasses.replace(lm_common.smoke_config(mod.CFG), **fields)
    plan = lm_common.build_cell(cfg, mod.TRAIN, shape, device="meta")
    got, calls = dryrun.collective_bytes(plan, MeshShape(("data", "model"),
                                                         (2, 2)))
    assert got == _closed_form(cfg, shape, 2, 2)
    # the gathers: 4 attention weights, the router and 3 experts a layer
    # (3 more for a dense FFN), the sort's expert outputs, the table and
    # the head; B = 1 decode also each layer's partials
    dense = cfg.moe_dense_residual
    assert calls["all-gather"] == (8 + 3 * dense + (dispatch != "einsum")) \
        * 2 + 2 + (2 if shape == "long_500k" else 0)
    assert calls["all-reduce"] == (1 + (dispatch == "einsum" or dense)) \
        * 2 + 1


# ------------------------------------------ placed train cells: the bytes
TRAIN_PLACED = ("granite-3-2b", "internlm2-1.8b", "command-r-plus-104b",
                "dbrx-132b", "arctic-480b")


@pytest.mark.parametrize("widths", ["smoke", "published"])
@pytest.mark.parametrize("arch_id", TRAIN_PLACED)
def test_train_collective_bytes_equal_the_closed_form(arch_id, widths):
    """The ``train_4k`` cells (batch 256, seq 4,096, the arch's
    accumulation, optimizer and rule preset) placed on a fake group and
    stepped whole on meta tensors (forward, recompute, backward,
    optimizer, every microbatch): at the smoke widths on (2, 2), and at
    the published widths cut to 2 layers on (16, 16) (bf16 compute;
    command-r-plus-104b's bf16 parameters, ``residual_sp``, Adafactor and
    kv heads replicated over ``model``; dbrx-132b's sort dispatch and
    arctic-480b's with its dense residual under ``residual_sp``, their
    routers, experts, expert outputs and load-balance sums), the counted
    bytes are the closed form's (``dryrun.train_collective_bytes``), kind
    by kind: the backward's reduce-scatters are counted."""
    import dataclasses

    from repro_torch.configs import lm_common
    from repro_torch.distributed.sharding import MeshShape

    mod = get_arch(arch_id)
    if widths == "smoke":
        cfg, mesh = lm_common.smoke_config(mod.CFG), (2, 2)
    else:
        cfg, mesh = dataclasses.replace(mod.CFG, n_layers=2), (16, 16)
    assert dryrun.placed(arch_id, "train_4k")
    plan = lm_common.build_cell(cfg, mod.TRAIN, "train_4k", device="meta")
    got, calls = dryrun.collective_bytes(plan, MeshShape(("data", "model"),
                                                         mesh))
    assert got == dryrun.train_collective_bytes(cfg, mod.TRAIN, 256, 4096,
                                                *mesh)
    assert got["reduce-scatter"] > 0 and calls["reduce-scatter"] > 0


def test_einsum_train_collective_bytes_equal_the_closed_form():
    """dbrx-132b's ``train_4k`` at the smoke widths on (2, 2) through the
    einsum dispatch: its combine's partials all-reduced in the dense FFN's
    place and its router's gradient, partial over ``model``, all-reduced
    there; the counted bytes are the closed form's, kind by kind."""
    import dataclasses

    from repro_torch.configs import lm_common
    from repro_torch.distributed.sharding import MeshShape

    mod = get_arch("dbrx-132b")
    cfg = dataclasses.replace(lm_common.smoke_config(mod.CFG),
                              moe_impl="einsum")
    plan = lm_common.build_cell(cfg, mod.TRAIN, "train_4k", device="meta")
    got, _ = dryrun.collective_bytes(plan, MeshShape(("data", "model"),
                                                     (2, 2)))
    assert got == dryrun.train_collective_bytes(cfg, mod.TRAIN, 256, 4096,
                                                2, 2)


def test_train_record_on_both_production_meshes():
    """granite-3-2b's ``train_4k`` record (cut to 2 layers) on (16, 16)
    and (2, 16, 16): every collective kind of a placed train step is
    there, the roofline reads the bytes once (the notes carry no
    ``step_multiplier``: the run counted every microbatch)."""
    from repro_torch.configs import lm_common
    from repro_torch.configs.granite_3_2b import CFG, TRAIN

    plan = lm_common.build_cell(CFG, TRAIN, "train_4k", device="meta",
                                reduced={"n_layers": 2})
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        cb, calls = dryrun.collective_bytes(plan, mesh)
        assert cb["all-gather"] > 0 and cb["all-reduce"] > 0
        assert cb["reduce-scatter"] > 0 and calls["reduce-scatter"] > 0
        rec = dict(arch="granite-3-2b", shape="train_4k",
                   mesh=dict(zip(mesh.axis_names, mesh.shape)),
                   collective_bytes=cb, notes=plan.notes, flops=None)
        assert "step_multiplier" not in plan.notes
        assert roofline.analyze([rec])[0]["t_collective_s"] == \
            sum(cb.values()) / roofline.NVLINK_BW


@pytest.mark.parametrize("arch_id", ["dbrx-132b", "arctic-480b"])
def test_moe_train_records_on_both_production_meshes(arch_id):
    """The MoE archs' ``train_4k`` is placed: its record (cut to 2 layers)
    on (16, 16) and (2, 16, 16) carries every collective kind of a placed
    train step, the sort's expert-output gathers among the all-gathers,
    and the roofline reads the bytes once."""
    from repro_torch.configs import lm_common

    mod = get_arch(arch_id)
    assert dryrun.placed(arch_id, "train_4k")
    plan = lm_common.build_cell(mod.CFG, mod.TRAIN, "train_4k",
                                device="meta", reduced={"n_layers": 2})
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        cb, calls = dryrun.collective_bytes(plan, mesh)
        assert cb["all-gather"] > 0 and cb["all-reduce"] > 0
        assert cb["reduce-scatter"] > 0 and calls["reduce-scatter"] > 0
        rec = dict(arch=arch_id, shape="train_4k",
                   mesh=dict(zip(mesh.axis_names, mesh.shape)),
                   collective_bytes=cb, notes=plan.notes, flops=None)
        assert roofline.analyze([rec])[0]["t_collective_s"] == \
            sum(cb.values()) / roofline.NVLINK_BW

