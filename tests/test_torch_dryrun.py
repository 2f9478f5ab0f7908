"""The port's dry run: a measured smoke-size LM and GNN cell on the CPU
give the JAX package's record keys; every kernel wrapper counts each
call's operations and bytes (its cost function at the call's shapes) on
the CPU path, so a step's counters are the per-call formulas summed over
its calls; the plain versions' own matmuls are not counted a second time;
the CLI's ``--json`` round trip through the roofline."""
import json

import pytest

torch = pytest.importorskip("torch")

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
    w = seg.graph_cost(plan.seg.shape[1], 6, 6, 5)
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
