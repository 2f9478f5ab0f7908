"""Dry run of every (arch x shape) cell, and one measured step on the card:
the JAX package's ``repro.launch.dryrun`` for the port.

    PYTHONPATH=src python -m repro_torch.launch.dryrun              # 40 cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx-132b \\
        --shape train_4k --multi-pod --rules residual_sp
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch graphcast \\
        --shape minibatch_lg --measure --json out.json       # on the card
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gat-cora \\
        --shape molecule --measure --smoke --device cpu      # smoke cell

Without ``--measure`` each cell is built on the meta device (nothing is
allocated) and its record holds the argument bytes, the per-device
argument bytes on the production mesh (``make_production_mesh``, through
the sharding rules' placements), ``model_flops`` and whether the arguments
fit one card. With ``--measure`` one step of the cell runs on ``--device``
(the card unless the caller names another): the cell is cut, in batch
first and then in depth, until its arguments take at most 60% of the
card's memory and its model FLOPs at most half a second at the card's bf16
peak (``fit``, from the dims each arch's plan declares; ``reduced``;
``model_flops`` is the cut run's), one step is counted under
``torch.utils.flop_counter.FlopCounterMode`` and a dispatch mode that sums
every aten operation's operand bytes, plus the hand-written kernels' own
counts (``kernels/cost.py``: under ``cost.counting()`` each wrapper runs
its body outside the counting modes and adds only its formula), and
``--repeats`` more are timed (the p50, host clock
around ``torch.cuda.synchronize()``); ``temp_bytes`` is the peak allocated
during them less the arguments. ``--smoke`` measures the arch's reduced
cell instead.

The records keep the JAX package's keys. The port has no HLO, so the JAX
package's HLO parsing (``collective_bytes``, ``_computation_blocks``,
``_effective_multipliers``) has no counterpart: one card runs no
collective, and ``collective_bytes`` is ``{}``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs.cell import CellPlan, tree_bytes, tree_tensors
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (
    RULE_SETS,
    MeshShape,
    mesh_axis_sizes,
    placed_bytes,
)
from repro_torch.kernels import cost

# the card's memory, from the data sheet (80 GB, decimal)
CARD_MEMORY_BYTES = 80e9
# a measured run is cut until its arguments take at most this share of the
# card (the rest for what the step allocates) and its model FLOPs at most
# STEP_S seconds at the card's bf16 peak (the counted, warm-up and timed
# steps of a cell then take seconds)
ARG_SHARE = 0.6
STEP_S = 0.5
# allocations only: no bytes move
_NO_TRAFFIC = {torch.ops.aten.empty.memory_format,
               torch.ops.aten.empty_strided.default,
               torch.ops.aten.empty_like.default}


class OperandBytes(TorchDispatchMode):
    """Sums every aten operation's input and output tensor bytes (each
    distinct tensor once per operation, an expanded view at its full size;
    views and bare allocations move nothing)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func not in _NO_TRAFFIC:
            seen = set()
            for t in tree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor) and id(t) not in seen:
                    seen.add(id(t))
                    self.bytes += t.numel() * t.element_size()
        return out


# ------------------------------------------------------------------ the cuts
def halve(plan: CellPlan) -> dict:
    """``plan``'s cut once more: the first of its cuttable dims
    (``CellPlan.dims``: the batch, then the depth) still above 1
    halved."""
    for k, v in plan.dims.items():
        if v > 1:
            return {**plan.reduced, k: v // 2}
    raise RuntimeError(f"{plan.arch_id} {plan.shape}: no cut left below "
                       f"{plan.reduced}")


def fit(arch, shape: str) -> dict:
    """The cut of a measured run of ``arch``'s (an ``ArchSpec``) ``shape``:
    halved (:func:`halve`) until the meta build's arguments take at most
    ``ARG_SHARE`` of the card's memory and its model FLOPs at most
    ``STEP_S`` at the card's bf16 peak; {} when the full cell does both."""
    from repro_torch.launch.roofline import model_flops

    reduced = {}
    while True:
        plan = arch.build(shape, device="meta", reduced=reduced or None)
        try:
            mf = model_flops(arch.arch_id, shape, reduced)[0]
        except KeyError:       # no model FLOPs (eagr): memory alone
            mf = 0.0
        if tree_bytes(plan.args) <= ARG_SHARE * CARD_MEMORY_BYTES \
                and mf <= STEP_S * cost.BF16_OPS_PER_S:
            return reduced
        reduced = halve(plan)


# --------------------------------------------------------------- a measured step
def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def count_step(plan: CellPlan, device) -> dict:
    """One step of ``plan`` under the counting modes: its aten FLOPs
    (``FlopCounterMode``) and operand bytes, the kernels' counts
    (``kernels`` by module and entry: calls, ops, bytes; reset first), and
    its outputs' bytes (``alias_bytes`` of them in the arguments'
    storage)."""
    from torch.utils.flop_counter import FlopCounterMode

    device = torch.device(device)
    cost.reset_all()
    with cost.counting(), FlopCounterMode(display=False) as flops, \
            OperandBytes() as ob:
        out = plan.fn(*plan.args)
        _sync(device)
    kernels = cost.snapshot_all()
    k_ops = sum(e["ops"] for m in kernels.values() for e in m.values())
    k_bytes = sum(e["bytes"] for m in kernels.values() for e in m.values())
    arg_ptrs = {t.data_ptr() for t in tree_tensors(plan.args)}
    outs = tree_tensors(out)
    aten_flops = int(flops.get_total_flops())
    return dict(
        flops=float(aten_flops + k_ops), bytes_accessed=float(ob.bytes
                                                               + k_bytes),
        aten_flops=aten_flops, aten_bytes=ob.bytes, kernel_ops=k_ops,
        kernel_bytes=k_bytes, kernels=kernels,
        out_bytes=sum(t.numel() * t.element_size() for t in outs),
        alias_bytes=sum(t.numel() * t.element_size() for t in outs
                        if t.data_ptr() in arg_ptrs))


def measure_plan(plan: CellPlan, device, repeats: int = 5) -> dict:
    """One counted step (:func:`count_step`) and ``repeats`` timed ones of
    ``plan`` on ``device``, after one warm-up step that builds what the
    first call builds."""
    device = torch.device(device)
    out = plan.fn(*plan.args)
    _sync(device)
    out = None
    rec = count_step(plan, device)
    arg_bytes = tree_bytes(plan.args)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = plan.fn(*plan.args)
        _sync(device)
        times.append(time.perf_counter() - t0)
        out = None
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    rec.update(seconds=statistics.median(times), step_seconds=times,
               temp_bytes=None if peak is None else int(peak - arg_bytes),
               peak_bytes=peak)
    return rec


# --------------------------------------------------------------------- a cell
def run_cell(arch_id: str, shape: str, mesh: MeshShape,
             rules_name: str | None = None, *, measure: bool = False,
             device=None, smoke: bool = False, repeats: int = 5,
             seed: int = 0) -> dict:
    """One cell's record. Without ``measure``: the meta build's argument
    bytes, per-device bytes on ``mesh``, ``model_flops``, whether it fits
    one card. With it: one step on ``device`` measured
    (:func:`measure_plan`), the cell cut by :func:`fit`. ``smoke``: the
    arch's reduced cell (``build_smoke``), never cut and with no model
    FLOPs, built on ``device`` to be measured, else on the meta device
    (where the arch's reduced build takes it)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.roofline import model_flops

    arch = get_arch(arch_id).ARCH
    dev = resolve_device(device) if measure else torch.device("meta")
    t0 = time.perf_counter()
    if smoke:
        plan = arch.build_smoke(shape, device=dev)
    else:
        plan = arch.build(shape, device="meta")
    rules_name = rules_name or plan.rules or "default"
    arg_bytes = tree_bytes(plan.args)
    per_dev = None if plan.arg_axes is None else placed_bytes(
        plan.args, plan.arg_axes, mesh, RULE_SETS[rules_name])
    try:
        mf = None if smoke else model_flops(arch_id, shape)[0]
    except KeyError:
        mf = None
    rec = dict(
        arch=arch_id, shape=shape, mesh=mesh_axis_sizes(mesh),
        seconds=time.perf_counter() - t0, temp_bytes=None,
        arg_bytes=arg_bytes, out_bytes=None, alias_bytes=None, flops=None,
        bytes_accessed=None, collective_bytes={}, notes=plan.notes,
        per_device_arg_bytes=per_dev, model_flops=mf,
        fits_one_card=arg_bytes <= CARD_MEMORY_BYTES, measured=False,
        reduced={"smoke": True} if smoke else {}, rules=rules_name)
    if not measure:
        return rec
    rec.update(mesh={"data": 1, "model": 1}, measured=True,
               device=str(dev), placement_mesh=mesh_axis_sizes(mesh))
    if not smoke:
        reduced = fit(arch, shape)
        t0 = time.perf_counter()
        plan = arch.build(shape, device=dev, reduced=reduced or None,
                          seed=seed)
        rec.update(reduced=reduced, arg_bytes=tree_bytes(plan.args),
                   model_flops=model_flops(arch_id, shape, reduced)[0]
                   if mf is not None else None)
    rec["build_s"] = time.perf_counter() - t0
    rec.update(measure_plan(plan, dev, repeats))
    return rec


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--rules", default=None, help="sharding rule preset name")
    p.add_argument("--json", default=None)
    p.add_argument("--include-eagr", action="store_true",
                   help="also run the bonus EAGr engine cell")
    p.add_argument("--measure", action="store_true",
                   help="run one step of each cell on --device and measure")
    p.add_argument("--device", default=None,
                   help="the device (default: the card; 'cpu' to run here)")
    p.add_argument("--smoke", action="store_true",
                   help="the arch's reduced cell (with --measure)")
    p.add_argument("--repeats", type=int, default=5)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from repro_torch.configs import all_cells, get_arch
    from repro_torch.launch.mesh import make_production_mesh

    cells = all_cells()
    if args.include_eagr:
        cells += [("eagr", s) for s in get_arch("eagr").ARCH.shapes]
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]
    mesh = make_production_mesh(multi_pod=args.multi_pod)
    tag_mesh = "x".join(map(str, mesh.shape))
    records, failures = [], []
    for a, s in cells:
        tag = f"{a:22s} {s:15s} [{tag_mesh}]"
        try:
            rec = run_cell(a, s, mesh, args.rules, measure=args.measure,
                           device=dev, smoke=args.smoke,
                           repeats=args.repeats)
            records.append(rec)
            per_dev = rec["per_device_arg_bytes"]
            line = (f"{tag} OK args={rec['arg_bytes'] / 1e9:8.2f}GB "
                    f"per-device={(per_dev or 0) / 1e9:7.3f}GB "
                    f"fits={rec['fits_one_card']} "
                    f"model_flops={rec['model_flops'] or 0:.3e}")
            if rec["measured"]:
                line += (f" step={rec['seconds']:.4f}s "
                         f"flops={rec['flops']:.3e} "
                         f"bytes={rec['bytes_accessed']:.3e} "
                         f"reduced={rec['reduced']}")
            print(line, flush=True)
        except Exception as e:   # the CLI reports every cell, as JAX's does
            failures.append((a, s, repr(e)))
            print(f"{tag} FAIL {type(e).__name__}: {str(e)[:200]}",
                  flush=True)
            traceback.print_exc()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
    print(f"\n{len(records)} cells OK, {len(failures)} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
