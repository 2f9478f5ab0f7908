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

The records keep the JAX package's keys. ``collective_bytes`` is the
placed step's per-device collective traffic, as the JAX package reads it
from the partitioned HLO: the CLI (``add_collective_bytes``) places each
placed cell (``placed``: every LM arch's serve cells and train cells,
the MoE archs' included; a train cell steps whole, forward, recompute,
backward and optimizer, every microbatch) on ``--multi-pod``'s
production mesh over a fake process group of as many ranks
(``launch.mesh.fake_group``; meta tensors, nothing allocated, no peer)
and runs its step once under ``CollectiveBytes``, which sums every
functional collective's result bytes under the JAX package's kind names.
The other cells keep ``{}`` and say so in ``notes``; a measured run is
one card's and runs no collective.
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


# the cells placed on a device mesh (DTensor) for their collective bytes:
# every LM arch's serve shapes and train shape (the MoE archs' through
# both dispatches); DIEN, the GNNs and eagr are not placed yet
SERVE_SHAPES = ("prefill_32k", "decode_32k", "long_500k")
# the JAX package's collective kinds, and the functional collectives that
# are each (result bytes counted, as the JAX package counts the HLO
# instruction's result shape)
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
_KIND_OF = {"all_gather_into_tensor": "all-gather",
            "all_gather_into_tensor_coalesced": "all-gather",
            "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
            "all_reduce_coalesced": "all-reduce",
            "all_reduce_coalesced_": "all-reduce",
            "reduce_scatter_tensor": "reduce-scatter",
            "reduce_scatter_tensor_coalesced": "reduce-scatter",
            "all_to_all_single": "all-to-all"}


def placed(arch_id: str, shape: str) -> bool:
    """Whether the dry run places ``arch_id``'s ``shape`` on the mesh for
    its collective bytes."""
    from repro_torch.configs import get_arch

    mod = get_arch(arch_id)
    return getattr(mod, "FAMILY", None) == "lm" and (
        shape in SERVE_SHAPES or shape == "train_4k")


class CollectiveBytes(TorchDispatchMode):
    """Sums the result bytes of every functional collective
    (``_c10d_functional``) by the JAX package's kind names."""

    def __init__(self):
        super().__init__()
        self.bytes = dict.fromkeys(COLLECTIVE_KINDS, 0.0)
        self.calls = dict.fromkeys(COLLECTIVE_KINDS, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ns, _, name = func._schema.name.partition("::")
        kind = _KIND_OF.get(name) if ns == "_c10d_functional" else None
        if kind is not None:
            self.calls[kind] += 1
            self.bytes[kind] += sum(t.numel() * t.element_size()
                                    for t in tree_leaves(out)
                                    if isinstance(t, torch.Tensor))
        return out


def collective_bytes(plan: CellPlan, mesh: MeshShape) -> tuple[dict, dict]:
    """One step of ``plan`` (meta arguments) placed on ``mesh`` over a fake
    group of ``mesh.size`` ranks: the per-device result bytes of its
    collectives by kind, and their calls by kind."""
    from repro_torch.launch.mesh import fake_group, make_device_mesh

    with fake_group(mesh.size):
        step = plan.on_mesh(make_device_mesh(mesh, fake=True))
        with CollectiveBytes() as cb:
            step.fn(*step.args)
    return cb.bytes, cb.calls


def _spec_axes(entry) -> tuple:
    return () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))


def train_collective_bytes(cfg, train, B: int, S: int, data: int,
                           model: int) -> dict:
    """A placed LM train step's collective bytes per device by kind (the
    JAX package's names) on a (data, model) mesh (data > 1) under the
    arch's rule preset, from the shapes alone: the closed form that
    :func:`collective_bytes` counts, and that ``chip_smoke.py`` holds a
    group's counted collectives to. ``cfg`` a ``TransformerConfig``,
    ``train`` its ``TrainSetting``, a global batch of ``B`` x ``S``.

    Each of the step's n microbatches (b of its rows a data rank): the
    FSDP gathers of every weight (in the compute dtype; ``lm_head`` in
    the parameter dtype, as the fused CE reads it) in the forward and
    again in the recompute of each layer, and their gradients
    reduce-scattered once; the cross entropy's max, sum of exp and label
    logit all-reduced over the vocab's mesh dims in the forward and in the
    recompute of each chunk (fp32), and its two sums over data. Default
    rules: the lookup's sum and two row-parallel products a layer
    all-reduced, the recompute's attention product again (the checkpoint
    stops recomputing after the last saved input), and the partial
    cotangents at the 2L + 1 places the sequence meets the column-parallel
    products (each layer's two normed inputs, the CE's input), all
    all-reduced; the norm gains' gradients all-reduced over data.
    ``residual_sp``: the sequence gathered at those 2L + 1 places in the
    forward and at the layers' 2L in the recompute, the lookup and the row
    products reduce-scattered over it (the recompute's attention product
    again), each gather's and reduce-scatter's cotangent the other
    collective; the gains' gradients all-reduced over data and model.
    Where the kv heads are replicated over ``model`` while the query heads
    are not, their cotangents are all-reduced.

    An MoE layer gathers (and reduce-scatters the gradients of) its router
    and its rank's experts in the dense FFN's place, arctic's dense
    residual FFN beside them. Its load-balance loss all-reduces the rows'
    2E fp32 sums over data in the forward and the recompute. The sort
    dispatch all-gathers the expert outputs (b x E x C x D, C the per-row
    capacity) over ``model`` in the forward and the recompute and sums
    nothing: without a dense FFN the layer all-reduces no FFN product, and
    a dense residual's partials are all-reduced where the MoE output is
    whole (under ``residual_sp`` too, so they are not reduce-scattered).
    The einsum dispatch's combine is partial and all-reduced in the dense
    FFN's place, and its router's gradient, partial over ``model``, is
    all-reduced there after the reduce-scatter.

    Per step: the batch's token ids gathered over data once
    (accumulating), one 4-byte all-reduce of the global norm per mesh dim
    of each group of leaves sharded alike, and Adafactor's statistics
    over sharded dims (:func:`adafactor_bytes`)."""
    import math

    from repro_torch.distributed.sharding import spec_for
    from repro_torch.models import transformer as T
    from repro_torch.models.common import _leaves

    def div(n, k):
        return n // k if n % k == 0 else n

    rules = RULE_SETS[train.train_rules or "default"]
    mesh = MeshShape(("data", "model"), (data, model))
    sizes = dict(data=data, model=model)
    e = torch.empty((), dtype=cfg.compute_dtype).element_size()
    pe = torch.empty((), dtype=cfg.param_dtype).element_size()
    n = math.gcd(train.accum, B)
    b = B // n // data
    D, Fd, V, L = cfg.d_model, cfg.d_ff, cfg.padded_vocab, cfg.n_layers
    Hq, Hkv, hd, E = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.n_experts
    dense = not cfg.is_moe or cfg.moe_dense_residual
    sort = cfg.is_moe and cfg.moe_impl == "sort"
    layer = D * (2 * div(Hq, model) * hd + 2 * div(Hkv, model) * hd) * e
    layer += 3 * D * div(Fd, model) * e if dense else 0
    if cfg.is_moe:
        layer += D * E * e + 3 * div(E, model) * D * Fd * e
    tables = div(V, model) * D * (e + pe)
    act = b * S * D * e
    ag = 2 * L * layer + tables
    rs = (L * layer + tables) // data
    ar = 6 * b * S * 4 + 2 * 4
    attn = Hq % model == 0        # the heads split: column / row parallel
    if Hkv % model and attn:
        ar += 2 * L * b * S * Hkv * hd * e
    gains = (2 * L + 1) * D * pe
    # a layer's partial sums of (b, S, D): the attention's out product in
    # the forward and the recompute and its input's cotangent where the
    # heads are split; the FFN's input's cotangent (a dense FFN's columns
    # or the experts split); its output's partials, summed into the
    # residual's placement (reduce-scattered under residual_sp) unless the
    # sort's output is whole, where a dense residual's are all-reduced
    split = 3 * attn + (dense or E % model == 0)
    ffn = (not sort or dense)
    if train.train_rules == "residual_sp":
        ag += (6 * L + 2) * act
        rs += (2 + L * (split + ffn * (not sort))) * act // model
        ar += 2 * gains + L * act * (ffn and sort)
    else:
        ar += (2 + L * (split + ffn)) * act + gains
    if cfg.is_moe:
        ar += 2 * L * 2 * E * 4
        if sort and E % model == 0:
            ag += 2 * L * b * E * T._capacity_sort(cfg, S) * D * e
        if not sort:
            ar += L * div(D, data) * E * e
    out = {"all-gather": n * ag + (2 * B * S * 4 if n > 1 else 0),
           "all-reduce": n * ar, "reduce-scatter": n * rs,
           "all-to-all": 0, "collective-permute": 0}
    specs = T.param_specs(cfg)
    groups = {tuple(sorted({a for en in spec_for(s.shape, s.axes, mesh, rules)
                            for a in _spec_axes(en)}))
              for _, s in _leaves(specs)}
    out["all-reduce"] += 4 * sum(sum(sizes[a] > 1 for a in k)
                                 for k in groups)
    if train.optimizer == "adafactor":
        out["all-reduce"] += adafactor_bytes(specs, mesh, rules)
    return {k: float(v) for k, v in out.items()}


def adafactor_bytes(specs, mesh: MeshShape, rules) -> int:
    """Adafactor's all-reduces (fp32) of a placed step on ``mesh``, a layer
    slice of a layer-stacked leaf at a time: the row means of g^2 where
    the last dim is sharded, the column means and the row moments' mean
    where the one before it is (one all-reduce per mesh dim that shards
    it), and the update's mean square (4 bytes per mesh dim sharding the
    leaf)."""
    import math

    from repro_torch.distributed.sharding import spec_for
    from repro_torch.models.common import _leaves

    sizes = mesh_axis_sizes(mesh)
    total = 0
    for _, s in _leaves(specs):
        ent = spec_for(s.shape, s.axes, mesh, rules)
        local = [d // math.prod(sizes[a] for a in _spec_axes(en))
                 for d, en in zip(s.shape, ent)]
        ranks = [sum(sizes[a] > 1 for a in _spec_axes(en)) for en in ent]
        slices = 1
        if len(s.shape) >= 3:
            slices, local, ranks = s.shape[0], local[1:], ranks[1:]
        per = 4 * len({a for en in ent for a in _spec_axes(en)
                       if sizes[a] > 1})
        if len(local) >= 2:
            per += 4 * math.prod(local[:-1]) * ranks[-1]
            per += 4 * math.prod(local[:-2] + local[-1:]) * ranks[-2]
            per += 4 * math.prod(local[:-2]) * ranks[-2]
        total += slices * per
    return total


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
    (where the arch's reduced build takes it). ``collective_bytes`` is
    ``{}``: :func:`add_collective_bytes` fills it in."""
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


def add_collective_bytes(rec: dict, mesh: MeshShape) -> dict:
    """``rec`` (a meta record of :func:`run_cell`) with its
    ``collective_bytes``: a placed cell's step built on the meta device and
    run on a fake group of ``mesh``'s ranks (:func:`collective_bytes`,
    seconds a cell on the host), its calls by kind in ``notes``; a cell
    not placed yet keeps ``{}`` and says so in ``notes``."""
    from repro_torch.configs import get_arch

    notes = rec["notes"] or ""
    if placed(rec["arch"], rec["shape"]):
        plan = get_arch(rec["arch"]).ARCH.build(rec["shape"], device="meta")
        rec["collective_bytes"], calls = collective_bytes(plan, mesh)
        rec["notes"] = f"{notes} collective_calls={calls}".strip()
    else:
        rec["notes"] = f"{notes} collective_bytes: not placed yet".strip()
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
            if not (args.measure or args.smoke):
                add_collective_bytes(rec, mesh)
            records.append(rec)
            per_dev = rec["per_device_arg_bytes"]
            line = (f"{tag} OK args={rec['arg_bytes'] / 1e9:8.2f}GB "
                    f"per-device={(per_dev or 0) / 1e9:7.3f}GB "
                    f"fits={rec['fits_one_card']} "
                    f"coll={sum(rec['collective_bytes'].values()) / 1e9:.3f}GB "
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
