"""Logical-axis sharding rules (MaxText-style) mapped onto a mesh shape, as
host logic: the JAX package's ``repro.distributed.sharding`` without GSPMD.

Every parameter and input declares *logical* axis names
(``ParamSpec.axes``); a rule table maps logical names to mesh axes.
``data`` composes with ``pod`` for every data-parallel dim, so the same
rules serve the single-pod (16, 16) and multi-pod (2, 16, 16) meshes.

A mesh here is a ``MeshShape``: axis names and sizes, no devices. The port
runs on one card, so these rules place nothing; they say where each array
would live on a mesh of cards, which is what the dry run's per-device bytes
read (``param_placements``, ``placed_bytes``). ``spec_for`` returns the
entries a ``PartitionSpec`` would hold: per dim ``None``, one axis name or
a tuple of names.

Divisibility guard: a mesh axis is only applied to a dim it divides evenly,
otherwise it is dropped (replicated) for that dim, as in the JAX package.

The JAX package's ``constrain``, ``activation_sharding`` and
``no_constrain`` only tell GSPMD how to place activations; no port model
calls them and on one card they do nothing, so they have no counterpart
here. Placing arrays on a real device mesh (DTensor) needs several cards.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.common import ParamSpec, map_specs

# logical axis -> mesh axes (in priority order; tuples compose)
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    # params
    "embed": ("pod", "data"),       # FSDP: shard the d_model dim over data
    "vocab": ("model",),            # TP: vocab/embedding rows
    "heads": ("model",),            # TP: attention heads
    "kv_heads": ("model",),
    "mlp": ("model",),              # TP: FFN hidden
    "expert": ("model",),           # EP: MoE experts
    "layers": (),                   # stacked layer axis: never sharded
    # activations / inputs
    "batch": ("pod", "data"),
    "sequence": (),                 # sequence parallelism opt-in via seq rules
    # graph node/edge dims never feed TP matmuls -> use the model axis too
    "nodes": ("pod", "data", "model"),
    "edges": ("pod", "data", "model"),
    "candidates": ("pod", "data", "model"),
    "cache_seq": ("pod", "data", "model"),  # KV cache seq: whatever batch left
    "act_batch": ("pod", "data"),
    "act_seq": (),
    "act_res_seq": (),              # residual stream between layers (SP opt-in)
    "act_embed": (),
    "act_heads": ("model",),
    "act_kv_heads": ("model",),
    "act_mlp": ("model",),
    "act_vocab": ("model",),
    "act_expert": ("model",),
    "act_nodes": ("pod", "data", "model"),
    "act_edges": ("pod", "data", "model"),
}

# variant used by the sequence-parallel hillclimb (prefill shapes)
SEQPAR_RULES = {**DEFAULT_RULES, "sequence": ("model",), "act_seq": ("model",),
                "act_heads": (), "act_mlp": (), "act_vocab": ()}

# Megatron-style sequence parallelism on the residual stream only
RESIDUAL_SP_RULES = {**DEFAULT_RULES, "act_res_seq": ("model",)}

RULE_SETS = {"default": DEFAULT_RULES, "seqpar": SEQPAR_RULES,
             "residual_sp": RESIDUAL_SP_RULES}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes (``jax.sharding.Mesh.axis_names`` and
    ``devices.shape``), without devices."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} and sizes {self.shape} "
                             f"differ in length")

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def mesh_axis_sizes(mesh: MeshShape) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def spec_for(shape: tuple[int, ...], axes: tuple[str | None, ...],
             mesh: MeshShape,
             rules: dict[str, tuple[str, ...]] | None = None) -> tuple:
    """The ``PartitionSpec`` entries of one array: the rules applied with
    the divisibility guard, each mesh axis used at most once."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_axis_sizes(mesh)
    used: set[str] = set()
    out = []
    for dim, name in zip(shape, axes):
        if name is None or name not in rules:
            out.append(None)
            continue
        chosen = []
        prod = 1
        for ax in rules[name]:
            if ax not in sizes or ax in used:
                continue
            if dim % (prod * sizes[ax]) == 0:
                chosen.append(ax)
                prod *= sizes[ax]
        used.update(chosen)
        out.append(tuple(chosen) if len(chosen) > 1
                   else (chosen[0] if chosen else None))
    return tuple(out)


def _spec_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class Placement:
    """One array on a mesh: its spec entries, its per-device shape and its
    per-device bytes."""

    spec: tuple
    local_shape: tuple[int, ...]
    bytes_per_device: int


def placement_for(shape, dtype: torch.dtype, axes, mesh: MeshShape,
                  rules=None) -> Placement:
    spec = spec_for(tuple(shape), tuple(axes), mesh, rules)
    sizes = mesh_axis_sizes(mesh)
    local = tuple(d // math.prod(sizes[a] for a in _spec_axes(e))
                  for d, e in zip(shape, spec))
    return Placement(spec, local, math.prod(local) * dtype.itemsize)


def param_placements(spec_tree, mesh: MeshShape, rules=None):
    """A ``ParamSpec`` tree -> the tree of each leaf's ``Placement`` (the
    JAX package's ``param_shardings``, as spec entries and per-device
    shapes)."""
    return map_specs(
        lambda s: placement_for(s.shape, s.dtype, s.axes, mesh, rules),
        spec_tree)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        isinstance(e, (str, type(None))) for e in x)


def placed_bytes(args, axes, mesh: MeshShape, rules=None) -> int:
    """Per-device bytes of an argument tree: ``axes`` mirrors ``args`` with
    a tuple of logical axis names (``()``: replicated) at each tensor leaf,
    or a ``ParamSpec`` tree where ``args`` holds parameters, and a dict by
    field name for a dataclass; ``None`` leaves of ``args`` are
    skipped."""
    if args is None:
        return 0
    if isinstance(args, torch.Tensor):
        ax = axes.axes if isinstance(axes, ParamSpec) else axes
        if not _is_axes(ax):
            raise TypeError(f"no logical axes for a tensor of shape "
                            f"{tuple(args.shape)}: {axes!r}")
        if ax == ():
            ax = (None,) * args.ndim
        return placement_for(args.shape, args.dtype, ax, mesh,
                             rules).bytes_per_device
    if isinstance(args, dict):
        return sum(placed_bytes(args[k], axes[k], mesh, rules) for k in args)
    if dataclasses.is_dataclass(args):
        # axes: a dict by field name, or an instance of the same dataclass
        of = axes.get if isinstance(axes, dict) \
            else (lambda name: getattr(axes, name))
        return sum(placed_bytes(getattr(args, f.name), of(f.name), mesh,
                                rules)
                   for f in dataclasses.fields(args)
                   if isinstance(getattr(args, f.name),
                                 (torch.Tensor, dict, tuple, list)))
    if isinstance(args, (list, tuple)):
        return sum(placed_bytes(a, x, mesh, rules) for a, x in zip(args, axes))
    return 0


def explain_sharding(spec_tree, mesh: MeshShape, rules=None,
                     max_rows: int = 0) -> str:
    """Human-readable table of param placements and per-device bytes."""
    rows = []
    total = 0

    def visit(tree, path):
        nonlocal total
        if isinstance(tree, ParamSpec):
            p = placement_for(tree.shape, tree.dtype, tree.axes, mesh, rules)
            total += p.bytes_per_device
            rows.append((path, tree.shape, p.spec, p.bytes_per_device))
        elif isinstance(tree, dict):
            for k in sorted(tree):
                visit(tree[k], f"{path}[{k!r}]")
        else:
            for i, t in enumerate(tree):
                visit(t, f"{path}[{i}]")

    visit(spec_tree, "")
    out = [f"{p}  {sh}  PartitionSpec{ps}  {b / 1e6:.1f}MB"
           for p, sh, ps, b in rows[:max_rows or len(rows)]]
    out.append(f"TOTAL per-device param bytes: {total / 1e9:.2f} GB")
    return "\n".join(out)
