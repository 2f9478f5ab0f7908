"""Logical-axis sharding rules (MaxText-style) mapped onto a mesh, and the
placement of arrays on a device mesh: the JAX package's
``repro.distributed.sharding`` with DTensor in GSPMD's place.

Every parameter and input declares *logical* axis names
(``ParamSpec.axes``); a rule table maps logical names to mesh axes.
``data`` composes with ``pod`` for every data-parallel dim, so the same
rules serve the single-pod (16, 16) and multi-pod (2, 16, 16) meshes.

Two kinds of mesh. A ``MeshShape`` holds axis names and sizes and no
devices: ``spec_for`` gives the entries a ``PartitionSpec`` would hold (per
dim ``None``, one axis name or a tuple of names), and ``param_placements``
/ ``placed_bytes`` the per-device shapes and bytes the dry run reads. A
``torch.distributed`` ``DeviceMesh`` (``launch.mesh.make_device_mesh``,
dims named like the ``MeshShape``'s axes) places tensors:
``placements_for`` turns ``spec_for``'s entries into DTensor placements
(the JAX package's ``sharding_for``), ``place`` a tree into DTensors whose
local shards are the ones JAX's ``addressable_shards`` hold (its
``param_shardings`` / ``replicated``), each leaf sliced as it is drawn.

The model code calls ``constrain(x, axes)`` with logical names where the
JAX package does. Outside ``activation_sharding`` it returns ``x``
untouched, so every one-card path runs as before; inside one, ``x`` is a
DTensor and ``constrain`` redistributes it to the rules' placements, the
collectives GSPMD would insert. ``no_constrain`` turns it off again.
``gather_dim`` is the FSDP gather of a weight's ``embed`` dim before its
use, made explicit so the collectives do not depend on DTensor's choice of
matrix-product strategy. Every placement change ``redistribute`` makes
carries its gradient (a gather's is a reduce-scatter), and ``constrain``
holds the cotangent to its placements as JAX transposes a sharding
constraint, so a placed train step's backward runs the collectives GSPMD
would, never one DTensor picks.

Divisibility guard: a mesh axis is only applied to a dim it divides evenly,
otherwise it is dropped (replicated) for that dim, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

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


# ------------------------------------------------ placing on a device mesh
def is_placed(x) -> bool:
    """``x`` is a DTensor (a tensor placed on a device mesh)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def mesh_shape_of(device_mesh) -> MeshShape:
    """A ``DeviceMesh``'s axis names and sizes."""
    return MeshShape(tuple(device_mesh.mesh_dim_names),
                     tuple(device_mesh.shape))


def placements_for(spec_entries, device_mesh) -> tuple:
    """The DTensor placements of ``spec_for``'s entries on ``device_mesh``:
    each mesh dim ``Shard(d)`` for the tensor dim ``d`` that names it, else
    ``Replicate()``. A dim named by several axes (``("pod", "data")``) is
    sharded by each of them in mesh order, as JAX shards it."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec_entries):
        pos = [names.index(a) for a in _spec_axes(entry)]
        if pos != sorted(pos):
            raise ValueError(f"dim {d} is sharded by {entry}, not in the "
                             f"mesh's order {names}")
        for p in pos:
            out[p] = Shard(d)
    return tuple(out)


def _shard_of(placements, device_mesh, dim: int) -> tuple[int, int]:
    from torch.distributed.tensor import Shard

    coord = device_mesh.get_coordinate()
    idx, n = 0, 1
    for i, p in enumerate(placements):
        if p == Shard(dim):
            size = device_mesh.size(i)
            idx, n = idx * size + coord[i], n * size
    return idx, n


def dim_shard(x, dim: int) -> tuple[int, int]:
    """(this rank's shard of tensor dim ``dim`` of the DTensor ``x``, the
    number of shards): row-major over the mesh dims that shard it, JAX's
    order."""
    return _shard_of(x.placements, x.device_mesh, dim)


def mesh_dims(x, dim: int) -> list:
    """The mesh dims that shard tensor dim ``dim`` of the DTensor ``x``."""
    from torch.distributed.tensor import Shard

    return [i for i, p in enumerate(x.placements) if p == Shard(dim)]


def from_local(local: torch.Tensor, device_mesh, placements, shape):
    """``DTensor.from_local`` of a contiguous global ``shape``, without a
    check across ranks."""
    from torch.distributed.tensor import DTensor

    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(local, device_mesh, placements,
                              run_check=False, shape=tuple(shape),
                              stride=stride)


def replicated_like(x, t):
    """``t`` replicated on ``x``'s mesh where ``x`` is placed (so the two
    can meet in one operation); ``t`` itself otherwise."""
    if not is_placed(x) or is_placed(t):
        return t
    from torch.distributed.tensor import Replicate

    return from_local(t, x.device_mesh, [Replicate()] * x.device_mesh.ndim,
                      t.shape)


def local_slice(full: torch.Tensor, spec_entries, device_mesh):
    """This rank's shard of ``full`` under ``spec_entries``: a view."""
    placements = placements_for(spec_entries, device_mesh)
    for d in range(full.ndim):
        idx, n = _shard_of(placements, device_mesh, d)
        if n > 1:
            size = full.shape[d] // n
            full = full.narrow(d, idx * size, size)
    return full


def _entries(x: torch.Tensor, axes, mesh: MeshShape, rules) -> tuple:
    ax = axes.axes if isinstance(axes, ParamSpec) else axes
    if not _is_axes(ax):
        raise TypeError(f"no logical axes for a tensor of shape "
                        f"{tuple(x.shape)}: {axes!r}")
    return spec_for(tuple(x.shape), ax or (None,) * x.ndim, mesh, rules)


def place_tensor(full: torch.Tensor, spec_entries, device_mesh):
    """``full`` as a DTensor on ``device_mesh`` holding this rank's shard
    (a copy, so ``full`` can be freed)."""
    local = local_slice(full, spec_entries, device_mesh)
    if local.shape != full.shape:
        local = local.clone(memory_format=torch.contiguous_format)
    return from_local(local, device_mesh,
                      placements_for(spec_entries, device_mesh), full.shape)


def place(tree, axes, device_mesh, rules=None):
    """``tree`` as DTensors on ``device_mesh`` (the JAX package's
    ``device_put`` under ``param_shardings`` / ``sharding_for``). ``axes``
    mirrors ``tree`` as in :func:`placed_bytes` (a ``ParamSpec`` tree, or
    tuples of logical names; ``()``: replicated). A leaf may be a tensor or
    a function of no arguments that returns one: it is called, this rank
    keeps its shard, and the whole leaf is dropped before the next is
    drawn, so a rank never holds more than one whole leaf. ``None`` leaves
    stay None."""
    mesh = mesh_shape_of(device_mesh)
    if tree is None:
        return None
    if callable(tree) and not isinstance(tree, torch.Tensor):
        tree = tree()
    if isinstance(tree, torch.Tensor):
        return place_tensor(tree, _entries(tree, axes, mesh, rules),
                            device_mesh)
    if isinstance(tree, dict):   # sorted: sources draw in the tree order
        return {k: place(tree[k], axes[k], device_mesh, rules)
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(place(t, a, device_mesh, rules)
                            for t, a in zip(tree, axes)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(t, a, device_mesh, rules)
                          for t, a in zip(tree, axes))
    raise TypeError(f"cannot place a {type(tree).__name__}")


def zeros(spec_tree, device_mesh, rules=None, device=None):
    """A ``ParamSpec`` tree (dicts, tuples, NamedTuples) as DTensors of
    zeros placed on ``device_mesh`` by the specs' axes under ``rules``:
    each rank allocates its local shard only (an optimizer state's
    ``init`` on placed parameters)."""
    mesh = mesh_shape_of(device_mesh)

    def one(s: ParamSpec):
        entries = spec_for(s.shape, s.axes, mesh, rules)
        local = placement_for(s.shape, s.dtype, s.axes, mesh,
                              rules).local_shape
        return from_local(torch.zeros(local, dtype=s.dtype, device=device),
                          device_mesh, placements_for(entries, device_mesh),
                          s.shape)
    return map_specs(one, spec_tree)


def redistribute(x, placements):
    """The DTensor ``x`` with ``placements``, each mesh dim's change made by
    the collectives of ``launch.mesh``, which carry gradients and stage
    through the host where the group's backend refuses a collective:
    ``Shard -> Replicate`` an all-gather (innermost mesh dim first; its
    gradient reduce-scatters a partial cotangent, or takes this rank's
    slice of a replicated one), ``Partial -> Shard`` a reduce-scatter (its
    gradient an all-gather), ``Replicate -> Shard`` this rank's slice (its
    gradient an all-gather of a sharded cotangent); a mesh dim of one rank
    only relabels. What is left (``Partial -> Replicate``, an all-reduce
    whose gradient moves nothing) is ``x.redistribute``'s."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, placements = x.device_mesh, tuple(placements)
    pl = list(x.placements)
    for i, b in enumerate(placements):
        if mesh.size(i) == 1:
            pl[i] = b                  # one rank: nothing moves
    if tuple(pl) != tuple(x.placements):
        x = _Relabel.apply(x, tuple(pl))

    def sharded_inside(pl, i, d):
        return any(pl[j] == Shard(d) for j in range(i + 1, len(pl)))

    for i in reversed(range(len(pl))):
        a, b = pl[i], placements[i]
        if isinstance(a, Shard) and isinstance(b, Replicate):
            if sharded_inside(pl, i, a.dim):
                raise ValueError(f"mesh dim {i} gathers tensor dim {a.dim} "
                                 f"while an inner mesh dim still shards it: "
                                 f"{x.placements}")
            x = _GatherDim.apply(x, i)
            pl[i] = b
    for i in range(len(pl)):
        a, b = pl[i], placements[i]
        if not isinstance(b, Shard) or a == b or sharded_inside(pl, i,
                                                                b.dim):
            continue
        if a.is_partial():
            x = _ReduceScatterDim.apply(x, i, b.dim)
        elif a.is_replicate():
            x = _ScatterDim.apply(x, i, b.dim)
        else:
            continue
        pl[i] = b
    return x if tuple(x.placements) == placements \
        else x.redistribute(mesh, placements)


def _coord(mesh, i: int) -> int:
    return mesh.get_coordinate()[i]


def _with(x, i: int, p, local):
    """``local`` as the DTensor of ``x``'s mesh and shape with mesh dim
    ``i``'s placement ``p``."""
    pl = list(x.placements)
    pl[i] = p
    return from_local(local, x.device_mesh, pl, x.shape)


def _slice_of(local, mesh, i: int, d: int):
    """This rank's slice along ``d`` of a ``local`` replicated over mesh
    dim ``i``."""
    n = mesh.size(i)
    size = local.shape[d] // n
    return local.narrow(d, _coord(mesh, i) * size, size).contiguous()


def _cotangent_gathered(g, i: int):
    """The cotangent ``g`` with mesh dim ``i`` made whole: gathered where it
    is sharded, as it is where it is replicated or partial."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import gather_raw

    p = g.placements[i]
    if not isinstance(p, Shard):
        return g
    return _with(g, i, Replicate(), gather_raw(g.to_local(), g.device_mesh,
                                               i, p.dim))


class _Relabel(torch.autograd.Function):
    """Placements changed on mesh dims of one rank (no data moves)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = tuple(x.placements)
        return from_local(x.to_local(), x.device_mesh, placements, x.shape)

    @staticmethod
    def backward(ctx, g):
        pl = [b if g.device_mesh.size(i) == 1 else a
              for i, (a, b) in enumerate(zip(g.placements, ctx.placements))]
        return from_local(g.to_local(), g.device_mesh, pl, g.shape), None


class _GatherDim(torch.autograd.Function):
    """Mesh dim ``i``: ``Shard(d) -> Replicate`` (an all-gather)."""

    @staticmethod
    def forward(ctx, x, i):
        from torch.distributed.tensor import Replicate

        from repro_torch.launch.mesh import gather_raw

        d = x.placements[i].dim
        ctx.i, ctx.d = i, d
        return _with(x, i, Replicate(), gather_raw(x.to_local(),
                                                   x.device_mesh, i, d))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Shard

        from repro_torch.launch.mesh import reduce_scatter_raw

        i, d = ctx.i, ctx.d
        g = _cotangent_gathered(g, i)
        if any(g.placements[j] == Shard(d)
               for j in range(i + 1, len(g.placements))):
            raise ValueError(f"the cotangent {g.placements} shards dim {d} "
                             f"inside mesh dim {i}")
        if g.placements[i].is_partial():
            local = reduce_scatter_raw(g.to_local(), g.device_mesh, i, d)
        else:
            local = _slice_of(g.to_local(), g.device_mesh, i, d)
        return _with(g, i, Shard(d), local), None


class _ScatterDim(torch.autograd.Function):
    """Mesh dim ``i``: ``Replicate -> Shard(d)`` (this rank's slice)."""

    @staticmethod
    def forward(ctx, x, i, d):
        from torch.distributed.tensor import Shard

        ctx.i = i
        return _with(x, i, Shard(d), _slice_of(x.to_local(), x.device_mesh,
                                               i, d))

    @staticmethod
    def backward(ctx, g):
        return _cotangent_gathered(g, ctx.i), None, None


class _ReduceScatterDim(torch.autograd.Function):
    """Mesh dim ``i``: ``Partial -> Shard(d)`` (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, i, d):
        from torch.distributed.tensor import Shard

        from repro_torch.launch.mesh import reduce_scatter_raw

        p = x.placements[i]
        if getattr(p, "reduce_op", "sum") != "sum":
            raise ValueError(f"a reduce-scatter of a {p} placement")
        ctx.i = i
        return _with(x, i, Shard(d), reduce_scatter_raw(
            x.to_local(), x.device_mesh, i, d))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate

        i = ctx.i
        g = _cotangent_gathered(g, i)
        if g.placements[i].is_partial():
            pl = list(g.placements)
            pl[i] = Replicate()
            g = g.redistribute(g.device_mesh, pl)
        return g, None, None


def redistribute_tree(tree, axes, rules=None):
    """Every DTensor of ``tree`` redistributed to the placements its
    logical ``axes`` (mirroring ``tree`` as in :func:`placed_bytes`: a
    ``ParamSpec`` tree or tuples of names; dicts, tuples and NamedTuples
    such as an optimizer state's) give under ``rules``: the JAX package's
    ``out_shardings``. Where ``axes`` is None the subtree is gathered
    whole on every rank, its DTensors plain tensors (a step's metrics)."""
    if axes is None:
        return gathered(tree)
    if is_placed(tree):
        mesh = tree.device_mesh
        return redistribute(tree, placements_for(
            _entries(tree, axes, mesh_shape_of(mesh), rules), mesh))
    if isinstance(tree, dict):
        return {k: redistribute_tree(v, axes[k], rules)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(redistribute_tree(t, a, rules)
                            for t, a in zip(tree, axes)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(redistribute_tree(t, a, rules)
                          for t, a in zip(tree, axes))
    return tree


def gathered(tree):
    """Every DTensor of ``tree`` (dicts, lists, tuples) gathered whole on
    every rank, as a plain tensor; other leaves as they are."""
    if is_placed(tree):
        from torch.distributed.tensor import Replicate

        return redistribute(tree, [Replicate()] * tree.device_mesh.ndim
                            ).to_local()
    if isinstance(tree, dict):
        return {k: gathered(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(gathered(t) for t in tree)
    return tree


def gather_dim(x, dim: int):
    """``x`` with tensor dim ``dim`` gathered on every mesh dim that shards
    it (``Shard(dim)`` -> ``Replicate()``): the FSDP all-gather of a
    weight's ``embed`` dim before it is used. A tensor that is not placed
    is returned as it is."""
    if not is_placed(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim = dim % x.ndim
    return redistribute(x, [Replicate() if p == Shard(dim) else p
                            for p in x.placements])


# ------------------------------------------------------- activation context
# Model code calls constrain(x, axes) with logical names; outside a context
# (every one-card run) it returns x, so models never depend on a mesh.
_TLS = threading.local()


@contextlib.contextmanager
def activation_sharding(device_mesh, rules: dict | None = None):
    """Inside, :func:`constrain` places activations on ``device_mesh`` by
    ``rules`` (the default rules when None)."""
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = (device_mesh, rules or DEFAULT_RULES)
    try:
        yield
    finally:
        _TLS.ctx = prev


def current_sharding():
    """``(device_mesh, rules)`` of the innermost ``activation_sharding``,
    or None."""
    return getattr(_TLS, "ctx", None)


def constrain(x, axes: tuple[str | None, ...]):
    """The JAX package's ``with_sharding_constraint`` by logical axis
    names: ``x`` itself outside a context; inside one, the DTensor ``x``
    redistributed to the placements the context's rules give its shape
    (:func:`constrain_to`)."""
    ctx = current_sharding()
    if ctx is None:
        return x
    mesh, rules = ctx
    if not is_placed(x):
        raise TypeError(f"constrain inside activation_sharding needs a "
                        f"DTensor, got a {type(x).__name__} of shape "
                        f"{tuple(x.shape)}")
    spec = spec_for(tuple(x.shape), axes, mesh_shape_of(mesh), rules)
    return constrain_to(x, placements_for(spec, mesh))


def constrain_to(x, placements):
    """The DTensor ``x`` redistributed to ``placements`` (:func:`
    redistribute`), its cotangent held to the same placements, as JAX
    transposes ``with_sharding_constraint`` into a constraint on the
    cotangent: a partial cotangent is summed there (all-reduced, or
    reduce-scattered where the placement shards), so no partial sum runs
    on through the backward into an operation that would have DTensor
    gather a sharded operand. On a mesh dim that the forward gathers
    (``Shard -> Replicate``) a partial cotangent is left to the gather's
    backward, which reduce-scatters it."""
    from torch.distributed.tensor import Shard

    placements = tuple(placements)
    keep = tuple(i for i, (a, b) in enumerate(zip(x.placements, placements))
                 if isinstance(a, Shard) and b.is_replicate())
    y = redistribute(x, placements)
    if not torch.is_grad_enabled() or not y.requires_grad:
        return y
    return _CotangentAs.apply(y, placements, keep)


class _CotangentAs(torch.autograd.Function):
    """Forward ``x`` as it is; backward the cotangent redistributed to
    ``placements`` (a partial one left partial on the mesh dims
    ``keep``)."""

    @staticmethod
    def forward(ctx, x, placements, keep):
        ctx.placements, ctx.keep = placements, keep
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        want = tuple(p if i in ctx.keep and p.is_partial() else q
                     for i, (p, q) in enumerate(zip(g.placements,
                                                    ctx.placements)))
        return redistribute(g, want), None, None


@contextlib.contextmanager
def no_constrain():
    """Turn :func:`constrain` off (the JAX package's, for ``shard_map``
    bodies, where arrays are per-shard locals)."""
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = None
    try:
        yield
    finally:
        _TLS.ctx = prev
