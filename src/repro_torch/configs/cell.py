"""CellPlan: the uniform (arch x shape) contract of the dry run, the
roofline and the launchers, the JAX package's ``repro.configs.cell`` in
PyTorch.

``ArchSpec.build(shape, device=None, reduced=None)`` returns a CellPlan at
full size: on ``device="meta"`` every argument (parameters, optimizer state,
batch, cache, index arrays) is a meta tensor, PyTorch's ShapeDtypeStruct,
and nothing is allocated; on a real device the arguments are drawn from a
seeded ``torch.Generator``. ``reduced`` cuts a measured run to what one
card holds (``{"batch": b}`` first, then ``{"n_layers": l}``), and the plan
records the cut and the dims that remain cuttable (``dims``), so a caller
cuts a cell without knowing its arch. ``ArchSpec.build_smoke(shape,
device=None)`` returns the reduced-config plan with real (tiny) tensors.

``fn(*args)`` runs one step. ``arg_axes`` mirrors ``args`` with each
tensor's logical axis names (a ``ParamSpec`` tree where ``args`` holds
parameters or optimizer state), which ``distributed.sharding`` maps onto
a mesh shape for the per-device bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.distributed.sharding import MeshShape, param_placements
from repro_torch.models.common import ParamSpec, map_specs, spec_to_meta
from repro_torch.train.optimizer import AdamState, FactorState


@dataclasses.dataclass
class CellPlan:
    arch_id: str
    shape: str
    fn: Callable                     # fn(*args): one step
    args: tuple                      # meta tensors (dry run) or real ones
    kind: str = "train"              # 'train' | 'serve'
    notes: str = ""
    reduced: dict = dataclasses.field(default_factory=dict)  # {} at full size
    # the dims a measured run may cut, at this plan's size, in the order
    # they are cut ({"batch": b, "n_layers": l}; {} where none is)
    dims: dict = dataclasses.field(default_factory=dict)
    arg_axes: Any = None             # logical axes mirroring args
    rules: Any = None                # the cell's rule preset (None: default)


@dataclasses.dataclass
class ArchSpec:
    arch_id: str
    family: str
    shapes: tuple[str, ...]
    build: Callable[..., CellPlan]          # build(shape, device=None, reduced=None)
    build_smoke: Callable[..., CellPlan]    # build_smoke(shape, device=None)
    describe: str = ""


# ------------------------------------------------------------------- helpers
def meta(shape, dtype=torch.float32) -> torch.Tensor:
    """A meta tensor: the JAX package's ``sds``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def opt_state_specs(optimizer_name: str, spec_tree) -> Any:
    """``ParamSpec`` tree of the optimizer state, leaf for leaf what the
    port's ``optimizer.init`` makes: AdamW's ``AdamState(mu, nu, count)``,
    Adafactor's ``FactorState(vr, vc, count)``, SGD's tree of momenta."""
    count = ParamSpec((), (), torch.int32)
    if optimizer_name == "adamw":
        st = lambda s: ParamSpec(s.shape, s.axes, torch.float32)
        return AdamState(mu=map_specs(st, spec_tree),
                         nu=map_specs(st, spec_tree), count=count)
    if optimizer_name == "adafactor":
        def vr(s):
            if len(s.shape) >= 2:
                return ParamSpec(s.shape[:-1], s.axes[:-1], torch.float32)
            return ParamSpec(s.shape, s.axes, torch.float32)

        def vc(s):
            if len(s.shape) >= 2:
                return ParamSpec(s.shape[:-2] + s.shape[-1:],
                                 s.axes[:-2] + s.axes[-1:], torch.float32)
            return ParamSpec((1,), (None,), torch.float32)

        return FactorState(vr=map_specs(vr, spec_tree),
                           vc=map_specs(vc, spec_tree), count=count)
    if optimizer_name == "sgd":
        return map_specs(lambda s: ParamSpec(s.shape, s.axes, torch.float32),
                         spec_tree)
    raise ValueError(optimizer_name)


def state_specs(optimizer_name: str, spec_tree, mesh: MeshShape | None = None,
                rules=None):
    """The JAX package's ``state_and_shardings``: ``(params, opt_state,
    params' placements, opt_state's placements)``, the first two as meta
    trees, the placements under ``mesh`` (None without one)."""
    o_specs = opt_state_specs(optimizer_name, spec_tree)
    placed = (None, None) if mesh is None else (
        param_placements(spec_tree, mesh, rules),
        param_placements(o_specs, mesh, rules))
    return (spec_to_meta(spec_tree), spec_to_meta(o_specs), *placed)


def replicated_specs(spec_tree):
    """``spec_tree`` with every axis None: placed whole on every device."""
    return map_specs(lambda s: ParamSpec(s.shape, (None,) * len(s.shape),
                                         s.dtype), spec_tree)


def on_meta(device) -> bool:
    return device is not None and torch.device(device).type == "meta"


def generator(device, seed: int = 0) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def tree_tensors(tree) -> list:
    """The tensors of an argument tree (dicts in sorted key order, tuples and
    NamedTuples in order, dataclasses by field; None and plain values
    skipped): the JAX package's leaf order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_tensors(tree[k])]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in tree_tensors(getattr(tree, f.name))]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tree_tensors(x)]
    return []


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_tensors(tree))
