"""NequIP: E(3)-equivariant interatomic potential [arXiv:2101.03164].

The JAX package's ``repro.models.gnn.nequip`` in PyTorch. Features are
direct sums of O(3) irreps, stored as {l: (N, mul, 2l+1)}. One interaction
block (paper Fig. 1):

  for each path (l1, l2, l3) with l1 in features, l2 in Y(r_ij), l3 <= l_max:
     m_ij^{l3} += R_path(|r_ij|) * CG[l3 l1 l2] (h_j^{l1} (x) Y^{l2}(r_ij))
  h_i <- SelfInteraction( h_i , sum_{j in N(i)} m_ij )       (per-l linear)
  h_i <- Gate(h_i)     (silu on l=0; l>0 gated by learned scalar sigmoid)

R_path is an MLP over n_rbf Bessel radial basis functions with a smooth
polynomial cutoff envelope. CG intertwiners come from
``repro_torch.models.gnn.equivariant`` (numerically exact, host-side
constants).

Config: 5 layers, 32 channels per irrep, l_max = 2, 8 RBFs, cutoff 5 A.

Output: per-atom scalar energies (l=0 head) summed per graph; forces =
-grad(E, positions). Every gather (the positions at both ends of an edge,
the features at its source, the species' embeddings) and every segment sum
(one per path and the energy readout) runs on the segment kernel's graph
entry, whose derivatives of every order are its gathers and sums again:
the force loss, a gradient of a gradient, stays on the kernel. The
interactions run without remat: the molecule cells are small, and a
checkpointed block would have to carry the force term's second-order graph
through its recompute.

``forward_energy_shardmap`` is the JAX package's destination-partitioned
forward (its ``shard_map`` path, EAGr's reader partitioning applied to
message passing) over the ranks of a ``torch.distributed`` group
(``launch.mesh.ShardMesh``), SPMD: every rank makes the same call on the
same global arrays and works on its own node range and edge slice. Its
input contract is the JAX package's: rank r's edge slice holds only edges
whose destination lies in r's node range; any other edge's message is
dropped (``configs/nequip.arrange_to_contract`` arranges a batch so).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.segment_agg.ops import (edge_plan, graph_sum,
                                                tensor_memo)
from repro_torch.models.common import ParamSpec
from repro_torch.models.gnn.common import gather
from repro_torch.models.gnn.equivariant import intertwiner, tp_paths


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    d_hidden: int = 32          # multiplicity per irrep
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 10
    radial_hidden: int = 64
    compute_dtype: torch.dtype = torch.float32

    @property
    def ls(self) -> tuple[int, ...]:
        return tuple(range(self.l_max + 1))

    @property
    def paths(self):
        return tp_paths(self.ls, self.ls, self.ls)


# --------------------------------------------------------------- radial basis
def bessel_rbf(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """sin(n pi d / rc) / d Bessel basis with smooth polynomial envelope."""
    d = dist.clamp_min(1e-6)[..., None]
    n = torch.arange(1, n_rbf + 1, dtype=d.dtype, device=d.device)
    basis = math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * d / cutoff) / d
    u = (dist / cutoff).clamp(0.0, 1.0)[..., None]
    env = 1.0 - 10.0 * u**3 + 15.0 * u**4 - 6.0 * u**5   # C2 cutoff poly
    return basis * env


# -------------------------------------------------------------------- params
def param_specs(cfg: NequIPConfig):
    mul, ls, L = cfg.d_hidden, cfg.ls, cfg.n_layers
    n_paths = len(cfg.paths)
    layer = {
        # radial MLP -> one weight per (path, channel)
        "rad_w0": ParamSpec((L, cfg.n_rbf, cfg.radial_hidden),
                            ("layers", None, None)),
        "rad_b0": ParamSpec((L, cfg.radial_hidden), ("layers", None),
                            init_scale=0.0),
        "rad_w1": ParamSpec((L, cfg.radial_hidden, n_paths * mul),
                            ("layers", None, "mlp")),
        # per-l self-interaction mixing after aggregation (input: mul * n_in_paths)
        **{f"self_l{l}": ParamSpec(
            (L, mul * (1 + sum(1 for (a, b, c) in cfg.paths if c == l)), mul),
            ("layers", None, None)) for l in ls},
        # gate scalars for l>0 irreps
        "gate_w": ParamSpec((L, mul, mul * cfg.l_max), ("layers", None, None)),
        "gate_b": ParamSpec((L, mul * cfg.l_max), ("layers", None),
                            init_scale=0.0),
    }
    return {
        "embed": ParamSpec((cfg.n_species, mul), ("vocab", None)),
        "layers": layer,
        "out_w0": ParamSpec((mul, mul), (None, None)),
        "out_b0": ParamSpec((mul,), (None,), init_scale=0.0),
        "out_w1": ParamSpec((mul, 1), (None, None)),
    }


# ------------------------------------------------------------------- forward
_T_CACHE: dict = {}


def _intertwiner_tensor(path, dtype, device) -> torch.Tensor:
    """A path's intertwiner (2l3+1, 2l1+1, 2l2+1) as a constant tensor,
    rounded once from fp64 to ``dtype`` on ``device``."""
    key = (path, dtype, device)
    t = _T_CACHE.get(key)
    if t is None:
        t = torch.as_tensor(np.asarray(intertwiner(*path)), dtype=dtype,
                            device=device)
        _T_CACHE[key] = t
    return t


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the two dtypes' promoted type (JAX's promotion: bf16
    with fp32 gives fp32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _ein(eq: str, *ts: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the operands' promoted type."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.einsum(eq, *(t.to(dt) for t in ts))


def _interaction(lp, feats, sh, rad, edge_src, edge_dst, n_nodes,
                 cfg: NequIPConfig, *, gather=None, scatter=None):
    """One NequIP interaction block. feats: {l: (N, mul, 2l+1)}.

    gather/scatter hooks let the destination-partitioned path
    (``forward_energy_shardmap``) reuse the same math:
      gather(f)  default f[edge_src]
      scatter(m) default the sum of m into edge_dst's n_nodes rows
    """
    mul = cfg.d_hidden
    if gather is None:
        gather = functools.partial(_gather_rows, index=edge_src)
    if scatter is None:
        scatter = functools.partial(graph_sum, plan=edge_plan(edge_dst,
                                                              n_nodes))
    # per-edge, per-path, per-channel radial weights
    h = F.silu(_mm(rad, lp["rad_w0"]) + lp["rad_b0"])
    w = _mm(h, lp["rad_w1"]).reshape(-1, len(cfg.paths), mul)  # (E, P, mul)

    src_full = {l: gather(feats[l]) for l in cfg.ls}      # one per l
    msgs = {l: [] for l in cfg.ls}
    for p_idx, (l1, l2, l3) in enumerate(cfg.paths):
        T = _intertwiner_tensor((l1, l2, l3), feats[l1].dtype,
                                feats[l1].device)        # (2l3+1,2l1+1,2l2+1)
        m = _ein("kij,eci,ej->eck", T, src_full[l1],
                 sh[l2])                                 # (E, mul, 2l3+1)
        msgs[l3].append(m * w[:, p_idx, :, None])
    out = {}
    for l in cfg.ls:
        stack = [feats[l]] + [scatter(m) for m in msgs[l]]
        cat = torch.cat(stack, dim=1)                    # (N, mul*(1+P_l), 2l+1)
        out[l] = _ein("nci,cd->ndi", cat, lp[f"self_l{l}"])
    # gate nonlinearity
    scalars = out[0][..., 0]                              # (N, mul)
    gates = torch.sigmoid(_mm(scalars, lp["gate_w"]) + lp["gate_b"])
    gates = gates.reshape(-1, cfg.l_max, mul)
    new = {0: F.silu(scalars)[..., None]}
    for i, l in enumerate(range(1, cfg.l_max + 1)):
        new[l] = out[l] * gates[:, i, :, None]
    # residual on scalars (higher l start at zero features in layer 0)
    new[0] = new[0] + feats[0]
    return new


def _gather_rows(h: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    return gather(h, index)


def _geometry(pos, edge_src, edge_dst, edge_mask, cfg: NequIPConfig):
    """The edges' spherical harmonics {l: (E, 2l+1)} and radial basis (E,
    n_rbf) in the compute dtype, masked edges and edges past the cutoff
    zeroed; ``pos`` holds every row the edges name."""
    cdt = cfg.compute_dtype
    rel = gather(pos, edge_dst) - gather(pos, edge_src)  # (E, 3)
    # grad-safe norm: masked/self edges have rel = 0; plain norm() gives NaN grads
    dist = torch.sqrt(torch.sum(rel * rel, dim=-1) + 1e-12)
    unit = rel / dist[:, None]
    emask = (edge_mask & (dist < cfg.cutoff)).to(cdt)[:, None]
    # cast basis functions to compute dtype: fp32 sh/rad would silently
    # promote every edge message back to fp32
    sh = {l: (_sph(l, unit) * emask).to(cdt) for l in cfg.ls}
    rad = (bessel_rbf(dist, cfg.n_rbf, cfg.cutoff) * emask).to(cdt)
    return sh, rad


def _embed(params, species, node_mask, cfg: NequIPConfig) -> dict:
    """Layer 0's features of the atoms ``species`` names: the embedding
    at l = 0, zeros above."""
    cdt = cfg.compute_dtype
    n = species.shape[0]
    feats = {0: (gather(params["embed"], species)
                 * node_mask.to(cdt)[:, None])[..., None]}
    for l in range(1, cfg.l_max + 1):
        feats[l] = torch.zeros((n, cfg.d_hidden, 2 * l + 1), dtype=cdt,
                               device=species.device)
    return feats


def _layers(params, feats, sh, rad, cfg: NequIPConfig, **hooks) -> dict:
    layers = {k: v.unbind(0) for k, v in params["layers"].items()}
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in layers.items()}
        feats = _interaction(lp, feats, sh, rad, cfg=cfg, **hooks)
    return feats


def _atom_energies(params, feats, node_mask, cfg: NequIPConfig):
    scalars = feats[0][..., 0]
    e_atom = F.silu(_mm(scalars, params["out_w0"]) + params["out_b0"])
    return _mm(e_atom, params["out_w1"])[:, 0] * node_mask.to(
        cfg.compute_dtype)


def forward_energy(params, positions, species, edge_src, edge_dst, edge_mask,
                   node_mask, graph_ids, n_graphs, cfg: NequIPConfig):
    """positions (N,3), species (N,), edges (E,). Returns (n_graphs,) energies."""
    n = positions.shape[0]
    sh, rad = _geometry(positions, edge_src, edge_dst, edge_mask, cfg)
    feats = _embed(params, species, node_mask, cfg)
    feats = _layers(params, feats, sh, rad, cfg, edge_src=edge_src,
                    edge_dst=edge_dst, n_nodes=n)
    e_atom = _atom_energies(params, feats, node_mask, cfg)
    return graph_sum(e_atom, edge_plan(graph_ids, n_graphs))


@dataclasses.dataclass(frozen=True)
class ShardInputs:
    """One rank's part of a batch for ``forward_energy_shardmap``, on the
    rank's device: its node range [lo, lo + n_local) and its edge slice
    (global row ids), its edges' local destination rows ``seg`` and the
    plans of every gather and sum over them."""

    lo: int
    n_local: int
    species: torch.Tensor      # (n_local,)
    node_mask: torch.Tensor    # (n_local,)
    edge_src: torch.Tensor     # (e_local,) rows of the gathered arrays
    edge_dst: torch.Tensor     # (e_local,)
    edge_mask: torch.Tensor    # (e_local,)
    seg: torch.Tensor          # (e_local,) edge_dst - lo
    atoms: torch.Tensor        # (n_local,) zeros: the readout's one row


def shard_inputs(mesh, species, edge_src, edge_dst, edge_mask, node_mask,
                 cfg: NequIPConfig) -> ShardInputs:
    """This rank's ``ShardInputs`` of the global arrays, made (and their
    plans built) once per set of arrays and kept while they live
    (``ops.tensor_memo``). Only the rank's node range and edge slice move
    to its device."""
    n, e = species.shape[0], edge_src.shape[0]
    if n % mesh.world:
        raise ValueError(f"{n} atoms do not split into {mesh.world} "
                         f"node ranges: {(n, mesh.world)}")
    if e % mesh.world:
        raise ValueError(f"{e} edges do not split into {mesh.world} "
                         f"edge slices: {(e, mesh.world)}")
    n_local, e_local = n // mesh.world, e // mesh.world
    lo, le = mesh.rank * n_local, mesh.rank * e_local
    dev = mesh.device

    def part(t, start, size):
        return t.detach()[start:start + size].to(dev)

    def make() -> ShardInputs:
        esrc, edst = part(edge_src, le, e_local), part(edge_dst, le, e_local)
        out = ShardInputs(
            lo=lo, n_local=n_local, species=part(species, lo, n_local),
            node_mask=part(node_mask, lo, n_local), edge_src=esrc,
            edge_dst=edst, edge_mask=part(edge_mask, le, e_local),
            seg=edst - lo,
            atoms=torch.zeros(n_local, dtype=torch.int32, device=dev))
        # the plans of every gather and sum of the forward: the positions'
        # and features' gathers over all n rows, the species' embedding,
        # the messages into the rank's rows (foreign and masked edges left
        # out: the JAX package's sink row), the readout
        edge_plan(out.edge_src, n)
        edge_plan(out.edge_dst, n)
        edge_plan(out.species, cfg.n_species)
        edge_plan(out.seg, n_local, out.edge_mask)
        edge_plan(out.atoms, 1)
        return out

    return tensor_memo(
        ("shard_inputs", mesh.rank, mesh.world, str(dev), cfg.n_species),
        (species, edge_src, edge_dst, edge_mask, node_mask), make)


def forward_energy_shardmap(params, positions, species, edge_src, edge_dst,
                            edge_mask, node_mask, graph_ids, n_graphs,
                            cfg: NequIPConfig, mesh):
    """Destination-partitioned message passing over the ranks of ``mesh``
    (a ``launch.mesh.ShardMesh``), the JAX package's ``shard_map`` path.
    Every rank calls it with the same global arrays and parameters.

    INPUT CONTRACT (the input pipeline's job, declared here): atoms split
    into ``mesh.world`` contiguous ranges and edges into as many slices,
    rank r's edge slice holding only edges whose DESTINATION lies in r's
    node range (any source); an edge that breaks it is dropped, as the
    JAX package's sink row drops it. Each rank then: all-gathers the
    positions once, computes its edges' geometry, per layer all-gathers
    each l's features once and gathers them at the global sources, and
    sums the messages into its OWN rows. Parameters enter through
    ``mesh.replicate``, so their gradients are summed over the ranks.

    graph_ids and n_graphs are ignored: the single-graph shapes that take
    this path have one graph. Returns the energy (1,), on every rank."""
    loc = shard_inputs(mesh, species, edge_src, edge_dst, edge_mask,
                       node_mask, cfg)
    prm = mesh.replicate(params)
    pos_l = positions[loc.lo:loc.lo + loc.n_local].to(mesh.device)
    pos_f = mesh.all_gather_tiled(pos_l)
    sh, rad = _geometry(pos_f, loc.edge_src, loc.edge_dst, loc.edge_mask, cfg)
    feats = _embed(prm, loc.species, loc.node_mask, cfg)
    seg_plan = edge_plan(loc.seg, loc.n_local, loc.edge_mask)

    def gather_full(f):
        return gather(mesh.all_gather_tiled(f), loc.edge_src)

    feats = _layers(prm, feats, sh, rad, cfg, edge_src=None, edge_dst=None,
                    n_nodes=None, gather=gather_full,
                    scatter=functools.partial(graph_sum, plan=seg_plan))
    e_atom = _atom_energies(prm, feats, loc.node_mask, cfg)
    return mesh.psum(graph_sum(e_atom, edge_plan(loc.atoms, 1)))


def _sph(l: int, unit: torch.Tensor) -> torch.Tensor:
    """The host ``real_sph_harm`` formulas on tensors (l <= 2)."""
    x, y, z = unit[..., 0], unit[..., 1], unit[..., 2]
    if l == 0:
        return torch.ones(unit.shape[:-1] + (1,), dtype=unit.dtype,
                          device=unit.device)
    if l == 1:
        return unit
    if l == 2:
        s3 = float(np.sqrt(3.0))
        return torch.stack([
            x * y, y * z, (2 * z * z - x * x - y * y) / (2 * s3),
            x * z, (x * x - y * y) / 2.0], dim=-1) * s3
    raise NotImplementedError(l)


def _energies_and_grad(params, positions, species, edge_src, edge_dst,
                       edge_mask, node_mask, graph_ids, n_graphs, cfg,
                       create_graph: bool):
    pos = positions.detach().requires_grad_(True)
    with torch.enable_grad():
        energies = forward_energy(params, pos, species, edge_src, edge_dst,
                                  edge_mask, node_mask, graph_ids, n_graphs,
                                  cfg)
        (grad,) = torch.autograd.grad(energies.sum(), pos,
                                      create_graph=create_graph)
    return energies, grad


def energy_and_forces(params, positions, species, edge_src, edge_dst,
                      edge_mask, node_mask, graph_ids, n_graphs,
                      cfg: NequIPConfig):
    """(energies (n_graphs,), forces = -dE/dpositions (N, 3), total
    energy)."""
    energies, grad = _energies_and_grad(
        params, positions, species, edge_src, edge_dst, edge_mask, node_mask,
        graph_ids, n_graphs, cfg, create_graph=False)
    energies = energies.detach()
    return energies, -grad, energies.sum()


def loss_fn(params, batch, cfg: NequIPConfig, force_weight: float = 1.0,
            use_forces: bool = True):
    """batch: dict with positions/species/edge_src/edge_dst/edge_mask/node_mask/
    graph_ids/energy_targets/force_targets. n_graphs = len(energy_targets).
    use_forces=False skips the grad-through-energy force term (used for the
    huge assigned graph shapes where there is no force supervision anyway).
    With forces, their gradient in the parameters is a gradient of a
    gradient (``create_graph``)."""
    n_graphs = batch["energy_targets"].shape[0]
    args = (params, batch["positions"], batch["species"], batch["edge_src"],
            batch["edge_dst"], batch["edge_mask"], batch["node_mask"],
            batch["graph_ids"], n_graphs, cfg)
    e_tgt = batch["energy_targets"].float()
    if not use_forces:
        energies = forward_energy(*args)
        e_loss = ((energies - e_tgt) ** 2).mean()
        zero = torch.zeros((), dtype=torch.float32, device=e_loss.device)
        return e_loss, {"e_mse": e_loss, "f_mse": zero}

    energies, grad = _energies_and_grad(*args, create_graph=True)
    forces = -grad
    e_loss = ((energies - e_tgt) ** 2).mean()
    nm = batch["node_mask"].float()[:, None]
    f_loss = (((forces - batch["force_targets"]) ** 2) * nm).sum() \
        / (nm.sum() * 3).clamp_min(1.0)
    loss = e_loss + force_weight * f_loss
    return loss, {"e_mse": e_loss, "f_mse": f_loss}
