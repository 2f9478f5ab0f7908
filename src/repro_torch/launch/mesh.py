"""Production mesh shapes, device meshes over a ``torch.distributed`` group,
and the EAGr shard mesh.

``make_production_mesh`` / ``make_host_mesh`` are the JAX package's
``repro.launch.mesh`` as ``MeshShape``s (axis names and sizes, no devices),
which the sharding rules and the dry run's per-device bytes read.
``make_device_mesh`` turns a ``MeshShape`` into a ``DeviceMesh`` over the
running group (the JAX package's ``Mesh(devices.reshape(shape))``: ranks
in row-major order), on which ``distributed.sharding.place`` puts DTensors;
with ``fake=True`` over a fake process group of ``shape.size`` ranks
(``fake_group``), which the dry run uses to count a placed step's
collectives on meta tensors without a card or a peer.

``make_shard_mesh`` is the counterpart of the JAX package's 1-D shard mesh:
where the JAX package runs one controller over one device per shard, the
port runs one process per shard (SPMD), each holding its own shard. The
returned :class:`ShardMesh` carries the group, this rank, the world size and
this rank's device, and stages every collective on the device the group's
backend takes: the rank's CUDA device for ``nccl``, the CPU for ``gloo``.

``init_group`` and ``spawn_group`` start such a group on one host: a
``file://`` store, a timeout on every collective, and a join deadline, so a
rank that fails or hangs ends the run with an error instead of a hang.

On a ``DeviceMesh``, ``all_gather`` (its gradient a reduce-scatter)
and ``all_reduce_sum`` (its gradient the identity) carry gradients; the
``*_raw`` functions are the collectives outside autograd, from which
``distributed.sharding.redistribute`` builds every placement change of
a placed step as an autograd Function. On a ``ShardMesh``, three collectives
carry gradients, as the JAX package's ``shard_map`` transposes them: ``all_gather_tiled`` (JAX's ``all_gather(..., tiled=True)``;
backward: the sum over the ranks of the cotangent's slice for this rank,
JAX's ``psum_scatter``), ``psum`` (forward: the sum over the ranks; backward:
the identity, every rank holding the whole cotangent of the replicated
output) and ``replicate`` (JAX's implicit broadcast of a ``P()`` input:
forward the identity, backward the sum of each leaf's gradient over the
ranks). Every sum over the ranks adds the ranks' tensors in rank order
(floating types below fp32 in fp32, rounded once), so it is deterministic
and bit-equal on every rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import time

import torch

from repro_torch.distributed.sharding import MeshShape
from repro_torch.tree import tree_leaves, tree_unflatten


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """Single pod: (16, 16) = 256 chips, axes (data, model).
    Multi-pod: (2, 16, 16) = 512 chips, axes (pod, data, model); the pod axis
    composes with data for all data-parallel collectives."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh() -> MeshShape:
    """1-device mesh with the production axis names."""
    return MeshShape(("data", "model"), (1, 1))


@contextlib.contextmanager
def fake_group(world: int):
    """A fake default process group of ``world`` ranks, this process rank 0
    (``torch.testing._internal.distributed.fake_pg``): collectives return
    at once and move nothing. Raises inside a real group; destroyed on
    exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised: the "
                           "fake group is the dry run's alone")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_device_mesh(shape: MeshShape, *, fake: bool = False,
                     device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` over the running default group
    (started by :func:`init_group` / :func:`spawn_group`), its dims named
    like ``shape``'s axes, ranks in row-major order. The group must hold
    exactly ``shape.size`` ranks. ``fake``: the caller runs inside
    :func:`fake_group` (the dry run), and the mesh's device type is the
    CPU's (its tensors are meta tensors). ``device_type``: ``cuda`` unless
    ``fake`` or the group's ranks run on the CPU (``"cpu"``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: start one with init_group")
    if fake != (str(dist.get_backend()) == "fake"):
        raise ValueError(f"fake={fake} on a {dist.get_backend()} group")
    world = dist.get_world_size()
    if world != shape.size:
        raise ValueError(f"a {shape.shape} mesh needs {shape.size} ranks, the "
                         f"group has {world}")
    dev = "cpu" if fake else (device_type or "cuda")
    return DeviceMesh(dev, torch.arange(world).reshape(shape.shape),
                      mesh_dim_names=tuple(shape.axis_names))


def _backend(device_mesh, mesh_dim: int) -> str:
    import torch.distributed as dist

    return str(dist.get_backend(device_mesh.get_group(mesh_dim)))


def host_staged(t: torch.Tensor, device_mesh, mesh_dim: int) -> bool:
    """Whether a collective of ``t`` over ``device_mesh``'s dim
    ``mesh_dim`` goes through host memory: CUDA tensors on a gloo
    group."""
    return t.device.type == "cuda" and \
        _backend(device_mesh, mesh_dim) == "gloo"


def _wait(out):
    import torch.distributed._functional_collectives as funcol

    return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) \
        else out


def gather_raw(t: torch.Tensor, device_mesh, mesh_dim: int,
               dim: int = 0) -> torch.Tensor:
    """:func:`all_gather`'s forward, outside autograd."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    group = device_mesh.get_group(mesh_dim)
    if host_staged(t, device_mesh, mesh_dim):
        host = t.detach().movedim(dim, 0).contiguous().cpu()
        n = dist.get_world_size(group)
        out = torch.empty((n * host.shape[0],) + tuple(host.shape[1:]),
                          dtype=host.dtype)
        dist.all_gather_into_tensor(out, host, group=group)
        return out.to(t.device).movedim(0, dim).contiguous()
    gather = getattr(funcol, "all_gather_single", None) \
        or funcol.all_gather_tensor       # the name before torch 2.12
    return _wait(gather(t.detach().contiguous(), dim,
                        (device_mesh, mesh_dim)))


def reduce_scatter_raw(t: torch.Tensor, device_mesh, mesh_dim: int,
                       dim: int = 0) -> torch.Tensor:
    """The reduce-scatter of a placed step, outside autograd: every rank's
    ``t`` summed, this rank's slice along ``dim``. On a real group one
    all-to-all (through host memory where :func:`host_staged`), then the
    ranks' blocks added in rank order (floating types below fp32 in fp32,
    rounded once); on the dry run's fake group the functional
    reduce-scatter, which it counts as one."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    group = device_mesh.get_group(mesh_dim)
    n = dist.get_world_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over {n} ranks")
    if _backend(device_mesh, mesh_dim) == "fake":
        return _wait(funcol.reduce_scatter_tensor(
            t.detach().contiguous(), "sum", dim, (device_mesh, mesh_dim)))
    x = t.detach().movedim(dim, 0).contiguous()
    if host_staged(t, device_mesh, mesh_dim):
        x = x.cpu()
    got = torch.empty_like(x)
    dist.all_to_all_single(got, x, group=group)
    got = got.to(t.device)
    return _sum_in_order(list(got.chunk(n)), t.dtype).movedim(0, dim) \
        .contiguous()


def all_reduce_raw(t: torch.Tensor, device_mesh, mesh_dims,
                   op: str = "sum") -> torch.Tensor:
    """``t`` reduced (``sum`` or ``max``) over each of ``device_mesh``'s
    dims ``mesh_dims`` in turn, outside autograd: the functional
    all-reduce (gloo takes CUDA tensors there), every rank the same
    bits."""
    import torch.distributed._functional_collectives as funcol

    out = t.detach()
    for i in mesh_dims:
        if device_mesh.size(i) > 1:
            out = _wait(funcol.all_reduce(out.contiguous(), op,
                                          (device_mesh, i)))
    return out


def all_gather(t: torch.Tensor, device_mesh, mesh_dim: int,
               dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` along ``device_mesh``'s dim ``mesh_dim``
    concatenated along tensor dim ``dim`` in that mesh dim's rank order:
    the all-gather of every placed step (the FSDP gathers, the sequence
    gathers of ``residual_sp``, the decode partials), a functional
    collective. Its gradient reduce-scatters the cotangent
    (``reduce_scatter_raw``; JAX's ``psum_scatter``, the all-gather's
    transpose): each rank's cotangent is its own partial.

    The one collective that gloo refuses on CUDA tensors: the functional
    all-gather (``_c10d_functional.all_gather_into_tensor``) kills the
    process on a gloo group with CUDA inputs (torch 2.11; gloo's other
    collectives, functional or not, and its non-functional all-gather take
    CUDA tensors). There it is staged through host memory, the
    non-functional all-gather on CPU copies, and the result copied back
    to ``t``'s device (:func:`host_staged`)."""
    return _AllGather.apply(t, device_mesh, mesh_dim, dim)


def all_reduce_sum(t: torch.Tensor, device_mesh, mesh_dims) -> torch.Tensor:
    """The sum of ``t`` over ``device_mesh``'s dims ``mesh_dims``, on every
    rank (``all_reduce_raw``). Its gradient is the cotangent as it is: the
    output is the same on every rank, and so is what follows it."""
    return _AllReduceSum.apply(t, device_mesh, tuple(mesh_dims))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, device_mesh, mesh_dim, dim):
        ctx.args = (device_mesh, mesh_dim, dim)
        return gather_raw(t, device_mesh, mesh_dim, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_raw(g, *ctx.args), None, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, device_mesh, mesh_dims):
        return all_reduce_raw(t, device_mesh, mesh_dims, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


SHARD_AXIS = "shard"


@dataclasses.dataclass(frozen=True)
class ShardMesh(MeshShape):
    """One EAGr shard per rank of a ``torch.distributed`` group: the 1-D
    mesh ``(SHARD_AXIS,)`` of ``world`` ranks, seen from rank ``rank``.

    ``device`` is where this rank's shard lives; ``comm`` where its
    collectives stage tensors (``device`` under ``nccl``, the CPU under
    ``gloo``), decided once from the group's backend."""

    group: object = None
    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    comm: torch.device = torch.device("cpu")
    backend: str = "gloo"

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        # collectives carry no bool: bools travel as uint8
        t = t.to(self.comm)
        return t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked in rank order, ``(world, *t.shape)``,
        on ``comm``."""
        import torch.distributed as dist

        x = self._staged(t)
        out = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(out, x, group=self.group)
        out = torch.stack(out)
        return out.to(torch.bool) if t.dtype == torch.bool else out

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, on ``t``'s device."""
        import torch.distributed as dist

        x = self._staged(t).clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x.to(device=t.device, dtype=t.dtype)

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order."""
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def barrier(self) -> None:
        """Wait until every rank got here (one all-reduce on ``comm``)."""
        self.all_reduce_sum(torch.zeros(1, device=self.comm))

    # ------------------------------------------- collectives with gradients
    def all_gather_tiled(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (rows, ...) concatenated in rank order, (world
        * rows, ...) on ``x``'s device. Its gradient in ``x`` is the sum
        over the ranks of the rows of their cotangents that came from this
        rank."""
        return _GatherTiled.apply(x, self)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, on every rank. Its gradient is
        the cotangent as it is: the output is replicated, so every rank
        holds all of its cotangent."""
        return _Psum.apply(x, self)

    def replicate(self, tree):
        """``tree`` (a dict of tensors, nested) as it is, with gradients
        summed over the ranks: a replicated input of an SPMD function."""
        return tree_unflatten(tree, _Replicate.apply(self,
                                                     *tree_leaves(tree)))

    def _rows_gathered(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        xs = x.detach().to(self.comm).contiguous()
        out = torch.empty((self.world * xs.shape[0],) + tuple(xs.shape[1:]),
                          dtype=xs.dtype, device=self.comm)
        dist.all_gather(list(out.chunk(self.world)), xs, group=self.group)
        return out.to(x.device)

    def _rows_summed(self, g: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``g`` (world * rows, ...) summed over the
        ranks: one all-to-all, then the ranks' blocks added in rank
        order."""
        import torch.distributed as dist

        gs = g.detach().to(self.comm).contiguous()
        got = torch.empty_like(gs)
        dist.all_to_all_single(got, gs, group=self.group)
        got = got.to(g.device)
        return _sum_in_order(list(got.chunk(self.world)), g.dtype)

    def _sum_ranks(self, ts: list) -> list:
        """Each tensor of ``ts`` summed over the ranks in rank order: one
        all-gather per dtype of the tensors flattened together."""
        import torch.distributed as dist

        out = list(ts)
        by_dtype: dict = {}
        for i, t in enumerate(ts):
            by_dtype.setdefault(t.dtype, []).append(i)
        for dt, idx in by_dtype.items():
            flat = torch.cat([ts[i].detach().reshape(-1) for i in idx])
            x = flat.to(self.comm)
            parts = [torch.empty_like(x) for _ in range(self.world)]
            dist.all_gather(parts, x, group=self.group)
            total = _sum_in_order([p.to(flat.device) for p in parts], dt)
            for i, piece in zip(idx, total.split(
                    [ts[i].numel() for i in idx])):
                out[i] = piece.view_as(ts[i])
        return out


def _sum_in_order(parts: list, dtype: torch.dtype) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` in that order; floating types below
    fp32 added in fp32 and rounded once."""
    wide = torch.float32 if dtype in (torch.bfloat16, torch.float16) \
        else dtype
    acc = parts[0].to(wide, copy=True)
    for p in parts[1:]:
        acc += p.to(wide)
    return acc.to(dtype)


class _GatherTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh._rows_gathered(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._rows_summed(g), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh._sum_ranks([x])[0]

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *leaves):
        ctx.mesh = mesh
        return tuple(x.view_as(x) for x in leaves)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.mesh._sum_ranks(list(grads)))


def make_shard_mesh(n_shards: int, *, device=None,
                    group=None) -> ShardMesh | None:
    """The shard mesh of ``n_shards`` ranks, or None.

    The JAX package's rule: without an initialised ``torch.distributed``
    group, or with fewer ranks than shards, there is no mesh and the
    stacked engine runs every shard on one card. A group of exactly
    ``n_shards`` ranks holds one shard per rank; a larger group raises.
    Rank r runs on ``cuda:{r % torch.cuda.device_count()}`` unless
    ``device`` names another."""
    import torch.distributed as dist

    from repro_torch.device import resolve_device

    if not (dist.is_available() and dist.is_initialized()):
        return None
    world = dist.get_world_size(group)
    if world < n_shards:
        return None
    if world > n_shards:
        raise ValueError(f"a group of {world} ranks holds one shard per rank: "
                         f"it cannot run {n_shards} shards")
    rank = dist.get_rank(group)
    if device is None:
        resolve_device(None)   # raises without a card
        device = f"cuda:{rank % torch.cuda.device_count()}"
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    backend = str(dist.get_backend(group))
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"an nccl group needs CUDA devices, got {device}")
        torch.cuda.set_device(device)
        comm = device
    else:
        comm = torch.device("cpu")
    return ShardMesh((SHARD_AXIS,), (n_shards,), group=group, rank=rank,
                     world=world, device=device, comm=comm, backend=backend)


def init_group(rank: int, world: int, store: str, *, backend: str = "gloo",
               timeout_s: float = 120.0, device=None) -> None:
    """Join a ``world``-rank group over the ``file://`` store at ``store``
    (a path no earlier group used). Every collective of the group fails
    after ``timeout_s`` seconds instead of hanging. An ``nccl`` rank first
    makes ``device`` its current CUDA device (a ``gloo`` rank too, for the
    device meshes it builds)."""
    import torch.distributed as dist

    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def spawn_group(fn, world: int, args: tuple = (), *,
                join_timeout_s: float = 300.0) -> None:
    """Run ``fn(rank, *args)`` in ``world`` processes started by
    ``torch.multiprocessing`` (``spawn``). Raises the first rank's error, or
    ``TimeoutError`` (after terminating every rank) when the ranks have not
    all ended within ``join_timeout_s`` seconds."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + join_timeout_s
    try:
        while not ctx.join(timeout=max(0.0, min(
                1.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{join_timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(5.0)
            if p.is_alive():
                p.kill()
