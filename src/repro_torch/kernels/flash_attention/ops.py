"""The checked wrappers of the flash-attention CUDA kernels.

``flash_attention`` (prefill) and ``flash_decode`` (one query row per batch
row and head) take the JAX package's layout: q ``(B, Hq, S, d)`` (decode:
``(B, Hq, d)``), k/v ``(B, Hkv, S, d)``, kv head of query head ``h`` =
``h // (Hq // Hkv)``. CUDA tensors launch the hand-written kernels in
``csrc/flash_attention.cu`` (or raise), CPU tensors run the plain versions in
``ref.py``; any other device raises. Prefill has two kernels, picked by
``prefill_variant`` from the dtype and head dim alone: the tensor-core
(``wgmma``) kernel for bf16 at head dims 64 and 128, the CUDA-core (``simt``)
kernel for every other case (fp32 keeps full fp32 products). ``LAUNCHES``
counts kernel launches per entry point (``prefill`` counts both prefill
kernels, ``prefill_wgmma`` the tensor-core one), so a run can show that its
path went through the kernels; ``WORK`` counts each call's operations and
bytes (``prefill_cost``, ``decode_cost``) on either path while
``cost.counting()`` is on. The kernels have no backward: a call with grad
mode on and an input that requires grad raises rather than cut the
autograd graph (training attends through ``common.blocked_attention``).

Two more entries serve a decode over a cache whose rows are spread over
ranks: ``flash_decode_partial`` (the decode kernel leaving a row's partial
softmax state ``(acc, m, l)`` instead of its output, for the rank's own
rows) and ``flash_decode_merge`` (the decode kernel's chunk merge, with
ranks for chunks, over the all-gathered partials). Meta tensors take a
meta path (an output of the right shape, the work counted): the dry run
runs placed steps on them.

Placed tensors (DTensors, ``distributed.sharding``): ``flash_attention``
and ``flash_decode`` run the same kernels on each rank's local tensors
through ``local_map``. The query heads may be sharded where the kv heads
are replicated (fewer kv heads than the mesh axis): each rank then slices
the kv heads its local query heads read. A cache sharded along its rows
makes the decode gather the query heads over those mesh dims, take each
rank's partial over its rows (local lengths ``clamp(len - offset, 0,
S_local)``: a rank past the live rows contributes the empty partial),
all-gather the partials in rank order and merge them.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.distributed.sharding import dim_shard, is_placed, mesh_dims
from repro_torch.kernels.cost import Work, WorkCounter, counted
from repro_torch.kernels.flash_attention.ref import (
    attention_ref,
    decode_merge_ref,
    decode_partial_ref,
    decode_ref,
)

HEAD_DIMS = (16, 32, 48, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
# head dims of the tensor-core prefill kernel (bf16 only): 128-byte rows of
# 64 bf16, one or two per swizzled shared-memory row
WGMMA_HEAD_DIMS = (64, 128)

# kernel launches per entry point since the last reset (the CPU path never
# counts)
LAUNCHES = {"prefill": 0, "prefill_wgmma": 0, "decode": 0,
            "decode_partial": 0, "decode_merge": 0}
# each call's work, on either path (cost.py)
WORK = WorkCounter(("prefill", "decode", "decode_partial", "decode_merge"))


def _esize_rate(esize: int) -> str:
    """bf16 inputs at the tensor cores' rate, fp32 at the CUDA cores'."""
    return "bf16" if esize == 2 else "fp32"


def causal_pairs(Sq: int, Skv: int, causal: bool = True) -> int:
    """The live (query, key) pairs of one head: query i sees keys up to
    ``i + Skv - Sq`` when causal."""
    if not causal:
        return Sq * Skv
    off = Skv - Sq
    lo = max(0, -off)            # the first query that sees a key
    n = Sq - lo
    return 0 if n <= 0 else (lo + off + 1 + Skv) * n // 2


def prefill_cost(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, d: int,
                 causal: bool, esize: int) -> Work:
    """One prefill call: q, k, v read once and out written once; 4 d
    operations (q.k and p.v, a multiply and an add each) per live
    query-key pair and query head."""
    nbytes = (2 * B * Hq * Sq * d + 2 * B * Hkv * Skv * d) * esize
    ops = 4 * d * B * Hq * causal_pairs(Sq, Skv, causal)
    return Work(ops, nbytes, _esize_rate(esize))


def decode_cost(B: int, Hq: int, Hkv: int, d: int, live: int,
                esize: int) -> Work:
    """One decode call over ``live`` cache rows in all (the batch rows'
    live lengths summed): each live row of k and v read once, q read and
    out written once; 4 d operations per query head and live key."""
    nbytes = (2 * Hkv * d * live + 2 * B * Hq * d) * esize
    return Work(4 * d * Hq * live, nbytes, _esize_rate(esize))


def decode_partial_cost(B: int, Hq: int, Hkv: int, d: int, live: int,
                        esize: int) -> Work:
    """One partial decode call over ``live`` cache rows in all: the rows
    of k and v and q read once, the fp32 partial (d + 2 values a query
    row) written once; 4 d operations per query head and live key."""
    nbytes = (2 * Hkv * d * live + B * Hq * d) * esize + B * Hq * (d + 2) * 4
    return Work(4 * d * Hq * live, nbytes, _esize_rate(esize))


def decode_merge_cost(R: int, B: int, Hq: int, d: int, esize: int) -> Work:
    """One merge of R partials: each read once, the output written once;
    a multiply and an add per value of each partial (fp32)."""
    nbytes = R * B * Hq * (d + 2) * 4 + B * Hq * d * esize
    return Work(2 * R * B * Hq * (d + 2), nbytes, "fp32")


def prefill_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The prefill kernel a CUDA call with this dtype and head dim launches:
    ``"wgmma"`` (tensor cores, bf16 at head dims 64 and 128) or ``"simt"``
    (CUDA cores, fp32 products)."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


# the decode kernel's key chunks: 256 keys and up, doubled while a cache row
# would need more than DECODE_MAX_CHUNKS of them, at most 1,024 (a multiple
# of the kernel's 16-key sub-tile)
DECODE_CHUNK_MIN, DECODE_CHUNK_MAX, DECODE_MAX_CHUNKS = 256, 1024, 64


def decode_split(S: int) -> tuple[int, int]:
    """``(chunk, n_chunks)`` of the decode kernel's split of a cache of ``S``
    rows: one work item per (chunk, kv head, batch row), chunk ``c`` holding
    keys ``[c * chunk, (c + 1) * chunk)``. A function of the cache's shape
    alone, so a decode step never reads ``lengths`` back to the host."""
    chunk = DECODE_CHUNK_MIN
    while chunk < DECODE_CHUNK_MAX and -(-S // chunk) > DECODE_MAX_CHUNKS:
        chunk *= 2
    return chunk, max(1, -(-S // chunk))


def reset_launches() -> None:
    """Zero ``LAUNCHES`` and ``WORK``."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    WORK.reset()


_ENTRIES: dict = {}
_ARGTYPES = {
    "flash_attention_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_void_p],
    "flash_attention_wgmma_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p],
    "flash_decode_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p],
    "flash_decode_partial_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p],
    "flash_decode_merge_fwd": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
}


def _entry(name: str):
    fn = _ENTRIES.get(name)
    if fn is None:
        from repro_torch.kernels import _build

        fn = getattr(_build.library("flash_attention"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn


def _no_graph_cut(q, k, v) -> None:
    """The kernels are bound through ctypes and have no backward: a call
    that autograd would record raises instead of returning an output with
    no gradient, on every device alike."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the flash-attention kernels have no backward, so this call "
            "would cut the autograd graph: train through "
            "repro_torch.models.common.blocked_attention (as the JAX package "
            "does), or call under torch.no_grad(); a hand-written attention "
            "kernel with a backward is ROADMAP.md's follow-up under section "
            "2")


def _check(q, k, v, lengths, *, q_ndim: int) -> None:
    _no_graph_cut(q, k, v)
    if q.ndim != q_ndim or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)} (want {q_ndim}-D), k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, Hq, d = q.shape[0], q.shape[1], q.shape[-1]
    Bk, Hkv, _, dk = k.shape
    if Bk != B or dk != d or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"agree (batch, head dim, Hq % Hkv == 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of {DTYPES}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if lengths is not None:
        if lengths.shape != (B,) or lengths.dtype not in (torch.int32,
                                                          torch.int64):
            raise TypeError(f"lengths must be ({B},) int32 or int64, got "
                            f"{lengths.dtype} {tuple(lengths.shape)}")
        if lengths.device != q.device:
            raise ValueError(f"lengths is on {lengths.device}, q on "
                             f"{q.device}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash attention runs on cuda or cpu tensors (meta "
                         f"for the dry run), got {q.device}")
    if q.device.type == "cuda":
        for name, t in (("q", q), ("k", k), ("v", v)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary")
        if B > 65535 or Hq > 65535:
            raise ValueError(f"B={B}, Hq={Hq}: the kernel's grid takes at "
                             f"most 65535 of each")


def _lengths_i32(lengths):
    return None if lengths is None else lengths.to(torch.int32).contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Prefill attention. q (B, Hq, Sq, d); k, v (B, Hkv, Skv, d); causal
    rows see keys up to their position plus ``Skv - Sq``; ``lengths`` (B,)
    masks keys at or past ``lengths[b]``. fp32 softmax and accumulation;
    returns (B, Hq, Sq, d) in q's dtype, 0 on rows with no live key.
    Placed (DTensor) inputs run it on each rank's local heads."""
    if is_placed(q):
        return _placed_prefill(q, k, v, causal, lengths)
    _check(q, k, v, lengths, q_ndim=4)
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    return counted(WORK, lambda: ("prefill", prefill_cost(
        B, Hq, Hkv, Sq, Skv, d, causal, q.element_size())),
        _prefill, q, k, v, causal, lengths)


def _prefill(q, k, v, causal, lengths):
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, lengths=lengths)
    if q.device.type == "meta":
        return torch.empty_like(q)
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    lens = _lengths_i32(lengths)
    variant = prefill_variant(q.dtype, d)
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if lens is None else lens.data_ptr(), out.data_ptr())
        if variant == "wgmma":
            rc = _entry("flash_attention_wgmma_fwd")(
                *ptrs, B, Hq, Hkv, Sq, Skv, d, int(causal),
                1.0 / math.sqrt(d), stream)
        else:
            rc = _entry("flash_attention_fwd")(
                *ptrs, B, Hq, Hkv, Sq, Skv, d, int(causal),
                int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(d), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention ({variant}) kernel launch "
                           f"failed: error {rc} (negative: a CUresult of "
                           f"the tensor-map encoding)")
    LAUNCHES["prefill"] += 1
    if variant == "wgmma":
        LAUNCHES["prefill_wgmma"] += 1
    return out


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """One-token decode. q (B, Hq, d); caches (B, Hkv, S, d); keys at or past
    ``lengths[b]`` are masked. Returns (B, Hq, d) in q's dtype, 0 where
    ``lengths[b] == 0``. Placed (DTensor) inputs run it on each rank's
    local heads and, on a cache sharded along its rows, merge the ranks'
    partials."""
    if lengths is None:
        raise TypeError("flash_decode needs lengths")
    if is_placed(q):
        return _placed_decode(q, k_cache, v_cache, lengths)
    _check(q, k_cache, v_cache, lengths, q_ndim=3)
    B, Hq, d = q.shape
    # the wrapper reads no length back to the host: it counts every row of
    # the cache as live
    return counted(WORK, lambda: ("decode", decode_cost(
        B, Hq, k_cache.shape[1], d, B * k_cache.shape[2], q.element_size())),
        _decode, q, k_cache, v_cache, lengths)


def _decode(q, k_cache, v_cache, lengths):
    if q.device.type == "cpu":
        return decode_ref(q, k_cache, v_cache, lengths)
    if q.device.type == "meta":
        return torch.empty_like(q)
    B, Hq, d = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    lens = _lengths_i32(lengths)
    chunk, n_chunks = decode_split(S)
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        # the chunks' partial (m, l) and acc, merged by a second kernel
        part = torch.empty((B * Hq * n_chunks * (d + 2),),
                           dtype=torch.float32, device=q.device) \
            if n_chunks > 1 else None
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _entry("flash_decode_fwd")(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lens.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), B, Hq, Hkv, S, d,
            int(q.dtype == torch.bfloat16), chunk, 1.0 / math.sqrt(d),
            stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["decode"] += 1
    return out


def flash_decode_partial(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """The decode kernel's partial state over this cache's rows below
    ``lengths[b]``: (B, Hq, d + 2) fp32 per query row, ``acc`` (d values,
    not normalised), ``m`` (the largest score in log2 units, q.k / sqrt(d)
    * log2 e) and ``l``; a row with no live key gives the empty partial
    (0, -3e38, 0). ``ref.decode_partial_ref`` is its plain version."""
    if lengths is None:
        raise TypeError("flash_decode_partial needs lengths")
    _check(q, k_cache, v_cache, lengths, q_ndim=3)
    B, Hq, d = q.shape
    return counted(WORK, lambda: ("decode_partial", decode_partial_cost(
        B, Hq, k_cache.shape[1], d, B * k_cache.shape[2],
        q.element_size())), _decode_partial, q, k_cache, v_cache, lengths)


def _decode_partial(q, k_cache, v_cache, lengths):
    B, Hq, d = q.shape
    if q.device.type == "cpu":
        return decode_partial_ref(q, k_cache, v_cache, lengths)
    if q.device.type == "meta":
        return q.new_empty((B, Hq, d + 2), dtype=torch.float32)
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    lens = _lengths_i32(lengths)
    chunk, n_chunks = decode_split(S)
    with torch.cuda.device(q.device):
        out = torch.empty((B, Hq, d + 2), dtype=torch.float32,
                          device=q.device)
        # every chunk's partial, merged into out by the second kernel
        part = torch.empty((B * Hq * n_chunks * (d + 2),),
                           dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _entry("flash_decode_partial_fwd")(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lens.data_ptr(), out.data_ptr(), part.data_ptr(), B, Hq, Hkv, S,
            d, int(q.dtype == torch.bfloat16), chunk, 1.0 / math.sqrt(d),
            stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode_partial kernel launch failed: "
                           f"CUDA error {rc}")
    LAUNCHES["decode_partial"] += 1
    return out


def flash_decode_merge(parts: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """The decode output of R partials (R, B, Hq, d + 2) of
    :func:`flash_decode_partial` over disjoint cache rows, merged in order
    0..R-1 by the decode kernel's chunk merge: empty partials are skipped,
    a row with none live is 0. Returns (B, Hq, d) in ``dtype``.
    ``ref.decode_merge_ref`` is its plain version."""
    if parts.ndim != 4 or parts.dtype != torch.float32 \
            or parts.shape[-1] - 2 not in HEAD_DIMS or dtype not in DTYPES:
        raise ValueError(f"parts must be (R, B, Hq, d + 2) fp32 with d in "
                         f"{HEAD_DIMS} and dtype one of {DTYPES}, got "
                         f"{parts.dtype} {tuple(parts.shape)} -> {dtype}")
    if parts.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"parts on {parts.device}")
    R, B, Hq, d2 = parts.shape
    esize = torch.empty((), dtype=dtype).element_size()
    return counted(WORK, lambda: ("decode_merge", decode_merge_cost(
        R, B, Hq, d2 - 2, esize)), _decode_merge, parts, dtype)


def _decode_merge(parts, dtype):
    R, B, Hq, d2 = parts.shape
    if parts.device.type == "cpu":
        return decode_merge_ref(parts, dtype)
    if parts.device.type == "meta":
        return parts.new_empty((B, Hq, d2 - 2), dtype=dtype)
    if B > 65535 or Hq > 65535:
        raise ValueError(f"B={B}, Hq={Hq}: the merge's grid takes at most "
                         f"65535 of each")
    parts = parts.contiguous()
    with torch.cuda.device(parts.device):
        out = torch.empty((B, Hq, d2 - 2), dtype=dtype, device=parts.device)
        stream = torch.cuda.current_stream(parts.device).cuda_stream
        rc = _entry("flash_decode_merge_fwd")(
            parts.data_ptr(), out.data_ptr(), R, B, Hq, d2 - 2,
            int(dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode_merge kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES["decode_merge"] += 1
    return out


# ------------------------------------------------------ placed (DTensor)
def _local_kv_heads(q, k) -> slice:
    """The local kv heads (a slice of ``k``'s local heads) that the local
    query heads of ``q`` read, the kv head of global query head h being
    h // (Hq // Hkv)."""
    Hq, Hkv = q.shape[1], k.shape[1]
    G = Hq // Hkv
    (qi, qn), (ki, kn) = dim_shard(q, 1), dim_shard(k, 1)
    nq, nk = Hq // qn, Hkv // kn
    h0, k0 = qi * nq, ki * nk
    lo, hi = h0 // G, (h0 + nq - 1) // G + 1
    g = nq // (hi - lo)
    if lo < k0 or hi > k0 + nk or nq % (hi - lo) or any(
            (h0 + j) // G - lo != j // g for j in range(nq)):
        raise ValueError(f"query heads {h0}..{h0 + nq - 1} of {Hq} and kv "
                         f"heads {k0}..{k0 + nk - 1} of {Hkv} on this rank do "
                         f"not pair")
    return slice(lo - k0, hi - k0)


def _check_placed(q, k, v, lengths, seq_ok: bool) -> None:
    if not all(is_placed(t) for t in (k, v)) or (
            lengths is not None and not is_placed(lengths)):
        raise TypeError("placed attention needs every input placed")
    if not (q.device_mesh == k.device_mesh == v.device_mesh):
        raise ValueError("q, k and v lie on different meshes")
    if tuple(k.placements) != tuple(v.placements):
        raise ValueError(f"k {k.placements} and v {v.placements} differ")
    if mesh_dims(q, 0) != mesh_dims(k, 0) or (
            lengths is not None and mesh_dims(lengths, 0)
            != mesh_dims(q, 0)):
        raise ValueError(f"the batch is placed differently: q {q.placements}"
                         f", k {k.placements}")
    if (q.ndim == 4 and mesh_dims(q, 2)) or (not seq_ok
                                               and mesh_dims(k, 2)):
        raise NotImplementedError(
            f"attention over a sequence sharded on the mesh (q "
            f"{q.placements}, k {k.placements}): sequence parallelism is not "
            f"ported")


def _placed_prefill(q, k, v, causal, lengths):
    from torch.distributed.tensor.experimental import local_map

    _check_placed(q, k, v, lengths, seq_ok=False)
    heads = _local_kv_heads(q, k)

    def local(ql, kl, vl, ll):
        if kl.shape[1] != heads.stop - heads.start:
            kl, vl = kl[:, heads].contiguous(), vl[:, heads].contiguous()
        return flash_attention(ql, kl, vl, causal=causal, lengths=ll)

    return local_map(
        local, out_placements=(q.placements,),
        in_placements=(q.placements, k.placements, v.placements,
                       None if lengths is None else lengths.placements),
        device_mesh=q.device_mesh)(q, k, v, lengths)


def _placed_decode(q, k_cache, v_cache, lengths):
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import redistribute
    from repro_torch.launch.mesh import all_gather

    mesh = q.device_mesh
    seq = mesh_dims(k_cache, 2)
    # a rank's partial covers every query head: gather the heads the cache
    # rows' mesh dims shard
    q = redistribute(q, [Replicate() if i in seq and p == Shard(1) else p
                         for i, p in enumerate(q.placements)])
    _check_placed(q, k_cache, v_cache, lengths, seq_ok=True)
    heads = _local_kv_heads(q, k_cache)
    row0, n_seq = dim_shard(k_cache, 2)
    S_local = k_cache.shape[2] // n_seq

    def local(ql, kl, vl, ll):
        if kl.shape[1] != heads.stop - heads.start:
            kl, vl = kl[:, heads].contiguous(), vl[:, heads].contiguous()
        if not seq:
            return flash_decode(ql, kl, vl, ll)
        part = flash_decode_partial(
            ql, kl, vl, (ll - row0 * S_local).clamp(0, S_local))[None]
        for i in reversed(seq):        # rank order: the outer mesh dim major
            part = all_gather(part, mesh, i, 0)
        return flash_decode_merge(part, ql.dtype)

    return local_map(
        local, out_placements=(q.placements,),
        in_placements=(q.placements, k_cache.placements, v_cache.placements,
                       lengths.placements),
        device_mesh=mesh)(q, k_cache, v_cache, lengths)
