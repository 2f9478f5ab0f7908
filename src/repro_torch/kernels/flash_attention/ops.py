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
path went through the kernels.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.flash_attention.ref import attention_ref, decode_ref

HEAD_DIMS = (16, 32, 48, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
# head dims of the tensor-core prefill kernel (bf16 only): 128-byte rows of
# 64 bf16, one or two per swizzled shared-memory row
WGMMA_HEAD_DIMS = (64, 128)

# kernel launches per entry point since the last reset (the CPU path never
# counts)
LAUNCHES = {"prefill": 0, "prefill_wgmma": 0, "decode": 0}


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
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_ENTRIES: dict = {}
_ARGTYPES = {
    "flash_attention_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_void_p],
    "flash_attention_wgmma_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p],
    "flash_decode_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p],
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


def _check(q, k, v, lengths, *, q_ndim: int) -> None:
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
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu tensors, got "
                         f"{q.device}")
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
    returns (B, Hq, Sq, d) in q's dtype, 0 on rows with no live key."""
    _check(q, k, v, lengths, q_ndim=4)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, lengths=lengths)
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
    ``lengths[b] == 0``."""
    if lengths is None:
        raise TypeError("flash_decode needs lengths")
    _check(q, k_cache, v_cache, lengths, q_ndim=3)
    if q.device.type == "cpu":
        return decode_ref(q, k_cache, v_cache, lengths)
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
