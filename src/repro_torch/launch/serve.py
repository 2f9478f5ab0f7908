"""Serving launcher: batched LM decode or DIEN CTR scoring (reduced configs),
exercising the real serve step functions on the card unless ``--device``
names another.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b --requests 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch dien --requests 4096
  PYTHONPATH=src python -m repro_torch.launch.serve --arch dien --device cpu

It runs the JAX package's ``repro.launch.serve`` cells: the LM branch decodes
``--decode-steps`` tokens greedily per batch of the reduced ``decode_32k``
cell (attention through the flash-decode kernel); the DIEN branch scores
batches of the reduced ``serve_p99`` cell (profile lookup through the
embedding-bag kernel).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _serve_lm(args, arch, dev) -> int:
    from repro_torch.models.transformer import decode_step

    cell = arch.build_smoke("decode_32k", device=dev)
    cfg, params = cell["cfg"], cell["params"]
    cache, tokens, lengths = cell["cache"], cell["tokens"], cell["lengths"]
    B = tokens.shape[0]
    n_batches = max(1, args.requests // B)
    # first call loads the kernels. Every batch restarts from the same
    # lengths: decode writes the cache at position lengths[b] before it
    # attends to it, so a row past the live prefix is never read stale
    decode_step(params, cache, tokens, lengths, cfg)
    _sync(dev)
    t0 = time.perf_counter()
    done = 0
    for _ in range(n_batches):
        c, t, l = cache, tokens, lengths
        for _ in range(args.decode_steps):
            logits, c, l = decode_step(params, c, t, l, cfg)
            t = torch.argmax(logits, -1).to(torch.int32)
            done += B
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"{args.arch}: {done} tokens in {dt:.2f}s "
          f"({done / dt:.0f} tok/s on {dev}, reduced config)")
    return 0


def _serve_dien(args, arch, dev) -> int:
    from repro_torch.models.recsys.dien import serve

    cell = arch.build_smoke("serve_p99", device=dev)
    cfg, params, batch = cell["cfg"], cell["params"], cell["batch"]
    serve(params, batch, cfg)  # first call loads the kernel
    _sync(dev)
    B = batch["item_ids"].shape[0]
    n = max(1, args.requests // B)
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        serve(params, batch, cfg)
        _sync(dev)
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = np.array(lat)
    print(f"dien: {n * B} requests, p50={np.percentile(lat, 50):.2f}ms "
          f"p99={np.percentile(lat, 99):.2f}ms per batch of {B} on {dev}")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--decode-steps", type=int, default=16)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    from repro_torch.configs import get_arch
    arch = get_arch(args.arch)
    dev = resolve_device(args.device)
    if arch.FAMILY == "lm":
        return _serve_lm(args, arch, dev)
    return _serve_dien(args, arch, dev)


if __name__ == "__main__":
    raise SystemExit(main())
