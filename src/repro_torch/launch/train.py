"""End-to-end training launcher, on the card unless ``--device`` names
another.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --steps 300 --smoke
  PYTHONPATH=src python -m repro_torch.launch.train --arch dien --steps 50 \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch dbrx-132b \\
      --steps 12 --smoke --ckpt-every 4 --fail-at 7 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch gatedgcn \\
      --steps 8 --smoke --ckpt-every 2 --fail-at 3 --device cpu

The JAX package's ``repro.launch.train``: it drives the fault-tolerant
runner (checkpoint/restart and straggler detection) around the arch's
reduced train cell (``build_smoke`` of ``train_4k`` for an LM arch,
``train_batch`` for DIEN, ``full_graph_sm`` for a GNN: gat-cora, gatedgcn,
graphcast, nequip); ``--fail-at N`` injects a node failure at step N
to exercise restore and deterministic replay end to end. Batch ``i`` is
drawn from a ``torch.Generator`` seeded by ``i`` (every leaf of the cell's
batch redrawn: integers in [0, max + 1), at least [0, 2); masks all set;
floats normal), so the replay after a restore is exact. Like the JAX
package's launcher it runs ``--smoke`` only; the full-width cells run in
``chip_smoke.py``. Checkpoints go to ``--ckpt-dir``, or to a temporary
directory removed at exit.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time

import numpy as np
import torch

from repro_torch.device import resolve_device


def batch_maker(batch0):
    """``make_batch(i)``: a batch shaped as ``batch0``, drawn from a
    generator seeded by ``i`` on ``batch0``'s device. ``batch0`` is a dict
    of tensors, or a dataclass of them (a GNN's ``GraphBatch`` or
    ``GraphCastBatch``), whose tensor fields are redrawn and whose other
    fields (counts, absent fields) are kept. A GNN batch's edges are
    redrawn with it, so its segment plans are built at its first use."""
    if dataclasses.is_dataclass(batch0):
        tensors = {f.name: getattr(batch0, f.name)
                   for f in dataclasses.fields(batch0)
                   if torch.is_tensor(getattr(batch0, f.name))}
        make = batch_maker(tensors)
        return lambda i: dataclasses.replace(batch0, **make(i))
    hi = {k: max(2, int(v.max()) + 1) for k, v in batch0.items()
          if not v.is_floating_point() and v.dtype != torch.bool}

    def make_batch(i: int) -> dict:
        out = {}
        for k in sorted(batch0):
            x = batch0[k]
            gen = torch.Generator(device=x.device)
            gen.manual_seed(i * 1_000_003 + len(out))
            if x.dtype == torch.bool:
                out[k] = torch.ones_like(x)
            elif x.is_floating_point():
                out[k] = torch.randn(x.shape, generator=gen, device=x.device,
                                     dtype=x.dtype)
            else:
                out[k] = torch.randint(0, hi[k], x.shape, generator=gen,
                                       device=x.device, dtype=x.dtype)
        return out

    return make_batch


def train(arch_id: str, *, steps: int, lr: float, shape: str | None = None,
          ckpt_dir: str, ckpt_every: int = 50, fail_at: int | None = None,
          device=None):
    """Run ``steps`` steps of ``arch_id``'s reduced train cell under the
    fault-tolerant runner. Returns ``((params, opt_state), report,
    shape)``."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.distributed.fault import FaultTolerantRunner

    arch = get_arch(arch_id)
    shape = shape or next(s for s, d in arch.SHAPE_DEFS.items()
                          if d["kind"] == "train")
    if arch.SHAPE_DEFS[shape]["kind"] != "train":
        raise ValueError(f"{shape} is not a train shape")
    cell = arch.build_smoke(shape, device=resolve_device(device))
    step = cell["step"]

    def step_fn(state, batch):
        params, opt_state = state
        params, opt_state, metrics = step(params, opt_state, batch, lr)
        return (params, opt_state), metrics

    runner = FaultTolerantRunner(step_fn, batch_maker(cell["batch"]),
                                 CheckpointManager(ckpt_dir),
                                 ckpt_every=ckpt_every)
    state, report = runner.run(
        (cell["params"], cell["opt_state"]), steps,
        fail_at={fail_at} if fail_at is not None else None)
    return state, report, shape


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--shape", default=None, help="defaults to the train shape")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--smoke", action="store_true",
                   help="reduced config (the only mode of this launcher)")
    p.add_argument("--ckpt-dir", default=None,
                   help="default: a temporary directory removed at exit")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--fail-at", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; the CPU only when "
                        "named)")
    args = p.parse_args(argv)
    if not args.smoke:
        raise SystemExit("the full-width train cells run in chip_smoke.py; "
                         "this launcher runs --smoke (reduced config) only")
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _, report, shape = train(
            args.arch, shape=args.shape, steps=args.steps, lr=args.lr,
            ckpt_dir=args.ckpt_dir or tmp, ckpt_every=args.ckpt_every,
            fail_at=args.fail_at, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
    print(f"arch={args.arch} shape={shape} steps={report.steps_run} "
          f"restarts={report.restarts} ckpts={report.checkpoints} "
          f"stragglers={len(report.stragglers)} {dt:.1f}s "
          f"({report.steps_run / dt:.2f} steps/s on {dev})")
    if report.losses:
        k = max(1, len(report.losses) // 10)
        print("loss curve:", [round(float(np.mean(report.losses[i:i + k])), 4)
                              for i in range(0, len(report.losses), k)])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
