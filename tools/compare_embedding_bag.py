#!/usr/bin/env python3
"""Time versions of the embedding-bag kernel side by side on one card.

    python3 tools/compare_embedding_bag.py NAME=A.cu NAME=B.cu [...]

Each ``A.cu`` is a version of
``src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu`` (for
example the parent commit's, unpacked with ``git archive`` into a
gitignored directory, and the working tree's). All are compiled with the
package's ``nvcc`` flags (every ``nvcc`` started together) into
``build/compare/``, and each library's ``embedding_bag_f32`` entry point is
called directly. At DIEN's profile lookup (512 bags of 16 ids, D 18, the
100,000-row profile table, unit weights) every output is held against the
plain version on CPU copies of the same inputs (bit-equal), then each raw
launch is timed in the order given and then in reverse (A, B, B, A), two
ways: device time (``torch.profiler``, the kernels alone) and back-to-back
CUDA-event time (host dispatch included). The port's wrapper
(``ops.embedding_bag``, which runs the package's own source) and
``F.embedding_bag`` are timed the same two ways. Prints the card line and one JSON object, and writes it to
``chiprun_out/compare_embedding_bag.json``. Needs one CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)


def build(sources: dict) -> dict:
    """Compile each named .cu with the package's flags, all at once; returns
    the loaded entry points by name."""
    from repro_torch.kernels import _build

    out_dir = os.path.join(ROOT, "build", "compare")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        so = os.path.join(out_dir, f"embedding_bag_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
             "-o", so, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {sources[name]}:\n{log}")
        fn = ctypes.CDLL(so).embedding_bag_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    sources = dict(a.split("=", 1) for a in argv if "=" in a)
    if len(sources) < 2 or len(sources) != len(argv):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("compare_embedding_bag: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import dien
    from repro_torch.kernels.embedding_bag import ops

    card = cs.card_line()
    fns = build(sources)

    cfg = dien.CFG
    B, nb, D, V = 512, cfg.profile_bag_size, cfg.embed_dim, \
        cfg.n_profile_feats
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    table = torch.randn((V, D), generator=gen, device="cuda")
    ids = torch.randint(0, V, (B * nb,), generator=gen, device="cuda",
                        dtype=torch.int32)
    offs = torch.arange(B, dtype=torch.int32, device="cuda") * nb
    w = torch.ones((B * nb,), device="cuda")
    want = ops.embedding_bag(table.cpu(), ids.cpu(), offs.cpu(), n_bags=B,
                             weights=w.cpu())
    stream = torch.cuda.current_stream().cuda_stream
    outs = {n: torch.empty((B, D), device="cuda") for n in fns}

    def raw(name):
        fn, out = fns[name], outs[name]
        args = (table.data_ptr(), ids.data_ptr(), offs.data_ptr(),
                w.data_ptr(), out.data_ptr(), V, D, B * nb, B, stream)
        return lambda: fn(*args)

    for name in fns:
        if raw(name)() != 0:
            raise RuntimeError(f"the {name} kernel did not launch")
    torch.cuda.synchronize()
    for name, out in outs.items():
        if not torch.equal(out.cpu(), want):
            raise AssertionError(f"the {name} kernel != the plain version")

    ids64, offs64 = ids.long(), offs.long()
    calls = dict(
        wrapper=lambda: ops.embedding_bag(table, ids, offs, n_bags=B,
                                          weights=w),
        library=lambda: torch.nn.functional.embedding_bag(
            ids64, table, offs64, mode="sum", per_sample_weights=w))
    order = list(fns) + list(fns)[::-1]
    res = {"card": card, "shape": dict(B=B, bag=nb, D=D, V=V),
           "order": order, "device_ms": {}, "event_ms": {}}
    for how, timer in (("device_ms", cs.device_ms), ("event_ms", cs.cuda_ms)):
        runs = {n: [] for n in fns}
        for name in order:
            runs[name].append(timer(torch, raw(name)))
        for name, fn in calls.items():
            runs[name] = [timer(torch, fn)]
        res[how] = runs
    res["bound_ms"], res["bound_by"] = cs.bag_bound_ms(B * nb, B * nb, B, D,
                                                       True)
    print(card)
    print(json.dumps(res))
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "compare_embedding_bag.json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
