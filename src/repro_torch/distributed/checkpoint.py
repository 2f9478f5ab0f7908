"""Checkpoints with atomic manifests, and the EAGr session codec, in the JAX
package's on-disk format.

The writer (:class:`CheckpointManager`):
  * a two-phase commit: array files land in ``step_NNN.tmp/``, the manifest
    (array names, shapes, dtypes, step, a JSON ``extra`` dict) is written
    last and the directory atomically renamed — a crash mid-write never
    corrupts the latest checkpoint;
  * async save: the caller takes the host snapshot synchronously and a
    background thread does only the file IO;
  * ``keep``: the newest ``keep`` committed steps survive, older ones are
    removed after each commit.

The session codec: :func:`snapshot_session` flattens a live
``EagrSession`` — per-group plans, window rings, PAOs, id maps, the master
``DynamicOverlay``'s structure and the event-stream sequence number — into
a named-array payload (every device tensor copied to pinned host memory
behind one event wait), and :func:`restore_session` rebuilds a session whose
reads equal the saved one's bit for bit without running construction,
min-cut or compilation. Restore may also *reshard*: the payload keeps the
master overlay and the global push/pull decisions, so an N-shard save
restacks into any M-shard (or single-engine) layout by base id — write
replication keeps a writer's window ring identical on every owning shard.

Array names, dtypes and shapes are the JAX package's (``repro.distributed.
checkpoint``), so a checkpoint either package writes restores in the other.
Tables only the port derives (routes, frontier indices, patch bookkeeping)
are rebuilt on restore and never written; the config's ``backend`` is
written as ``None`` (the JAX package's default) and ignored on read.

Crash injection for the fault tests: ``EAGR_CKPT_CRASH=arrays`` kills the
process (``os._exit``) after the array files are written but before the
manifest; ``EAGR_CKPT_CRASH=manifest`` kills it after the manifest lands in
the ``.tmp`` directory but before the atomic rename. Either way the latest
*committed* checkpoint stays restorable.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time

import numpy as np
import torch


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _flat_with_paths(tree, prefix: str = "") -> list:
    """(path, tensor-or-array) leaves of nested dicts, lists, tuples and
    NamedTuples, in the JAX package's order and key-path spelling
    (``jax.tree_util.keystr``): ``['a']`` for a dict key (keys sorted),
    ``[0]`` for a position, ``.mu`` for a NamedTuple field — a training
    state ``(params, AdamState(mu, nu, count))`` flattens to
    ``[0]['embed']``, ``[1].mu['layers']['wq']``, ``[1].count``."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flat_with_paths(tree[k], f"{prefix}[{k!r}]"))
        return out
    if _is_namedtuple(tree):
        return [x for f, v in zip(tree._fields, tree)
                for x in _flat_with_paths(v, f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flat_with_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _crash_point(stage: str) -> None:
    """Fault-injection seam: die *here* when EAGR_CKPT_CRASH names this
    write-path stage. ``os._exit`` (not an exception) — the recovery claim
    is about a process that vanished mid-write, not one that unwound."""
    if os.environ.get("EAGR_CKPT_CRASH") == stage:
        os._exit(17)


def _host_arrays(items: list) -> list:
    """``(key, value)`` pairs with every tensor value copied to a host numpy
    array: CUDA tensors through pinned buffers behind one event wait."""
    from repro_torch.core.engine import to_host

    out, cuda = [], []
    for k, v in items:
        if torch.is_tensor(v):
            if v.device.type == "cuda":
                cuda.append(len(out))
                out.append((k, v))
                continue
            v = v.detach().cpu().numpy().copy()
        out.append((k, np.asarray(v)))
    if cuda:
        for i, h in zip(cuda, to_host(*(out[i][1] for i in cuda))):
            out[i] = (out[i][0], h)
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, state, *, blocking: bool = True,
             extra: dict | None = None) -> None:
        """Snapshot a tree of tensors (nested dicts, lists, tuples and
        NamedTuples, such as a training state ``(params, opt_state)``)
        synchronously, write it (a)synchronously, commit atomically."""
        snapshot = _host_arrays(_flat_with_paths(state))
        self._launch(step, snapshot, extra or {}, blocking)

    def save_payload(self, step: int, arrays: dict, objs: dict | None = None,
                     *, blocking: bool = False) -> None:
        """Commit a named-array payload (``{key: numpy array}``) plus a
        JSON-safe object dict (the manifest's ``extra``) through the same
        two-phase writer. Arrays are host-side already, so the background
        thread only does file IO."""
        snapshot = [(k, np.asarray(v)) for k, v in arrays.items()]
        self._launch(step, snapshot, objs or {}, blocking)

    def _launch(self, step: int, snapshot: list, extra: dict,
                blocking: bool) -> None:
        self.wait()

        def write():
            tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
            final = os.path.join(self.dir, f"step_{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "time": time.time(),
                        "extra": extra, "arrays": {}}
            for i, (p, arr) in enumerate(snapshot):
                fname = f"arr_{i:05d}.npy"
                np.save(os.path.join(tmp, fname), arr)
                manifest["arrays"][p] = {
                    "file": fname, "shape": list(arr.shape),
                    "dtype": str(arr.dtype)}
            _crash_point("arrays")
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            _crash_point("manifest")
            if os.path.isdir(final):  # a re-save of the same step
                shutil.rmtree(final)
            os.replace(tmp, final)  # atomic commit
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _manifest(self, step: int | None) -> tuple[str, dict]:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            return d, json.load(f)

    def restore(self, state_like, step: int | None = None):
        """Restore into the structure of ``state_like`` (a tree of tensors
        as :meth:`save` takes it): each array lands on its template's
        device and dtype. Returns ``(state, manifest)``."""
        d, manifest = self._manifest(step)

        def load(tree, prefix=""):
            if isinstance(tree, dict):
                return {k: load(v, f"{prefix}[{k!r}]")
                        for k, v in tree.items()}
            if _is_namedtuple(tree):
                return type(tree)(*(load(v, f"{prefix}.{f}")
                                    for f, v in zip(tree._fields, tree)))
            if isinstance(tree, (list, tuple)):
                return type(tree)(load(v, f"{prefix}[{i}]")
                                  for i, v in enumerate(tree))
            meta = manifest["arrays"].get(prefix)
            if meta is None:
                raise KeyError(f"checkpoint {manifest['step']} missing "
                               f"array {prefix}")
            arr = np.load(os.path.join(d, meta["file"]))
            if tuple(arr.shape) != tuple(tree.shape):
                raise ValueError(f"{prefix}: checkpoint shape {arr.shape} "
                                 f"!= {tuple(tree.shape)}")
            return torch.as_tensor(arr).to(device=tree.device,
                                           dtype=tree.dtype)

        return load(state_like), manifest

    def restore_payload(self, step: int | None = None
                        ) -> tuple[dict, dict, int]:
        """Load a :meth:`save_payload` checkpoint back as
        ``(arrays, objs, step)``."""
        d, manifest = self._manifest(step)
        arrays = {p: np.load(os.path.join(d, meta["file"]))
                  for p, meta in manifest["arrays"].items()}
        return arrays, manifest.get("extra", {}), int(manifest["step"])


# ======================================================================
# EagrSession codec
# ======================================================================
_KIND_U8 = {"W": 0, "I": 1, "R": 2}
_U8_KIND = np.array(["W", "I", "R"])


def _overlay_to_arrays(ov, prefix: str) -> dict:
    """One overlay as five flat arrays: kinds (uint8), origin, and the
    in-edge CSR with signs. Node ids are positional — exactly the id space
    the compiled plan and the patch path live in."""
    n = ov.n_nodes
    counts = np.fromiter((len(e) for e in ov.in_edges), np.int64, n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    pairs = [p for edges in ov.in_edges for p in edges]
    flat = np.asarray(pairs, np.int64).reshape(-1, 2)
    return {
        f"{prefix}kinds": np.fromiter(
            (_KIND_U8[x] for x in ov.kinds), np.uint8, n),
        f"{prefix}origin": np.asarray(ov.origin, np.int64).reshape(-1),
        f"{prefix}indptr": indptr,
        f"{prefix}src": flat[:, 0].copy(),
        f"{prefix}sign": flat[:, 1].astype(np.int8),
    }


def _overlay_from_arrays(arrays: dict, prefix: str, dup: bool):
    from repro_torch.core.overlay import Overlay

    kinds = _U8_KIND[arrays[f"{prefix}kinds"]].tolist()
    origin = np.asarray(arrays[f"{prefix}origin"], np.int64).tolist()
    indptr = arrays[f"{prefix}indptr"]
    pairs = np.stack([arrays[f"{prefix}src"].astype(np.int64),
                      arrays[f"{prefix}sign"].astype(np.int64)],
                     axis=1).tolist() if len(arrays[f"{prefix}src"]) else []
    in_edges = [[tuple(p) for p in pairs[indptr[v]: indptr[v + 1]]]
                for v in range(len(kinds))]
    return Overlay(kinds=kinds, origin=origin, in_edges=in_edges,
                   dup_insensitive=bool(dup))


def _sets_to_arrays(d: dict, prefix: str) -> dict:
    """A ``{base id: set of base ids}`` map as a keyed CSR (keys sorted,
    values sorted within each key — deterministic bytes for equal state)."""
    keys = np.array(sorted(d), np.int64)
    counts = np.fromiter((len(d[int(k)]) for k in keys), np.int64, len(keys))
    indptr = np.zeros(len(keys) + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    vals = np.empty(int(indptr[-1]), np.int64)
    for i, k in enumerate(keys):
        vals[indptr[i]: indptr[i + 1]] = sorted(d[int(k)])
    return {f"{prefix}keys": keys, f"{prefix}indptr": indptr,
            f"{prefix}vals": vals}


def _sets_from_arrays(arrays: dict, prefix: str) -> dict:
    keys = arrays[f"{prefix}keys"]
    indptr = arrays[f"{prefix}indptr"]
    vals = arrays[f"{prefix}vals"]
    return {int(k): set(vals[indptr[i]: indptr[i + 1]].tolist())
            for i, k in enumerate(keys)}


def scrub_dead_writers(dyn, live_writers: set) -> None:
    """Repair a ``DynamicOverlay`` re-adopted from an unpruned export.

    ``to_overlay(prune=False)`` keeps deleted/superseded writer nodes with
    their 'W' label (stable ids for the patch path), and ``from_overlay``
    then re-registers every one of them. Drop every W node that is not its
    base's current live writer, and unregister bases whose writer was
    deleted outright, so the rebuilt journal behaves like the live one it
    replaces."""
    b = dyn.b
    for v in range(len(b.kinds)):
        if b.kinds[v] != "W":
            continue
        base = b.origin[v]
        if base in live_writers and b.writer_node.get(base) == v:
            continue
        b.members[v] = set()
        ns = b.rev.get(base)
        if ns is not None:
            ns.discard(v)
            if not ns:
                del b.rev[base]
        if base not in live_writers:
            b.writer_node.pop(base, None)


def master_arrays(master) -> dict:
    """The session master ``DynamicOverlay`` as a named-array payload:
    unpruned overlay export (stable node ids), the live writer set, reader
    input sets and the direct-edge counters."""
    from repro_torch.core.engine import _map_to_pairs

    ov = master.to_overlay(prune=False)
    out = _overlay_to_arrays(ov, "m.")
    out["m.writers"] = np.array(sorted(master.b.writer_node), np.int64)
    out["m.dwc"] = _map_to_pairs(master.direct_writer_count)
    out.update(_sets_to_arrays(master.reader_inputs, "ri."))
    return out


def master_from_arrays(arrays: dict, *, threshold: int, split_limit: int,
                       dup: bool):
    from repro_torch.core.dynamic import DynamicOverlay

    ov = _overlay_from_arrays(arrays, "m.", dup)
    ri = _sets_from_arrays(arrays, "ri.")
    dyn = DynamicOverlay.from_overlay(ov, ri, threshold=threshold,
                                      split_limit=split_limit)
    scrub_dead_writers(dyn, set(arrays["m.writers"].tolist()))
    dyn.direct_writer_count = {int(k): int(v)
                               for k, v in zip(*arrays["m.dwc"])}
    return dyn


def _agg_payload(agg) -> dict:
    """(name, constructor params) recovered from the aggregate's cache key —
    the identity the engine groups hash on. Custom aggregates carry Python
    callables and are not serializable."""
    ck = agg.cache_key
    if ck is None:
        raise ValueError(
            f"aggregate {agg.name!r} has no cache_key — custom aggregates "
            f"are not checkpointable (register built-ins, or rebuild the "
            f"session and replay)")
    name = ck[0]
    if name in ("sum", "max", "min"):
        params = {"value_dim": int(ck[1])}
    elif name == "topk":
        params = {"k": int(ck[1]), "domain": int(ck[2])}
    else:
        params = {}
    return {"name": name, "params": params}


def _extend_decisions(ov, dec: np.ndarray) -> np.ndarray:
    """Extend a creation-time global decision vector over an overlay that
    has since grown: new writers PUSH, new readers PULL, new interiors PUSH,
    then one toposort pass re-establishes the frontier invariant (a PUSH
    node never consumes a PULL node). Only the reshard path needs this."""
    from repro_torch.core.dataflow import PULL, PUSH

    out = np.empty(ov.n_nodes, np.int64)
    n0 = min(len(dec), ov.n_nodes)
    out[:n0] = np.asarray(dec[:n0], np.int64)
    for v in range(n0, ov.n_nodes):
        out[v] = PULL if ov.kinds[v] == "R" else PUSH
    for v in ov.toposort():
        if out[v] == PUSH and any(out[s] == PULL for s, _ in ov.in_edges[v]):
            out[v] = PULL
    return out


# ------------------------------------------------------------------ snapshot
def snapshot_session(session) -> tuple[dict, dict]:
    """Flatten a quiesced ``EagrSession`` to ``(arrays, objs)``.

    The caller (``EagrSession.save``) quiesces first — ingest ring drained,
    mutation journals flushed. Every device tensor (plan tables, windows,
    PAOs, clocks) is copied to pinned host memory behind one event wait;
    the result is pure host data, so writing continues on the checkpoint
    thread while the session resumes."""
    from repro_torch.core.engine import _map_to_pairs, plan_snapshot_parts
    from repro_torch.core.window import WindowState

    if session._pending:
        raise RuntimeError("snapshot_session on a session with un-flushed "
                           "mutations — flush() first")
    items: list = [
        ("wcount", np.asarray(session._wcount, np.float64)),
        ("rcount", np.asarray(session._rcount, np.float64)),
    ]
    if session.write_freq is not None:
        items.append(("wfreq", np.asarray(session.write_freq, np.float64)))
    if session.read_freq is not None:
        items.append(("rfreq", np.asarray(session.read_freq, np.float64)))
    # master overlay: if the lazy master was never materialized since the
    # last restore, its payload is still exactly the one restored from
    if session._master_obj is None and session._master_src is not None:
        items.extend(session._master_src.items())
    else:
        items.extend(master_arrays(session._master).items())

    def add_plan(prefix: str, plan) -> dict:
        tensors, arrays, objs = plan_snapshot_parts(plan)
        items.extend((prefix + k, v) for k, v in tensors.items())
        items.extend((prefix + k, v) for k, v in arrays.items())
        return objs

    groups = list(session._groups.values())
    gobjs = []
    for i, g in enumerate(groups):
        eng = g.engine
        gobj = {
            "agg": _agg_payload(g.agg),
            "spec": dataclasses.asdict(g.spec),
            "continuous": bool(g.continuous),
            "now": float(eng._now_host),
        }
        st = eng.state
        items.extend((f"g{i}.win.{f}", x)
                     for f, x in zip(WindowState._fields, st.windows))
        items.append((f"g{i}.pao", st.pao))
        items.append((f"g{i}.now", st.now))
        if session.n_shards:
            S = session.n_shards
            # after churn the authoritative per-shard overlays live in the
            # journal's DynamicOverlays; `sharded.shards` is the
            # construction snapshot and goes stale
            if g.sdyn is not None:
                exports = [g.sdyn.dynamics[s].to_overlay(prune=False)
                           for s in range(S)]
            else:
                exports = list(g.sharded.shards)
            gobj["plans"] = [add_plan(f"g{i}.s{s}.plan.",
                                      g.sharded.shard_plans[s])
                             for s in range(S)]
            for s in range(S):
                items.extend(_overlay_to_arrays(exports[s],
                                                f"g{i}.s{s}.").items())
            items.append((f"g{i}.leval",
                          np.asarray(eng._last_eval_now, np.float32)))
            items.append((f"g{i}.rs", _map_to_pairs(g.sharded.reader_shard)))
            items.append((f"g{i}.dec", np.asarray(g.dec_global, np.int64)))
        else:
            gobj["plan"] = add_plan(f"g{i}.plan.", eng.plan)
            gobj["leval"] = float(eng._last_eval_now)
            items.append((f"g{i}.expiry",
                          np.asarray(eng._expiry, np.float64)))
            items.append((f"g{i}.flog",
                          np.asarray(eng.frontier_log, np.int64)))
        al = getattr(eng, "alerts", None)
        if al is not None and al.n_alerts:
            # standing alerts: per-base columns (armed/debounce/ref state
            # rides the dynamic fields) + JSON spec descriptors; base ids,
            # not rows, so they restore onto any shard layout
            aarr, aspecs = al.snapshot()
            items.extend((f"g{i}.alert.{k}", v) for k, v in aarr.items())
            gobj["alerts"] = aspecs
            gobj["alert_cap"] = int(al.cap)
            gobj["alert_handles"] = [
                {"aid": int(aid), "qid": int(h.query.qid)}
                for aid, h in sorted(session._alerts.items())
                if h.query.group is g]
        gobjs.append(gobj)
    arrays = dict(_host_arrays(items))

    gi_of = {id(g): i for i, g in enumerate(groups)}
    handles = []
    for qid in sorted(session._handles):
        h = session._handles[qid]
        handles.append({
            "qid": int(qid),
            "group": gi_of[id(h.group)],
            "readers": (sorted(int(r) for r in h.query.readers)
                        if h.query.readers is not None else None),
        })

    ing = session._ingest_stats()
    objs = {
        "format": 1,
        "config": {
            "n_base": session.n_base,
            "n_shards": session.n_shards,
            "backend": None,
            "headroom": session.headroom,
            "growth": session.growth,
            "seed": session.seed,
            "threshold": session.threshold,
            "split_limit": session.split_limit,
            "calibrate": session.calibrate,
            "adapt_every": session.adapt_every,
            "ingest_depth": session.ingest_depth,
            "ingest_batch": session.ingest_batch,
            "value_dim": session._value_dim,
            "dup": bool(session._master_dup),
            "seq": session._seq,
            "next_qid": session._next_qid,
            "next_aid": session._next_aid,
            "ops_since_adapt": session._ops_since_adapt,
            "ckpt_every": session.ckpt_every,
            "ckpt_keep": session.ckpt_keep,
        },
        "construction": (dataclasses.asdict(session.overlay_stats)
                         if session.overlay_stats is not None else None),
        "ingest": ing.as_dict() if ing is not None else None,
        "groups": gobjs,
        "handles": handles,
    }
    return arrays, objs


# ------------------------------------------------------------------- restore
def _slice(arrays: dict, prefix: str) -> dict:
    n = len(prefix)
    return {k[n:]: v for k, v in arrays.items() if k.startswith(prefix)}


def _new_group(session, gobj: dict, agg, spec):
    """An ``_EngineGroup`` shell for a restored group (no construction)."""
    from repro_torch.session import _EngineGroup

    g = object.__new__(_EngineGroup)
    g.session = session
    g.agg = agg
    g.spec = spec
    g.continuous = bool(gobj["continuous"])
    g.key = (agg, spec, g.continuous)
    g.handles = []
    g.window_int = int(max(1, spec.capacity or spec.size))
    g.cost = session._cost_model(agg, g.window_int)
    g.dyn = None   # journals rebuild lazily on the first post-restore churn
    g.sdyn = None
    return g


def _put(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a, dtype)),
                           device=device)


def _restore_group_same(session, i: int, gobj: dict, arrays: dict,
                        master_ov, agg, spec):
    """Rebuild one engine group in its saved shard layout — no compilation,
    no PAO refresh: plans, windows, PAOs and clocks are adopted verbatim, so
    the first read off the restored group equals the saved session's answer
    bit for bit."""
    from repro_torch.core.engine import (
        EagrEngine,
        EngineState,
        plan_from_snapshot,
    )
    from repro_torch.core.window import WindowState, window_state_from_host

    dev = session.device
    g = _new_group(session, gobj, agg, spec)
    win = window_state_from_host(
        {f: arrays[f"g{i}.win.{f}"] for f in WindowState._fields},
        device=dev)
    pao = _put(arrays[f"g{i}.pao"], np.float32, dev)
    now = _put(arrays[f"g{i}.now"], np.float32, dev)
    if session.n_shards:
        from repro_torch.distributed.eagr_shard import ShardedOverlay
        from repro_torch.distributed.stacked import StackedShardedEngine

        S = session.n_shards
        plans = [plan_from_snapshot(_slice(arrays, f"g{i}.s{s}.plan."),
                                    gobj["plans"][s], device=dev)
                 for s in range(S)]
        shards = [_overlay_from_arrays(arrays, f"g{i}.s{s}.",
                                       session._master_dup)
                  for s in range(S)]
        g.sharded = ShardedOverlay(
            shards=shards,
            shard_decisions=[np.asarray(p.decision, np.int64)
                             for p in plans],
            reader_shard={int(k): int(v)
                          for k, v in zip(*arrays[f"g{i}.rs"])},
            shard_plans=plans,
            writer_rows=[p.writer_row_of_base for p in plans])
        g.dec_global = np.asarray(arrays[f"g{i}.dec"], np.int64)
        g.engine = StackedShardedEngine(g.sharded, agg, spec,
                                        base_capacity=session.n_base)
        g.engine.pin_push = g.continuous
        g.engine.adopt_state(EngineState(win, pao, now),
                             now_host=gobj["now"],
                             last_eval_now=arrays[f"g{i}.leval"])
    else:
        plan = plan_from_snapshot(_slice(arrays, f"g{i}.plan."),
                                  gobj["plan"], device=dev)
        g.engine = EagrEngine(master_ov, plan.decision, agg, spec,
                              plan=plan, device=dev)
        g.engine.pin_push = g.continuous
        g.engine.adopt_state(EngineState(win, pao, now.reshape(())),
                             now_host=gobj["now"],
                             last_eval_now=gobj["leval"],
                             expiry=arrays[f"g{i}.expiry"].tolist())
        g.engine.frontier_log = arrays[f"g{i}.flog"].tolist()
    return g


def _restore_group_reshard(session, i: int, gobj: dict, arrays: dict,
                           basis, old_shards: int, agg, spec):
    """Rebuild one engine group into a DIFFERENT shard layout (N -> M, or
    to a single engine). Plans recompile against the master basis, window
    rings redistribute by base id (write replication keeps a writer's ring
    identical across its owning shards, so any old owner is a valid source)
    and PAOs recompute from the migrated windows at the saved clock."""
    from repro_torch.core import dataflow as D
    from repro_torch.core.engine import (
        EagrEngine,
        EngineState,
        refresh_pao_step,
    )
    from repro_torch.core.window import (
        WindowState,
        stack_windows,
        take_window_rows,
        window_state_from_host,
    )

    dev = session.device
    g = _new_group(session, gobj, agg, spec)
    now = float(gobj["now"])
    now_d = torch.tensor(now, dtype=torch.float32, device=dev)

    if g.continuous:
        dec = np.full(basis.n_nodes, D.PUSH, np.int64)
    else:
        saved = (arrays[f"g{i}.dec"] if old_shards
                 else arrays[f"g{i}.plan.decision"])
        dec = _extend_decisions(basis, np.asarray(saved, np.int64))

    # gather every saved window ring, keyed by base writer id
    if old_shards:
        hosts = [{f: arrays[f"g{i}.win.{f}"][s]
                  for f in WindowState._fields} for s in range(old_shards)]
        maps = [{int(k): int(v)
                 for k, v in zip(*arrays[f"g{i}.s{s}.plan.wrob"])}
                for s in range(old_shards)]
    else:
        hosts = [{f: arrays[f"g{i}.win.{f}"]
                  for f in WindowState._fields}]
        maps = [{int(k): int(v) for k, v in zip(*arrays[f"g{i}.plan.wrob"])}]
    big = {f: np.concatenate([h[f] for h in hosts])
           for f in WindowState._fields}
    src_of_base: dict[int, int] = {}
    off = 0
    for h, m in zip(hosts, maps):
        for b, r in m.items():
            src_of_base.setdefault(b, off + r)
        off += len(h["head"])

    def rows_for(plan) -> np.ndarray:
        rows = np.full(plan.meta.n_writers, -1, np.int64)
        for b, r in plan.writer_row_of_base.items():
            rows[r] = src_of_base.get(b, -1)
        return rows

    if session.n_shards:
        from repro_torch.distributed.eagr_shard import partition_overlay
        from repro_torch.distributed.stacked import StackedShardedEngine

        M = session.n_shards
        g.sharded = partition_overlay(
            basis, dec, n_shards=M, seed=session.seed, device=dev,
            headroom=session.headroom)
        g.dec_global = dec
        g.engine = StackedShardedEngine(g.sharded, agg, spec,
                                        base_capacity=session.n_base)
        g.engine.pin_push = g.continuous
        wins, paos = [], []
        for plan in g.sharded.shard_plans:
            w = window_state_from_host(take_window_rows(big, rows_for(plan)),
                                       device=dev)
            wins.append(w)
            paos.append(refresh_pao_step(plan.meta, agg, spec, plan.arrays,
                                         w, now_d))
        state = EngineState(stack_windows(wins), torch.stack(paos),
                            torch.full((M,), now, dtype=torch.float32,
                                       device=dev))
        g.engine.adopt_state(state, now_host=now,
                             last_eval_now=np.full(M, now, np.float32))
    else:
        g.engine = EagrEngine(basis, dec, agg, spec, device=dev,
                              headroom=session.headroom)
        g.engine.pin_push = g.continuous
        plan = g.engine.plan
        host_win = take_window_rows(big, rows_for(plan))
        w = window_state_from_host(host_win, device=dev)
        pao = refresh_pao_step(plan.meta, agg, spec, plan.arrays, w, now_d)
        expiry = ()
        if agg.combine != "sum" and spec.kind == "time":
            stamps = host_win["stamps"]
            expiry = np.unique(stamps[np.isfinite(stamps)]).tolist()
        g.engine.adopt_state(EngineState(w, pao, now_d), now_host=now,
                             last_eval_now=now, expiry=expiry)
    return g


def restore_session(directory: str, *, step: int | None = None,
                    graph=None, shards: "int | None" = None, device=None):
    """Rebuild an ``EagrSession`` from a checkpoint directory, on ``device``
    (CUDA unless the caller names another).

    ``shards=None`` restores the saved deployment shape bit for bit —
    compiled plans, window rings, PAOs and clocks are adopted verbatim, so
    the restored session answers every read exactly as the saved one would,
    without running construction, min-cut or compilation. An explicit
    ``shards=M`` (``M >= 1``, or ``0`` for a single engine) *reshards*:
    plans recompile over the saved master overlay and window state
    redistributes by base id. ``graph`` optionally re-attaches the data
    graph (only ``.bipartite`` depends on it)."""
    from repro_torch.core.aggregates import make_aggregate
    from repro_torch.core.bipartite import Bipartite, build_bipartite
    from repro_torch.core.vnm import ConstructionStats
    from repro_torch.core.window import WindowSpec
    from repro_torch.device import resolve_device
    from repro_torch.session import EagrSession, Query, QueryHandle

    dev = resolve_device(device)
    mgr = CheckpointManager(directory)
    arrays, objs, step = mgr.restore_payload(step)
    if objs.get("format") != 1:
        raise ValueError(f"checkpoint at {directory} step {step} is not an "
                         f"EagrSession payload (format={objs.get('format')})")
    cfg = objs["config"]
    old_shards = int(cfg["n_shards"])
    target = old_shards if shards is None else int(shards)
    if target < 0:
        raise ValueError(f"shards must be >= 0, got {shards}")

    sess = object.__new__(EagrSession)
    sess.device = dev
    sess.bipartite = None if graph is None else (
        graph if isinstance(graph, Bipartite) else build_bipartite(graph))
    sess.n_base = int(cfg["n_base"])
    sess.n_shards = target
    sess.headroom = cfg["headroom"]
    sess.growth = cfg["growth"]
    sess.seed = cfg["seed"]
    sess.calibrate = bool(cfg["calibrate"])
    sess.adapt_every = int(cfg["adapt_every"])
    sess.threshold = int(cfg["threshold"])
    sess.split_limit = int(cfg["split_limit"])
    sess.write_freq = arrays.get("wfreq")
    sess.read_freq = arrays.get("rfreq")
    sess.overlay_stats = (ConstructionStats(**objs["construction"])
                          if objs.get("construction") else None)
    sess._master_obj = None
    sess._master_src = {k: v for k, v in arrays.items()
                        if k.startswith(("m.", "ri."))}
    sess._master_dup = bool(cfg["dup"])
    sess._groups = {}
    sess._handles = {}
    sess._next_qid = int(cfg["next_qid"])
    sess._alerts = {}
    sess._next_aid = int(cfg.get("next_aid") or 0)
    sess._value_dim = cfg["value_dim"]
    sess._wcount = np.asarray(arrays["wcount"], np.float64).copy()
    sess._rcount = np.asarray(arrays["rcount"], np.float64).copy()
    sess._ops_since_adapt = int(cfg["ops_since_adapt"])
    sess._pending = False
    sess.ingest_depth = int(cfg["ingest_depth"])
    sess.ingest_batch = int(cfg["ingest_batch"])
    sess._pipeline = None
    sess._carry_ingest = None
    if objs.get("ingest"):
        from repro_torch.streams.ingest import IngestStats
        sess._carry_ingest = IngestStats(**objs["ingest"])
    sess._seq = int(cfg["seq"])
    sess.ckpt_dir = directory
    sess.ckpt_every = int(cfg.get("ckpt_every") or 0)
    sess.ckpt_keep = int(cfg.get("ckpt_keep") or 3)
    sess._ckpt_mgrs = {}
    sess._last_ckpt_step = step

    same = target == old_shards
    basis = None
    if not same or target == 0:
        # single engines keep the master export as their overlay mirror (the
        # patch path seeds its host bookkeeping from it); resharding needs
        # it as the repartition basis
        basis = _overlay_from_arrays(arrays, "m.", sess._master_dup)
    for i, gobj in enumerate(objs["groups"]):
        agg_p = gobj["agg"]
        agg = make_aggregate(agg_p["name"], **agg_p["params"])
        spec = WindowSpec(**gobj["spec"])
        if same:
            g = _restore_group_same(sess, i, gobj, arrays, basis, agg, spec)
        else:
            g = _restore_group_reshard(sess, i, gobj, arrays, basis,
                                       old_shards, agg, spec)
        sess._groups[g.key] = g

    groups = list(sess._groups.values())
    for h in objs["handles"]:
        group = groups[h["group"]]
        agg_p = objs["groups"][h["group"]]["agg"]
        query = Query(agg=agg_p["name"],
                      window=group.spec,
                      readers=h["readers"],
                      continuous=group.continuous,
                      agg_kwargs=agg_p["params"] or None)
        handle = QueryHandle(qid=int(h["qid"]), query=query, agg=group.agg,
                             spec=group.spec, session=sess, group=group)
        group.handles.append(handle.qid)
        sess._handles[handle.qid] = handle

    # standing alerts: rebuild each group's AlertSet from the per-base
    # columns (armed/debounce/last-measure state restored verbatim, so a
    # restored session never re-fires what the saved one delivered) and
    # re-attach, which places rows on the restored (or resharded) plans
    for i, gobj in enumerate(objs["groups"]):
        aspecs = gobj.get("alerts")
        if not aspecs:
            continue
        from repro_torch.session import AlertHandle
        from repro_torch.streams.alerts import AlertSet, AlertSpec
        g = groups[i]
        alerts = AlertSet.from_snapshot(
            _slice(arrays, f"g{i}.alert."), aspecs,
            cap=int(gobj.get("alert_cap") or 0) or None)
        g.engine.attach_alerts(alerts)
        qid_of = {int(e["aid"]): int(e["qid"])
                  for e in gobj.get("alert_handles", ())}
        for e in aspecs:
            aid = int(e["aid"])
            qh = sess._handles.get(qid_of.get(aid, -1))
            if qh is None:
                continue
            sess._alerts[aid] = AlertHandle(
                aid=aid, spec=AlertSpec.from_json(e["spec"]),
                query=qh, session=sess)
    return sess
