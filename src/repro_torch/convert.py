"""Carry a plan, live state, model parameters and optimizer state from the
JAX package into the port.

The JAX package hands its state over as host numpy (``plan_snapshot`` of
``repro.core.engine``, ``window_state_to_host`` of ``repro.core.window``, and
a parameter or optimizer-state pytree mapped through ``np.asarray``); these
functions turn it into the port's tensors on ``device``, which is CUDA
unless the caller names another. Nothing here imports the JAX package: the
caller holds both sides.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import (
    EngineState,
    ExecPlan,
    plan_from_snapshot,
)
from repro_torch.core.window import WindowState
from repro_torch.device import resolve_device
from repro_torch.train.optimizer import AdamState, FactorState

def plan_from_reference(arrays: dict, objs: dict, device=None) -> ExecPlan:
    """An ``ExecPlan`` on ``device`` (CUDA unless the caller names another)
    from the output of the JAX package's ``plan_snapshot(plan)``: the tables
    travel verbatim. A plan the JAX package has patched under churn carries
    over too: its unpruned id space (decisions and levels from its patch
    bookkeeping), appended and retired writer rows and its real depth. The
    port rebuilds its own patch bookkeeping on the first patch, from the
    unpruned overlay the caller passes the engine. The backend fields of
    the JAX package's ``PlanMeta`` are dropped and its bf16 flag is kept
    (a plan compiled with ``EAGR_SEGAGG_BF16=1`` stays in bf16 mode); the
    'xla_unrolled' backend has no counterpart and raises."""
    return plan_from_snapshot(arrays, objs, device=device)


def state_from_reference(window_arrays: dict, pao, now,
                         device=None) -> EngineState:
    """An ``EngineState`` on ``device`` (CUDA unless the caller names
    another) from the JAX package's ``window_state_to_host(state.windows)``,
    its PAO array and its clock."""
    device = resolve_device(device)
    put = lambda a, dt: torch.tensor(np.asarray(a, dt), device=device)
    windows = WindowState(
        values=put(window_arrays["values"], np.float32),
        stamps=put(window_arrays["stamps"], np.float32),
        head=put(window_arrays["head"], np.int32),
        count=put(window_arrays["count"], np.int32))
    return EngineState(windows, put(pao, np.float32),
                       torch.tensor(float(np.float32(now)),
                                    dtype=torch.float32, device=device))


def _param_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: exact via fp32
        return torch.tensor(a.astype(np.float32),
                            device=device).to(torch.bfloat16)
    return torch.tensor(a, device=device)


def params_from_reference(tree, device=None):
    """The port's parameter tree on ``device`` (CUDA unless the caller names
    another) from the JAX package's parameters as numpy (``jax.tree.map(
    np.asarray, params)``): the transformer's and DIEN's trees alike. The
    port keeps the JAX layout, layer-stacked ``(L, ...)`` leaves included,
    so every leaf travels verbatim in its own dtype."""
    device = resolve_device(device)

    def put(node):
        if isinstance(node, dict):
            return {k: put(v) for k, v in node.items()}
        return _param_tensor(node, device)

    return put(tree)


def opt_state_from_reference(state, device=None):
    """The port's optimizer state on ``device`` (CUDA unless the caller
    names another) from the JAX package's as numpy (``jax.tree.map(
    np.asarray, opt_state)``): its ``AdamState(mu, nu, count)`` becomes the
    port's ``AdamState``, its ``FactorState(vr, vc, count)`` the port's
    ``FactorState`` (told apart by their field names), SGD's tree of
    momenta a tree of tensors; every leaf in its own dtype, the count a 0-d
    int32 tensor."""
    device = resolve_device(device)
    fields = getattr(state, "_fields", None)
    kinds = {("mu", "nu", "count"): AdamState,
             ("vr", "vc", "count"): FactorState}
    if fields is None:
        return params_from_reference(state, device=device)
    if tuple(fields) not in kinds:
        raise TypeError(f"unknown optimizer state with fields {fields}")
    a, b, count = state
    return kinds[tuple(fields)](
        params_from_reference(a, device=device),
        params_from_reference(b, device=device),
        torch.tensor(np.asarray(count), dtype=torch.int32, device=device))
