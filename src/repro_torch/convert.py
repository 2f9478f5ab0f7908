"""Carry a plan, live state and model parameters from the JAX package into
the port.

The JAX package hands its state over as host numpy (``plan_snapshot`` of
``repro.core.engine``, ``window_state_to_host`` of ``repro.core.window``, and
a parameter pytree mapped through ``np.asarray``); these functions turn it
into the port's tensors on ``device``, which is CUDA unless the caller names
another. Nothing here imports the JAX package: the caller holds both sides.
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

def plan_from_reference(arrays: dict, objs: dict, device=None) -> ExecPlan:
    """An ``ExecPlan`` on ``device`` (CUDA unless the caller names another)
    from the output of the JAX package's ``plan_snapshot(plan)``: the tables
    travel verbatim. A plan the JAX package has patched under churn carries
    over too: its unpruned id space (decisions and levels from its patch
    bookkeeping), appended and retired writer rows and its real depth. The
    port rebuilds its own patch bookkeeping on the first patch, from the
    unpruned overlay the caller passes the engine. The backend fields of
    the JAX package's ``PlanMeta`` are dropped; bf16 edge values and the
    'xla_unrolled' backend have no counterpart and raise."""
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
