"""Architecture registry: ``get_arch(arch_id)`` -> the arch's config module
(``FAMILY``, ``CFG``, ``SHAPE_DEFS``, ``build_smoke(shape, device=None)``),
over the archs the port serves (the dense LMs granite-3-2b and
internlm2-1.8b, and DIEN).
The JAX package's other archs raise ``NotImplementedError`` naming their
ROADMAP item; an id the JAX package does not know raises ``KeyError``."""
from __future__ import annotations

import importlib

from repro_torch.core.engine import not_ported

_MODULES = {
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "dien": "repro_torch.configs.dien",
}

# the JAX package's archs the port does not serve yet, with their ROADMAP item
_WAITING = {
    "command-r-plus-104b": "13",
    "arctic-480b": "13",
    "dbrx-132b": "13",
    "graphcast": "13",
    "gat-cora": "13",
    "nequip": "13",
    "gatedgcn": "13",
    "eagr": "13",
}


def get_arch(arch_id: str):
    if arch_id in _WAITING:
        raise not_ported(f"architecture {arch_id!r}", _WAITING[arch_id])
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the port serves "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id])
