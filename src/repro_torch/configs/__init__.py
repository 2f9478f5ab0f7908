"""Architecture registry: ``get_arch(arch_id)`` -> the arch's config module
(``FAMILY``, ``CFG``, ``SHAPE_DEFS``, ``build_smoke(shape, device=None)``;
granite-3-2b and DIEN also ``build_train`` for the full-width train cell
that ``chip_smoke.py`` drives),
over the archs the port serves and trains (the LMs granite-3-2b,
internlm2-1.8b, command-r-plus-104b, arctic-480b and dbrx-132b, DIEN, and
the paper's own system, eagr). The JAX package's GNN archs raise
``NotImplementedError`` naming their ROADMAP item; an id the JAX package
does not know raises ``KeyError``."""
from __future__ import annotations

import importlib

from repro_torch.core.engine import not_ported

_MODULES = {
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "dien": "repro_torch.configs.dien",
    "eagr": "repro_torch.configs.eagr",
}

# the JAX package's archs the port does not serve yet, with their ROADMAP item
_WAITING = {
    "graphcast": "13",
    "gat-cora": "13",
    "nequip": "13",
    "gatedgcn": "13",
}


def get_arch(arch_id: str):
    if arch_id in _WAITING:
        raise not_ported(f"architecture {arch_id!r}", _WAITING[arch_id])
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the port serves "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id])
