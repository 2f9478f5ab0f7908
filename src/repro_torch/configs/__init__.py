"""Architecture registry: ``get_arch(arch_id)`` -> the arch's config module
(``FAMILY``, ``CFG``, ``SHAPE_DEFS``, ``build_smoke(shape, device=None)``,
``ARCH``: the ``configs.cell.ArchSpec`` whose ``build(shape, device=None,
reduced=None)`` gives every shape's ``CellPlan`` at full size, on the meta
device for the dry run; granite-3-2b, DIEN and the four GNNs also
``build_train`` for the full-width train cell that ``chip_smoke.py``
drives), over every arch of
the JAX package's registry: the LMs granite-3-2b, internlm2-1.8b,
command-r-plus-104b, arctic-480b and dbrx-132b, DIEN, the GNNs graphcast,
gat-cora, nequip and gatedgcn, and the paper's own system, eagr. An id
the JAX package does not know raises ``KeyError``."""
from __future__ import annotations

import importlib

_MODULES = {
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "graphcast": "repro_torch.configs.graphcast",
    "gat-cora": "repro_torch.configs.gat_cora",
    "nequip": "repro_torch.configs.nequip",
    "gatedgcn": "repro_torch.configs.gatedgcn",
    "dien": "repro_torch.configs.dien",
    "eagr": "repro_torch.configs.eagr",
}


def get_arch(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the port serves "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id])


ARCH_IDS = [k for k in _MODULES if k != "eagr"]  # the 10 assigned archs


def all_cells() -> list[tuple[str, str]]:
    """The 40 assigned (arch, shape) cells, in the JAX package's order."""
    return [(a, s) for a in ARCH_IDS for s in get_arch(a).ARCH.shapes]
