"""Architecture registry of the port: the arches ported so far, each a
module exposing an ``ARCH`` object with the reference's interface
(``config``, ``init``, ``cells``, ``abstract_inputs``, ``step_fn``)."""
from __future__ import annotations

import importlib

_MODULES = {
    "acorn": "repro_torch.configs.acorn",
    "pna": "repro_torch.configs.pna",
    "two-tower-retrieval": "repro_torch.configs.two_tower_retrieval",
}

ARCH_IDS = list(_MODULES)


def get_arch(name: str):
    if name not in _MODULES:
        raise NotImplementedError(
            f"arch {name!r} is not ported (ported: {ARCH_IDS}); the other "
            "arches wait in ROADMAP.md queue 1 (item 5 for models/)")
    return importlib.import_module(_MODULES[name]).ARCH
