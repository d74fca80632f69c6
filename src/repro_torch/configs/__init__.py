"""Architecture registry of the port: one module per arch (the five LM
arches, the recsys and GNN arches and the paper's ACORN serving system),
each exposing an ``ARCH`` object with the reference's interface
(``config``, ``init``, ``cells``, ``abstract_inputs``, ``step_fn``)."""
from __future__ import annotations

import importlib

_MODULES = {
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "acorn": "repro_torch.configs.acorn",
    "pna": "repro_torch.configs.pna",
    "dien": "repro_torch.configs.dien",
    "two-tower-retrieval": "repro_torch.configs.two_tower_retrieval",
    "sasrec": "repro_torch.configs.sasrec",
    "dcn-v2": "repro_torch.configs.dcn_v2",
}

ARCH_IDS = list(_MODULES)


def get_arch(name: str):
    return importlib.import_module(_MODULES[name]).ARCH
