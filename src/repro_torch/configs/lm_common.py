"""Shared machinery for the architectures' cells.

Only :class:`CellDef` is ported so far; the LM shapes and ``LMArch`` wait
for the LM slice (ROADMAP queue 1 item 9).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class CellDef:
    shape: str
    kind: str
    skip: Optional[str] = None
