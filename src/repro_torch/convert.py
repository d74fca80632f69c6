"""Carry the JAX reference's state across, as numpy arrays.

The JAX package's ``LayeredGraph``, ``AttributeTable`` and model
parameter trees are turned into numpy by the caller (``np.asarray`` on
each field or leaf); these functions build the port's counterparts from
that numpy alone, so this module never needs JAX.  The parity tests use
them to search the reference's own graph and run its own weights.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.graph import LayeredGraph
from repro_torch.core.predicates import AttributeTable
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.gnn import PNA, PNAConfig, set_pna_params
from repro_torch.models.recsys import (TwoTower, TwoTowerConfig,
                                       set_two_tower_params)


def _i32(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.int32)).to(dev)


def graph_from_arrays(neighbors: Sequence[np.ndarray],
                      pos: Sequence[np.ndarray],
                      node_ids: Sequence[np.ndarray],
                      entry_point, levels: np.ndarray,
                      device: DeviceLike = "cuda") -> LayeredGraph:
    """The port's graph from a reference graph's fields given as numpy."""
    dev = resolve_device(device)
    return LayeredGraph(
        neighbors=tuple(_i32(a, dev) for a in neighbors),
        pos=tuple(_i32(a, dev) for a in pos),
        node_ids=tuple(_i32(a, dev) for a in node_ids),
        entry_point=_i32(entry_point, dev).reshape(()),
        levels=_i32(levels, dev))


def table_from_arrays(int_cols: Mapping[str, np.ndarray],
                      bitset_cols: Optional[Mapping[str, np.ndarray]] = None,
                      str_cols: Optional[Mapping[str, Sequence[str]]] = None,
                      n_keywords: Optional[Mapping[str, int]] = None,
                      device: DeviceLike = "cuda") -> AttributeTable:
    """The port's ``AttributeTable`` from numpy columns.

    Bitset columns are (n, W) uint32 words; the port stores their bits as
    int32 (bitwise AND and ``!= 0`` tests read the same bits)."""
    dev = resolve_device(device)
    bits = {k: torch.from_numpy(
                np.array(v, dtype=np.uint32).view(np.int32)).to(dev)
            for k, v in (bitset_cols or {}).items()}
    return AttributeTable(
        int_cols={k: _i32(v, dev) for k, v in int_cols.items()},
        bitset_cols=bits,
        str_cols={k: np.asarray(v, dtype=object)
                  for k, v in (str_cols or {}).items()},
        n_keywords=dict(n_keywords or {}))


def two_tower_params_from_arrays(tree: Mapping, cfg: TwoTowerConfig,
                                 device: DeviceLike = "cuda") -> TwoTower:
    """A :class:`TwoTower` that computes what the reference's
    ``init_two_tower`` parameter tree computes.

    ``tree`` has the reference's keys with numpy leaves: ``user_emb``,
    ``item_emb``, and ``user_tower`` / ``item_tower`` each
    ``{"w": [(d_in, d_out), ...], "b": [(d_out,), ...]}``; each ``w`` is
    transposed into ``nn.Linear``'s (out, in)."""
    dev = resolve_device(device)

    def t(a, transpose=False):
        a = np.asarray(a, dtype=np.float32)
        return torch.from_numpy(np.array(a.T if transpose else a)).to(
            device=dev, dtype=cfg.dtype)

    towers = [[(t(w, transpose=True), t(b))
               for w, b in zip(tree[name]["w"], tree[name]["b"])]
              for name in ("user_tower", "item_tower")]
    return set_two_tower_params(TwoTower(cfg),
                                t(tree["user_emb"]), t(tree["item_emb"]),
                                towers)


def pna_params_from_arrays(tree: Mapping, cfg: PNAConfig,
                           device: DeviceLike = "cuda") -> PNA:
    """A :class:`PNA` that computes what the reference's ``init_pna``
    parameter tree computes.

    ``tree`` has the reference's keys with numpy leaves: ``enc``
    (d_in, d_hidden), ``dec`` (d_hidden, C) and ``layers``, a list of
    ``{"w_msg", "w_upd"}``; the layouts are the same in both packages."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=dev, dtype=cfg.dtype)

    return set_pna_params(PNA(cfg), t(tree["enc"]), t(tree["dec"]),
                          [(t(lp["w_msg"]), t(lp["w_upd"]))
                           for lp in tree["layers"]])
