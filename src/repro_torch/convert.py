"""Carry the JAX reference's state across, as numpy arrays.

The JAX package's ``LayeredGraph``, ``AttributeTable``, oracle
partitions, serving-engine shards and model parameter trees are turned
into numpy by the caller (``np.asarray`` on each field or leaf); these
functions build the port's
counterparts from that numpy alone, so this module never needs JAX.  The
parity tests use them to search the reference's own graphs and run its
own weights.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.baselines import OraclePartitionIndex
from repro_torch.core.graph import LayeredGraph
from repro_torch.core.index import AcornConfig, HybridIndex
from repro_torch.core.predicates import AttributeTable, SelectivitySketch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.gnn import PNA, PNAConfig, set_pna_params
from repro_torch.models.recsys import (TwoTower, TwoTowerConfig,
                                       set_two_tower_params)
from repro_torch.serve.engine import EngineConfig, ServingEngine


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


def oracle_from_arrays(partitions: Mapping[int, Sequence],
                       M: int, device: DeviceLike = "cuda"
                       ) -> OraclePartitionIndex:
    """The port's :class:`OraclePartitionIndex` from a reference one's
    partitions given as numpy: ``{pid: (graph, x_p, gids)}``, where
    ``graph`` holds the keyword arguments of :func:`graph_from_arrays`
    but ``device``, ``x_p`` is the partition's (n_p, d) float32 rows and
    ``gids`` their (n_p,) global ids.  ``M`` is the search's neighbor
    bound (the reference's ``m``)."""
    dev = resolve_device(device)
    parts = {}
    for pid, (graph, xp, gids) in partitions.items():
        parts[pid] = (
            graph_from_arrays(device=dev, **graph),
            torch.from_numpy(np.array(xp, dtype=np.float32)).to(dev),
            _i32(gids, dev))
    return OraclePartitionIndex(partitions=parts, m=M)


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


def engine_from_arrays(shards: Sequence[Mapping], acorn: AcornConfig,
                       cfg: EngineConfig, seed: int = 0,
                       device: DeviceLike = "cuda") -> ServingEngine:
    """A :class:`ServingEngine` over shards given as numpy, in id order.

    Each shard is a mapping with ``graph`` (the keyword arguments of
    :func:`graph_from_arrays` but ``device``), ``x`` ((n_s, d) float32)
    and ``table`` (those of :func:`table_from_arrays`); a shard's first
    global id is the count of the rows before it.  Shard ``s`` gets the
    sketch a build with ``seed + s`` draws, as ``ServingEngine`` builds
    it.  The engine's corpus, which
    ``rebuild_shard`` rebuilds from, is the shards' rows concatenated;
    each shard's vectors are a view of it."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.concatenate(
        [np.asarray(s["x"], dtype=np.float32) for s in shards])).to(dev)
    tables = [table_from_arrays(device=dev, **s["table"]) for s in shards]
    first = tables[0]
    table = AttributeTable(
        int_cols={c: torch.cat([t.int_cols[c] for t in tables])
                  for c in first.int_cols},
        bitset_cols={c: torch.cat([t.bitset_cols[c] for t in tables])
                     for c in first.bitset_cols},
        str_cols={c: np.concatenate([t.str_cols[c] for t in tables])
                  for c in first.str_cols},
        n_keywords=dict(first.n_keywords))
    indexes, lo = [], 0
    for i, (s, t) in enumerate(zip(shards, tables)):
        hi = lo + t.n
        indexes.append(HybridIndex(
            x=x[lo:hi], table=t,
            graph=graph_from_arrays(device=dev, **s["graph"]), config=acorn,
            sketch=SelectivitySketch.build(t, seed=seed + i)))
        lo = hi
    return ServingEngine(x, table, acorn, cfg, seed=seed, device=dev,
                         indexes=indexes)


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
