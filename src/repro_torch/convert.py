"""Carry the JAX reference's state across, as numpy arrays.

The JAX package's ``LayeredGraph``, ``AttributeTable``, oracle
partitions, serving-engine shards, model parameter trees (the LM's
stacked layers sliced per layer) and AdamW states are turned
into numpy by the caller (``np.asarray`` on each field or leaf); these
functions build the port's
counterparts from that numpy alone, so this module never needs JAX.  The
parity tests use them to search the reference's own graphs and run its
own weights.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.baselines import OraclePartitionIndex
from repro_torch.core.graph import LayeredGraph
from repro_torch.core.index import AcornConfig, HybridIndex
from repro_torch.core.predicates import AttributeTable, SelectivitySketch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.gnn import PNA, PNAConfig, set_pna_params
from repro_torch.models.common import set_named_params
from repro_torch.models.recsys import (DCNv2, DCNv2Config, DIEN, DIENConfig,
                                       SASRec, SASRecConfig, TwoTower,
                                       TwoTowerConfig, set_two_tower_params)
from repro_torch.models.transformer import Transformer, TransformerConfig
from repro_torch.serve.engine import EngineConfig, ServingEngine
from repro_torch.train.optimizer import AdamWState


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


def _two_tower_arrays(tree: Mapping) -> Dict[str, np.ndarray]:
    """A reference two-tower tree (``user_emb``, ``item_emb`` and
    ``user_tower`` / ``item_tower`` each ``{"w": [(d_in, d_out), ...],
    "b": [(d_out,), ...]}``) as ``{port parameter name: array}``; each
    ``w`` transposed into ``nn.Linear``'s (out, in)."""
    out = {"user_emb": np.asarray(tree["user_emb"]),
           "item_emb": np.asarray(tree["item_emb"])}
    for name in ("user_tower", "item_tower"):
        for i, (w, b) in enumerate(zip(tree[name]["w"], tree[name]["b"])):
            out[f"{name}.{i}.weight"] = np.asarray(w).T
            out[f"{name}.{i}.bias"] = np.asarray(b)
    return out


def _pna_arrays(tree: Mapping) -> Dict[str, np.ndarray]:
    """A reference PNA tree (``enc``, ``dec``, ``layers`` of ``{"w_msg",
    "w_upd"}``) as ``{port parameter name: array}``; same layouts."""
    out = {"enc": np.asarray(tree["enc"]), "dec": np.asarray(tree["dec"])}
    for i, lp in enumerate(tree["layers"]):
        out[f"layers.{i}.w_msg"] = np.asarray(lp["w_msg"])
        out[f"layers.{i}.w_upd"] = np.asarray(lp["w_upd"])
    return out


def _flat_arrays(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A reference tree of dicts and lists as ``{dotted path: array}``
    (``{"mlp": {"w": [a, b]}}`` -> ``mlp.w.0``, ``mlp.w.1``): the port's
    parameter names of the models that keep the reference's layouts
    (DIEN, SASRec, DCN-v2)."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat_arrays(v, f"{prefix}{k}."))
    return out


def _tensor(a, dev, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=dev, dtype=dtype)


def two_tower_params_from_arrays(tree: Mapping, cfg: TwoTowerConfig,
                                 device: DeviceLike = "cuda") -> TwoTower:
    """A :class:`TwoTower` that computes what the reference's
    ``init_two_tower`` parameter tree computes.

    ``tree`` has the reference's keys with numpy leaves: ``user_emb``,
    ``item_emb``, and ``user_tower`` / ``item_tower`` each
    ``{"w": [(d_in, d_out), ...], "b": [(d_out,), ...]}``; each ``w`` is
    transposed into ``nn.Linear``'s (out, in)."""
    dev = resolve_device(device)
    named = {k: _tensor(a, dev, cfg.dtype)
             for k, a in _two_tower_arrays(tree).items()}
    towers = [[(named[f"{name}.{i}.weight"], named[f"{name}.{i}.bias"])
               for i in range(len(tree[name]["w"]))]
              for name in ("user_tower", "item_tower")]
    return set_two_tower_params(TwoTower(cfg), named["user_emb"],
                                named["item_emb"], towers)


def pna_params_from_arrays(tree: Mapping, cfg: PNAConfig,
                           device: DeviceLike = "cuda") -> PNA:
    """A :class:`PNA` that computes what the reference's ``init_pna``
    parameter tree computes.

    ``tree`` has the reference's keys with numpy leaves: ``enc``
    (d_in, d_hidden), ``dec`` (d_hidden, C) and ``layers``, a list of
    ``{"w_msg", "w_upd"}``; the layouts are the same in both packages."""
    dev = resolve_device(device)
    named = {k: _tensor(a, dev, cfg.dtype)
             for k, a in _pna_arrays(tree).items()}
    return set_pna_params(
        PNA(cfg), named["enc"], named["dec"],
        [(named[f"layers.{i}.w_msg"], named[f"layers.{i}.w_upd"])
         for i in range(len(tree["layers"]))])


def _same_layout(tree: Mapping, model_cls, cfg, device) -> torch.nn.Module:
    dev = resolve_device(device)
    return set_named_params(model_cls(cfg), {
        k: _tensor(a, dev, cfg.dtype) for k, a in _flat_arrays(tree).items()})


def dien_params_from_arrays(tree: Mapping, cfg: DIENConfig,
                            device: DeviceLike = "cuda") -> DIEN:
    """A :class:`DIEN` that computes what the reference's ``init_dien``
    parameter tree computes (``item_emb``, ``cate_emb``, ``gru1`` and
    ``augru`` each ``{"wi", "wh", "b"}``, ``att_w``, ``mlp`` ``{"w": [...],
    "b": [...]}``; numpy leaves, the same layouts in both packages)."""
    return _same_layout(tree, DIEN, cfg, device)


def sasrec_params_from_arrays(tree: Mapping, cfg: SASRecConfig,
                              device: DeviceLike = "cuda") -> SASRec:
    """A :class:`SASRec` from the reference's ``init_sasrec`` tree
    (``item_emb``, ``pos_emb``, ``blocks``: a list of ``{"wq", "wk", "wv",
    "wo", "w1", "w2", "ln1", "ln2"}``); the same layouts."""
    return _same_layout(tree, SASRec, cfg, device)


def dcnv2_params_from_arrays(tree: Mapping, cfg: DCNv2Config,
                             device: DeviceLike = "cuda") -> DCNv2:
    """A :class:`DCNv2` from the reference's ``init_dcnv2`` tree
    (``tables``: a list, ``cross``: a list of ``{"w", "b"}``, ``mlp``,
    ``head``); the same layouts."""
    return _same_layout(tree, DCNv2, cfg, device)


def _lm_arrays(tree: Mapping) -> Dict[str, np.ndarray]:
    """A reference LM tree (``embed``, ``final_norm`` and ``layers``, a
    dict of (L, ...) stacked arrays) as ``{port parameter name: array}``:
    ``layers.{i}.{name}`` is slice i of ``layers[name]``; same layouts."""
    out = {"embed": np.asarray(tree["embed"]),
           "final_norm": np.asarray(tree["final_norm"])}
    for name, stacked in tree["layers"].items():
        stacked = np.asarray(stacked)
        for i in range(stacked.shape[0]):
            out[f"layers.{i}.{name}"] = stacked[i]
    return out


def lm_params_from_arrays(tree: Mapping, cfg: TransformerConfig,
                          device: DeviceLike = "cuda") -> Transformer:
    """A :class:`Transformer` that computes what the reference's
    ``init_lm`` parameter tree computes: ``embed`` (V, d), ``final_norm``
    (d,) and ``layers``, a dict of arrays stacked over the layers ((L, d,
    ...) each; numpy leaves, bf16 ones included), sliced into the
    per-layer modules in ``cfg.dtype``."""
    dev = resolve_device(device)
    return set_named_params(Transformer(cfg), {
        k: _tensor(a, dev, cfg.dtype) for k, a in _lm_arrays(tree).items()})


_LAYOUTS = {TwoTower: _two_tower_arrays, PNA: _pna_arrays,
            DIEN: _flat_arrays, SASRec: _flat_arrays, DCNv2: _flat_arrays,
            Transformer: _lm_arrays}


def param_arrays(tree: Mapping, model: torch.nn.Module
                 ) -> Dict[str, np.ndarray]:
    """A reference tree over ``model``'s parameters (the parameters
    themselves, their gradients or a moment; numpy leaves) as
    ``{port parameter name: array}``, in the port's layouts.  ``model`` is
    a :class:`TwoTower`, :class:`PNA`, :class:`DIEN`, :class:`SASRec`,
    :class:`DCNv2` or :class:`Transformer`."""
    named = _LAYOUTS[type(model)](tree)
    if sorted(named) != sorted(k for k, _ in model.named_parameters()):
        raise ValueError("the tree's keys do not match the model's "
                         "parameters")
    return named


def adamw_state_from_arrays(step, mu: Mapping, nu: Mapping,
                            model: torch.nn.Module,
                            device: DeviceLike = "cuda") -> AdamWState:
    """The port's :class:`AdamWState` for ``model`` (any model
    :func:`param_arrays` takes) from the reference's ``AdamWState`` given
    as numpy: ``step`` and the ``mu`` / ``nu`` trees, which have the
    reference's parameter keys.  The moments are renamed and transposed as the
    parameter converters do, so a port step continues a reference step."""
    dev = resolve_device(device)

    def moments(tree):
        return {k: _tensor(a, dev)
                for k, a in param_arrays(tree, model).items()}

    return AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=dev),
        mu=moments(mu), nu=moments(nu))
