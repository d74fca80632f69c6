"""Structural rules of the PyTorch port.

* No file under ``src/repro_torch/``, and not ``chip_smoke.py``, imports
  ``jax`` or the JAX package ``repro`` (the port runs where JAX is absent).
* Every ``.cu`` under ``src/repro_torch/csrc/`` is built by the loader,
  and every source the loader names exists.
* Entry points given the default device (``cuda``) raise on a machine
  without CUDA instead of running on the CPU; CPU tensors take the plain
  versions, and the CUDA launchers refuse CPU tensors before any build.
* Every kernel router given ``meta`` tensors returns ``meta`` outputs of
  its kernel's shapes and records the kernel's cost for the dry run,
  without reaching the loader; the launchers refuse ``meta`` tensors.
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_arch
from repro_torch.configs.pna import ARCH as PNA_ARCH
from repro_torch.configs.two_tower_retrieval import REDUCED
from repro_torch.convert import (adamw_state_from_arrays,
                                 dcnv2_params_from_arrays,
                                 dien_params_from_arrays,
                                 engine_from_arrays, graph_from_arrays,
                                 lm_params_from_arrays, oracle_from_arrays,
                                 pna_params_from_arrays,
                                 sasrec_params_from_arrays, table_from_arrays,
                                 two_tower_params_from_arrays)
from repro_torch.core import (AcornConfig, HybridIndex, sentinel_result)
from repro_torch.data import make_hcps_dataset, make_lcps_dataset
from repro_torch.launch.perf import main as perf_main
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.serve import EngineConfig, ServingEngine
from repro_torch.kernels import loader
from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_cuda)
from repro_torch.kernels.filtered_topk import (filtered_topk,
                                               filtered_topk_cuda)
from repro_torch.kernels.gather_distance import (gather_distance,
                                                 gather_distance_cuda)
from repro_torch.kernels.neighbor_expand import (neighbor_expand,
                                                 neighbor_expand_cuda)
from repro_torch.kernels.pna_aggregate import (pna_aggregate,
                                               pna_aggregate_cuda)
from repro_torch.launch.op_cost import OpCounter
from repro_torch.models.gnn import init_pna
from repro_torch.models.recsys import init_two_tower
from repro_torch.models.transformer import init_cache

PNA_REDUCED = PNA_ARCH.config(reduced=True, shape="molecule")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{path} imports {sorted(bad)}"


def test_every_cuda_source_is_built_by_the_loader():
    on_disk = sorted(p.name for p in (PORT / "csrc").glob("*.cu"))
    assert on_disk == sorted(loader.SOURCES)
    assert loader.CSRC_DIR == PORT / "csrc"


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")


ENTRY_POINTS = {
    "resolve_device": lambda: repro_torch.resolve_device(),
    "make_lcps_dataset": lambda: make_lcps_dataset(n=64, d=4),
    "make_hcps_dataset": lambda: make_hcps_dataset(n=64, d=4),
    "ServingEngine": lambda: ServingEngine(
        torch.zeros((8, 4)), table_from_arrays({"label": np.zeros(8)},
                                               device="cpu"),
        AcornConfig(M=4, gamma=2), EngineConfig(n_shards=2)),
    "engine_from_arrays": lambda: engine_from_arrays(
        [dict(graph=dict(neighbors=[np.full((2, 2), -1)], pos=[np.arange(2)],
                         node_ids=[np.arange(2)], entry_point=0,
                         levels=np.zeros(2)),
              x=np.zeros((2, 4)), table=dict(int_cols={"label": np.zeros(2)}))],
        AcornConfig(M=4, gamma=2), EngineConfig()),
    "launch.serve": lambda: serve_main(["--n", "64", "--d", "4",
                                        "--shards", "1"]),
    "launch.train": lambda: train_main(["--arch", "two-tower-retrieval",
                                        "--steps", "2"]),
    "launch.perf": lambda: perf_main(["--reduced", "--cell", "1"]),
    "adamw_state_from_arrays": lambda: adamw_state_from_arrays(
        0, {"enc": np.zeros((8, 16)), "dec": np.zeros((16, 2)),
            "layers": []}, {"enc": np.zeros((8, 16)),
                            "dec": np.zeros((16, 2)), "layers": []},
        pna_params_from_arrays({"enc": np.zeros((8, 16)),
                                "dec": np.zeros((16, 2)), "layers": []},
                               dataclasses.replace(PNA_REDUCED, n_layers=0),
                               device="cpu")),
    "graph_from_arrays": lambda: graph_from_arrays(
        [np.full((2, 2), -1)], [np.arange(2)], [np.arange(2)], 0,
        np.zeros(2)),
    "oracle_from_arrays": lambda: oracle_from_arrays(
        {0: (dict(neighbors=[np.full((2, 2), -1)], pos=[np.arange(2)],
                  node_ids=[np.arange(2)], entry_point=0,
                  levels=np.zeros(2)), np.zeros((2, 4)), np.arange(2))}, 4),
    "table_from_arrays": lambda: table_from_arrays({"label": np.zeros(4)}),
    "sentinel_result": lambda: sentinel_result(2, 3),
    "HybridIndex.build": lambda: HybridIndex.build(
        torch.zeros((8, 4)), table_from_arrays({"label": np.zeros(8)},
                                               device="cpu"),
        AcornConfig(M=4, gamma=2)),
    "init_two_tower": lambda: init_two_tower(REDUCED),
    "two_tower_params_from_arrays": lambda: two_tower_params_from_arrays(
        {"user_emb": np.zeros((REDUCED.n_users, REDUCED.embed_dim)),
         "item_emb": np.zeros((REDUCED.n_items, REDUCED.embed_dim)),
         "user_tower": {"w": [], "b": []}, "item_tower": {"w": [], "b": []}},
        REDUCED),
    "init_pna": lambda: init_pna(PNA_REDUCED),
    "acorn.random_inputs": lambda: get_arch("acorn").random_inputs(
        "serve_1m", reduced=True),
    "pna_params_from_arrays": lambda: pna_params_from_arrays(
        {"enc": np.zeros((8, 16)), "dec": np.zeros((16, 2)),
         "layers": []}, PNA_REDUCED),
    "dien_params_from_arrays": lambda: dien_params_from_arrays(
        {}, get_arch("dien").config(reduced=True)),
    "sasrec_params_from_arrays": lambda: sasrec_params_from_arrays(
        {}, get_arch("sasrec").config(reduced=True)),
    "dcnv2_params_from_arrays": lambda: dcnv2_params_from_arrays(
        {}, get_arch("dcn-v2").config(reduced=True)),
    "dien.init": lambda: get_arch("dien").init(
        get_arch("dien").config(reduced=True)),
    "sasrec.init": lambda: get_arch("sasrec").init(
        get_arch("sasrec").config(reduced=True)),
    "dcn-v2.init": lambda: get_arch("dcn-v2").init(
        get_arch("dcn-v2").config(reduced=True)),
    "launch.train dien": lambda: train_main(["--arch", "dien",
                                             "--steps", "2"]),
    "lm_params_from_arrays": lambda: lm_params_from_arrays(
        {}, get_arch("qwen3-8b").config(reduced=True)),
    "init_cache": lambda: init_cache(
        get_arch("qwen3-8b").config(reduced=True), 1, 4),
    "launch.train qwen3-8b": lambda: train_main(["--arch", "qwen3-8b",
                                                 "--steps", "2"]),
    **{f"{a}.init": (lambda a=a: get_arch(a).init(
        get_arch(a).config(reduced=True)))
       for a in ("smollm-360m", "qwen3-8b", "gemma3-27b",
                 "deepseek-v2-lite-16b", "moonshot-v1-16b-a3b")},
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_raises_without_cuda(name):
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name]()


def test_cpu_device_runs_the_plain_path():
    ds = make_lcps_dataset(n=300, d=8, card=4, device="cpu")
    index = HybridIndex.build(ds.x, ds.table, AcornConfig(M=4, gamma=4),
                              device="cpu")
    before = (gather_distance_cuda.launches, neighbor_expand_cuda.launches)
    from repro_torch.core import Equals, SearchRequest
    res = index.search(SearchRequest(xq=ds.x[:5], predicates=[
        Equals("label", i % 4) for i in range(5)], k=3, route="graph"))
    assert res.ids.device.type == "cpu" and res.ids.shape == (5, 3)
    assert (gather_distance_cuda.launches,
            neighbor_expand_cuda.launches) == before


def test_cuda_launchers_refuse_cpu_tensors():
    ids = torch.zeros((2, 3), dtype=torch.int32)
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="cuda"):
        gather_distance_cuda(ids, torch.zeros((2, 8)), x)
    with pytest.raises(ValueError, match="cuda"):
        neighbor_expand_cuda(ids, torch.zeros((4, 3), dtype=torch.int32),
                             torch.arange(4, dtype=torch.int32),
                             strategy="filter", m=2)
    with pytest.raises(ValueError, match="cuda"):
        filtered_topk_cuda(torch.zeros((2, 8)), x,
                           torch.ones((2, 4), dtype=torch.bool), 2)
    with pytest.raises(ValueError, match="cuda"):
        pna_aggregate_cuda(torch.zeros((2, 4, 4)), torch.zeros((2, 4, 3)))
    with pytest.raises(ValueError, match="cuda"):
        embedding_bag_cuda(ids, x)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


_I32 = torch.int32
# router -> (the router, its launcher, keyword arguments, meta inputs, the
# outputs' (shape, dtype), the kernel's dense (flops, bytes) counted by
# hand)
META_ROUTERS = {
    # ids (4, 8), q (4, 16), x (100, 16): 3 flops per (id, column); ids,
    # output, queries and 32 distinct rows of 16 floats
    "gather_distance": (
        gather_distance, gather_distance_cuda, {},
        lambda: (_meta((4, 8), _I32), _meta((4, 16)), _meta((100, 16))),
        [((4, 8), torch.float32)], 3 * 4 * 8 * 16,
        4 * (32 + 32 + 64 + 32 * 16)),
    # q (2, 16), x (50, 16), k 5, l2: 2 d per pair + 2 d per row for the
    # norms; mask bytes, queries, rows, (ids, dists)
    "filtered_topk": (
        filtered_topk, filtered_topk_cuda, dict(k=5),
        lambda: (_meta((2, 16)), _meta((50, 16)),
                 _meta((2, 50), torch.bool)),
        [((2, 5), _I32), ((2, 5), torch.float32)],
        2 * 16 * 2 * 50 + 2 * 16 * 50,
        2 * 50 + 4 * (2 * 16 + 50 * 16) + 8 * 2 * 5),
    # compress, cap 6, m_beta 2, m 4: a lane's stream is 2 + 4 x (1 + 6) =
    # 30 ids and 4 pos lookups, a pass-mask and a visited byte per id
    "neighbor_expand": (
        neighbor_expand, neighbor_expand_cuda,
        dict(strategy="compress", m=4, m_beta=2),
        lambda: (_meta((3, 6), _I32), _meta((40, 6), _I32),
                 _meta((40,), _I32), _meta((3, 40), torch.bool),
                 _meta((3, 40), torch.bool)),
        [((3, 4), _I32)], 0, 3 * (4 * (30 + 4) + 2 * 30) + 4 * 3 * 4),
    # adj (2, 5, 5), feats (2, 5, 3): 7 ops per (pair, feature)
    "pna_aggregate": (
        pna_aggregate, pna_aggregate_cuda, {},
        lambda: (_meta((2, 5, 5)), _meta((2, 5, 3))),
        [((2, 5, 12), torch.float32)], 7 * 2 * 5 * 5 * 3,
        4 * (50 + 30 + 2 * 5 * 12)),
    # ids (6, 3), table (10, 4): min(18, 10) rows, the ids, the output
    "embedding_bag": (
        embedding_bag, embedding_bag_cuda, {},
        lambda: (_meta((6, 3), _I32), _meta((10, 4))),
        [((6, 4), torch.float32)], 6 * 3 * 4, 4 * (10 * 4 + 6 * 4 + 18)),
}


@pytest.mark.parametrize("name", sorted(META_ROUTERS))
def test_kernel_routers_on_meta_record_their_cost(name, monkeypatch):
    """A router given ``meta`` inputs returns ``meta`` outputs of the
    kernel's shapes and dtypes and reports the kernel's dense cost once
    to the counter; it never reaches the loader and launches nothing.
    The launcher itself refuses ``meta`` tensors."""
    router, launcher, kw, inputs, outs, flops, nbytes = META_ROUTERS[name]

    def no_library():
        raise AssertionError("a meta tensor reached the kernel loader")
    monkeypatch.setattr(loader, "library", no_library)
    before = launcher.launches
    with OpCounter() as c:
        got = router(*inputs(), **kw)
    got = got if isinstance(got, tuple) else (got,)
    assert [(tuple(t.shape), t.dtype) for t in got] == outs
    assert all(t.device.type == "meta" for t in got)
    assert c.kernels == {name: {"count": 1, "flops": float(flops),
                                "bytes": float(nbytes)}}
    assert launcher.launches == before
    with pytest.raises(ValueError, match="cuda"):
        launcher(*inputs(), **kw)
