"""The frozen generators and the general request generator."""
import json

import numpy as np
import torch

from chipbench import judge
from chipbench.datagen import make_corpus
from chipbench.reference.predicates import mask_over
from chipbench.traffic import WARMUP, WINDOW, Traffic

from conftest import ROOT, tiny_cell

CPU = torch.device("cpu")


def test_lcps_labels_are_balanced():
    cell = tiny_cell("sift1m-lcps.graph")
    p = dict(cell.config["dataset"], n=12 * 250 + 5)
    c = make_corpus(p, CPU)
    counts = torch.bincount(c.int_cols["label"].long(), minlength=p["card"])
    assert counts.max() - counts.min() <= 1
    assert c.x.shape == (p["n"], 128) and c.x.dtype == torch.float32


def test_corpus_repeats_and_requests_follow_the_seed():
    cell = tiny_cell("tripclick-hcps.selective")
    seed = 2**31 + 12345
    a = make_corpus(cell.config["dataset"], CPU)
    b = make_corpus(cell.config["dataset"], CPU)
    assert torch.equal(a.x, b.x)
    assert torch.equal(a.bitset_cols["keywords"], b.bitset_cols["keywords"])
    ra = Traffic(cell.mix, a, seed).request(WINDOW, 5)
    rb = Traffic(cell.mix, b, seed).request(WINDOW, 5)
    assert torch.equal(ra.xq, rb.xq)
    assert repr(ra.tree) == repr(rb.tree)
    other = Traffic(cell.mix, a, seed).request(WARMUP, 5)
    assert not torch.equal(ra.xq, other.xq)
    assert not torch.equal(ra.xq, Traffic(cell.mix, a, 7).request(WINDOW, 5).xq)


def test_hcps_keywords_follow_clusters():
    cell = tiny_cell("tripclick-hcps.selective")
    p = cell.config["dataset"]
    c = make_corpus(p, CPU)
    assert c.cluster_keywords.shape == (p["clusters"], p["kw_per_cluster"])
    assert all(len(set(r)) == p["kw_per_cluster"] for r in c.cluster_keywords)
    bits = c.bitset_cols["keywords"][:, 0].numpy().view(np.uint32)
    for row in range(0, c.n, 97):
        for kw in c.cluster_keywords[c.cluster_of[row]]:
            assert bits[row] >> np.uint32(kw) & 1
    extra = [bin(int(v)).count("1") for v in bits]
    share = np.mean(np.array(extra) > p["kw_per_cluster"])
    assert 0.35 < share < 0.55      # one noise keyword on half the rows,
    #                                 some of which the cluster holds already


def test_selective_mix_falls_below_the_routers_threshold():
    """By the reference's count, at a small n with the config's own
    keyword and date parameters: s << 1/gamma."""
    cell = tiny_cell("tripclick-hcps.selective")
    p = dict(cell.config["dataset"], n=32768, clusters=128)
    c = make_corpus(p, CPU)
    t = Traffic(cell.mix, c, 11)
    sel = []
    for i in range(4):
        r = t.request(WINDOW, i)
        col = {**c.int_cols, **c.bitset_cols}
        m = mask_over(r.tree, col.__getitem__, t.batch, c.n, CPU)
        sel.append(m.float().mean(1))
    s = torch.cat(sel)
    assert float(s.max()) < 1.0 / cell.config["index"]["gamma"]
    assert 0.005 < float(s.mean()) < 0.02       # ~0.115 * 11 / 120


def test_cells_and_their_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = tiny_cell(w["name"])
        assert cell.mix["k"] == 10
        assert set(cell.limits) <= set(judge.NUMBERS)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (ROOT / "chipbench" / "metrics" / f"{m['name']}.py").exists()


def test_benchmark_json_keeps_to_its_schema():
    import re
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    line = re.compile(r"^[^\n\t]{1,200}$")
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert name.match(c["name"]) and line.match(c["source"])
        assert (ROOT / c["file"]).exists()
    assert len({c["source"] for c in bench["configs"]}) == len(
        bench["configs"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert name.match(w["name"]) and line.match(w["why"])
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert line.match(m["layer"])
    for m in metrics:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(bench)) < 64 * 1024
