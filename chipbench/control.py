"""The check's control and its faults, at a cell's own size on the card.

    python3 chipbench/control.py --workload <cell> --seeds <n> [<n> ...] \
        [--paths control|program|<fault> ...]

For each path named and each seed it answers the requests a run's check
compares (the first ``check_requests`` of the window's stream), judges
them as a run judges the program's, and prints one JSON line of the
numbers beside the cell's limits.  ``control`` (the default) puts the
reference with its matrix product in TF32 in the program's place and
builds no index; ``program`` runs the program as the window does, and a
fault of ``faults.py`` runs it with that fault planted, the index built
once for every seed.  A sound check reads ``correct`` false under the
control and every fault the cell can have, and true under ``program``.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_tally(cell, seed: int, dev, corpus=None, index=None,
                  search=None):
    """The judged numbers of one seed's checked requests: the control's
    answers, or, given the program's ``index`` (and ``search``, as
    ``harness.serve`` takes it), the program's."""
    from chipbench import harness, judge
    from chipbench.datagen import make_corpus
    from chipbench.traffic import WINDOW, Traffic
    corpus = corpus or make_corpus(cell.config["dataset"], dev)
    traffic = Traffic(cell.mix, corpus, seed)
    tally = judge.Tally()
    for i in range(int(cell.mix["check_requests"])):
        req = traffic.request(WINDOW, i)
        exact = harness.reference_answer(corpus, req, traffic.k)
        if index is None:
            ans = harness.reference_answer(corpus, req, traffic.k,
                                           control=True)
            ids, dists = ans.ids, ans.dists
            routes = [traffic.route or "prefilter"] * traffic.batch
        else:
            got = harness.serve(index, traffic, req, search)
            ids, dists, routes = got.ids, got.dists, got.routes
        judge.judge_request(tally, req.xq, req.tree, corpus, ids, dists,
                            routes, exact, traffic.k)
    return tally


def main(argv=None) -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chipbench.faults import FAULTS
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--paths", nargs="+", default=["control"],
                    choices=["control", "program", *FAULTS])
    args = ap.parse_args(argv)
    import torch

    from chipbench import harness, judge
    from chipbench.datagen import make_corpus
    cell = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    corpus = make_corpus(cell.config["dataset"], dev)
    index = None
    if set(args.paths) - {"control"}:
        from repro_torch.kernels import loader
        loader.library()
        index = harness.build_index(cell, corpus, dev)
    for path in args.paths:
        on = None if path == "control" else index
        search = FAULTS[path](index) if path in FAULTS else None
        for seed in args.seeds:
            tally = control_tally(cell, seed, dev, corpus, on, search)
            ok, rows = judge.verdict(tally, cell.limits, 0)
            print(json.dumps({"workload": cell.name, "path": path,
                              "seed": seed, "correct": ok,
                              "recall": tally.recall,
                              "check": {n: {"value": v, "limit": lim}
                                        for n, v, lim in rows}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
