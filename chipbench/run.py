"""Run one cell of the port's benchmark on this machine's card.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the check's numbers beside their
limits as the last lines of standard error, and one JSON object as the
last line of standard output.  Exits 2 without a result when the card or
the program is missing, and 3 when the process holds JAX or the JAX
package once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from chipbench import harness

    try:
        cell = harness.load_cell(args.workload, ROOT)
    except (harness.RunError, OSError, KeyError, ValueError) as e:
        print(f"cannot load cell {args.workload!r}: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); this machine "
              f"has {have}", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"the program under test is missing: {e}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           dev, T_START)
    held = harness.forbidden_modules()
    if held:
        print(f"the run holds forbidden modules: {', '.join(held)}",
              file=sys.stderr)
        return 3
    print(out.window_line(), file=sys.stderr)
    if out.ctx.stacked is not None:
        seg = out.ctx.stacked
        print(f"trace: {len(seg.device)} device ops in the stacked segment,"
              f" {seg.unplaced} not placed on the host; {seg.py_events}"
              f" Python function events, {len(seg.frames)} of the program",
              file=sys.stderr)
    print(f"card: {harness.card_line()}", file=sys.stderr)
    for name, value, limit in out.check_rows:
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    print(f"check correct = {out.result['correct']}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
