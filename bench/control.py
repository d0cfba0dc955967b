#!/usr/bin/env python3
"""Readings for the limits of a cell's compared numbers, in one process
on the card (the benchmark's own runs do not run this):

    python3 bench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--faults stale,half,altered] --seconds 1.5

For each seed of ``--seeds`` a run of the program, for each of
``--control-seeds`` a run with the control (the reference in bfloat16)
in the program's place, and for each fault of ``--faults`` a run per
control seed with that fault planted (``faults.py``): each a short
window at the cell's own size and load, judged as a benchmark run is.
Prints one JSON line per run and a summary (the largest reading of the
program, the smallest of the control and of each fault, per number);
``--out`` also writes them to a file.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=1.5)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import faults, harness

    os.environ.update(harness.cache_env(ROOT))
    for var in harness.PROGRAM_ENV:
        os.environ.pop(var, None)
    plan = [("program", s, None) for s in args.seeds]
    plan += [("control", s, faults.control) for s in args.control_seeds]
    for kind in filter(None, args.faults.split(",")):
        plan += [(kind, s, faults.planted(kind)) for s in args.control_seeds]
    lines, worst = [], {}
    for what, seed, lower in plan:
        t = time.perf_counter()
        out = harness.run(args.workload, seed, args.seconds, False,
                          t_start=t, lower=lower)
        line = {"what": what, "seed": seed, "correct": out["correct"],
                "attempted": out["attempted"],
                "checks": {k: c["value"] for k, c in out["checks"].items()},
                "s": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        lines.append(line)
        for k, v in line["checks"].items():
            key = (what, k)
            pick = max if what == "program" else min
            worst[key] = v if key not in worst else pick(worst[key], v)
    summary = {f"{w}.{k}": v for (w, k), v in sorted(worst.items())}
    print(json.dumps({"summary": summary,
                      "device": out["device"] if plan else None}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"workload": args.workload, "runs": lines, "summary": summary})
            + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
