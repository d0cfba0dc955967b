#!/usr/bin/env python3
"""Run one cell of the benchmark of ``repro_torch`` on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown`` where the
profiler saw the device, and last ``checks``: each compared number
beside its limit, which also end standard error.  Exits with another
code than 0, and prints no result, without a CUDA card (or with fewer
than the cell asks for), when the port cannot be imported, or when JAX
or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness

    cell = harness.load_json(ROOT / "bench" / "workloads"
                             / f"{args.workload}.json")
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"error: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    os.environ.update(harness.cache_env(ROOT))
    for var in harness.PROGRAM_ENV:
        os.environ.pop(var, None)

    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"error: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
