"""The readings a cell's limits are set from, at the cell's own size.

    python3 kgbench/calibrate.py --workload <cell> --seeds 1,2,3
        [--modes program,control,<fault>...] [--seconds 1]

runs the cell once per seed and mode in one process and prints one JSON
line each with its compared numbers: ``program`` is the port as the
benchmark runs it, ``control`` the lower precision the workload file
names (the port's own path, or the reference put in its place), and a
fault name one of the traffic module's ``FAULTS``, planted under the
timed path. A cell's limit lies above the largest ``program`` reading and
below the smallest reading of the control and of each fault that fails
it (PERF.md gives the readings). The benchmark's own runs never run
this."""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

from kgbench.harness import execute  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program,control")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    for mode in args.modes.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            kw = {"control": True} if mode == "control" else (
                {} if mode == "program" else {"faults": (mode,)})
            t0 = time.time()
            rec = execute(args.workload, seed, args.seconds, False,
                          "cuda:0", **kw)
            notes = rec["_notes"]
            print(json.dumps({
                "cell": args.workload, "mode": mode, "seed": seed,
                "checks": {k: v["value"] for k, v in rec["checks"].items()},
                "readings": notes["checks"].get("norms"),
                "correct": rec["correct"], "units": notes["units"],
                "metrics": {k: v["value"] for k, v in rec["metrics"].items()},
                "peak": rec["device"]["memory_peak_bytes"],
                "seconds": round(time.time() - t0, 2)}), flush=True)


if __name__ == "__main__":
    main()
