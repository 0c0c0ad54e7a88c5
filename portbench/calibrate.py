"""Readings that the correctness limits are set from: the program's widest
gap on many seeds and, on the same sampled requests, the control's (the
reference in float8 e4m3, the step below the configurations' bfloat16).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 10 [--control 1]

One process runs the seeds one after another, each a whole run of the cell
(weights from its seed, set-up, a window at the cell's own load, the
check).  Each seed's readings go to
``chiprun_out/portbench/calibrate-<cell>.jsonl`` and to standard output.
"""
from __future__ import annotations

import sys

del sys.path[0]           # no module of portbench/ shadows a top-level one

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--control", type=int, default=1)
    a = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import harness
    out_dir = ROOT / "chiprun_out" / "portbench"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"calibrate-{a.workload}.jsonl", "a") as f:
        for seed in (int(s) for s in a.seeds.split(",")):
            res = harness.run_cell(ROOT, a.workload, seed, a.seconds, False,
                                   control=bool(a.control))
            row = {"seed": seed, "correct": res["correct"],
                   "max_gap": res["check"]["max_gap"]["value"],
                   "served_tokens": res["check"]["served_tokens"]["value"],
                   "control_gap": res["run"]["control_gap"],
                   "ref_s": res["run"]["ref_s"],
                   "metrics": {k: v["value"]
                               for k, v in res["metrics"].items()}}
            f.write(json.dumps(row) + "\n")
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
