"""Find an open-loop cell's knee: the highest Poisson rate at which the
engine's backlog does not grow over the window.

    python3 portbench/knee.py --workload <cell> --rates 10,15,20 \
        --seconds 15 --seed 5

Runs the cell once a rate, in one process, each with the mix's ``rate``
replaced, and prints the queue's median length in the window's first and
last quarter beside the tails.  The cell's rate (about 0.8 of the knee) is
then written into its traffic file by hand; no run searches for a rate.
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
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=15)
    ap.add_argument("--seed", type=int, default=5)
    a = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import harness
    out_dir = ROOT / "chiprun_out" / "portbench"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"knee-{a.workload}.jsonl", "a") as f:
        for rate in (float(r) for r in a.rates.split(",")):
            res = harness.run_cell(ROOT, a.workload, a.seed, a.seconds,
                                   False, mix_override={"rate": rate})
            row = {"rate": rate, "attempted": res["attempted"],
                   "correct": res["correct"],
                   **{k: v["value"] for k, v in res["metrics"].items()},
                   **res["run"]}
            f.write(json.dumps(row) + "\n")
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
