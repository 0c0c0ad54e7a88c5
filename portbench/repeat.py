"""Run one cell several times in a row, one process a run, and keep every
result line: the runs that a cell's bounds are measured from.

    python3 portbench/repeat.py --workload <cell> --seeds 11,12,13 \
        --seconds 20 [--trace 0|1] [--tag name]

Each run is ``portbench/run.py`` in a process of its own.  The result lines
(with the end of each run's standard error) go to
``chiprun_out/portbench/<tag>.jsonl``; a summary (each end-to-end metric's
values, median and spread, ``correct`` and ``setup_s``) is printed at the
end.
"""
from __future__ import annotations

import sys

del sys.path[0]           # no module of portbench/ shadows a top-level one

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.stats import spread  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--tag", default="")
    ap.add_argument("--timeout", type=float, default=1200)
    a = ap.parse_args()
    out_dir = ROOT / "chiprun_out" / "portbench"
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = a.tag or f"{a.workload}.t{a.trace}"
    lines = []
    with open(out_dir / f"{tag}.jsonl", "a") as f:
        for seed in a.seeds.split(","):
            t0 = time.perf_counter()
            cmd = [sys.executable, str(ROOT / "portbench" / "run.py"),
                   "--workload", a.workload, "--seed", seed, "--seconds",
                   str(a.seconds), "--trace", str(a.trace)]
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                               timeout=a.timeout)
            wall = time.perf_counter() - t0
            last = p.stdout.strip().splitlines()[-1:] or [""]
            try:
                res = json.loads(last[0])
            except json.JSONDecodeError:
                res = None
            rec = {"seed": int(seed), "rc": p.returncode, "wall_s": wall,
                   "result": res, "stderr_tail": p.stderr[-3000:]}
            f.write(json.dumps(rec) + "\n")
            f.flush()
            lines.append(rec)
            short = ({k: round(v["value"], 4)
                      for k, v in res["metrics"].items()} if res else None)
            print(f"[{tag}] seed {seed} rc {p.returncode} wall {wall:.1f}s "
                  f"correct {res and res['correct']} {short} "
                  f"check {res and {k: v['value'] for k, v in res['check'].items()}}"
                  f" run {res and {k: v for k, v in res['run'].items() if k != 'stats'}}",
                  flush=True)
            if not res:
                print(p.stderr[-4000:], flush=True)
    ok = [r["result"] for r in lines if r["result"]]
    names = sorted({k for r in ok for k in r["metrics"]})
    for k in names:
        vals = [r["metrics"][k]["value"] for r in ok if k in r["metrics"]]
        if len(vals) >= 2:
            sp = spread(vals) if len(vals) >= 2 else float("nan")
            print(f"[{tag}] {k}: median {statistics.median(vals):.6g} "
                  f"spread {sp:.4f} values {[round(v, 5) for v in vals]}",
                  flush=True)
    return 0 if len(ok) == len(lines) else 1


if __name__ == "__main__":
    sys.exit(main())
