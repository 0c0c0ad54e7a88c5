"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the result as one JSON object on the
last line of standard output, and each number the correctness check
compared, beside its limit, as the last lines of standard error.  Exits
with another code than 0, and prints no result, when the card the cell
asks for is missing, or when the process holds JAX or the JAX package
once the window has closed.
"""
import sys
import time

T_PROCESS = time.perf_counter()
# the harness's modules are imported as ``portbench.*`` only: none of them
# may shadow a top-level module of the same name
del sys.path[0]

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"


def _environment() -> None:
    """Every cache the program or its libraries keep lives at a fixed path
    inside the checkout; no library may load JAX on its own; the process
    keeps to one CPU thread for its own operators."""
    os.environ.update({
        "TRITON_CACHE_DIR": str(CACHE / "triton"),
        "TORCH_EXTENSIONS_DIR": str(CACHE / "torch_extensions"),
        "TORCHINDUCTOR_CACHE_DIR": str(CACHE / "inductor"),
        "REPRO_CACHE_DIR": str(CACHE / "repro"),
        "REPRO_AUTOTUNE_CACHE": str(CACHE / "repro" / "autotune.json"),
        "USE_FLAX": "0", "USE_JAX": "0",
        # one process, few threads: the host's work is the engine's Python
        "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"})
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next((w["chips"] for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    from portbench import harness
    try:
        out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                               bool(args.trace), t_process=T_PROCESS)
    except harness.ForbiddenModules as e:
        print(str(e), file=sys.stderr)
        return 3
    out["card"] = _power_limit()
    check = out.pop("check")
    out["check"] = check                         # the last key of the line
    sys.stdout.flush()
    for name, v in check.items():
        print(f"check {name}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
