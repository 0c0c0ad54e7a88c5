"""One short run of a cell on the card through its command: the result
line, ``correct`` and the numbers compared.  Needs a CUDA device."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.gpu
def test_run_py_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "starcoder2-3b.shared-prefix", "--seed", "2147483659",
                        "--seconds", "5", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and list(out)[-1] == "check"
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
