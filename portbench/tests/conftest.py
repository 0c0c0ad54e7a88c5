import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
# one thread, as ``run.py`` gives a run: the tiny cells' windows are host
# time, and threads beyond the cores' share stall their steps
torch.set_num_threads(1)
