"""A throwaway benchmark root for the CPU tests: a copy of ``portbench/``
and ``BENCHMARK.json`` with a tiny dense configuration and two tiny mixes
added as new files and new entries, and nothing else edited."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# the tiny cells' limit, set from CPU runs of 16 sampled requests on seeds
# 0-9 of each cell: sound runs' widest gap 0 to 0.0072, their float8
# control's 0.038 to 0.081
TINY_LIMIT = {"max_gap": 0.015, "min_tokens": 50}


def make_root(tmp: Path) -> Path:
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((ROOT / "portbench/configs/starcoder2-3b.json")
                      .read_text())
    conf["published"].update(vocab_size=512, hidden_size=96,
                             intermediate_size=192, num_hidden_layers=3,
                             num_attention_heads=6, num_key_value_heads=2,
                             sliding_window=48)
    conf["program"].update(vocab_size=512, d_model=96, d_ff=192, n_layers=3,
                           n_heads=6, n_kv_heads=2, d_head=16, window=48)
    conf["engine"].update(n_slots=4, n_pages=48)
    (tmp / "portbench/configs/tiny.json").write_text(json.dumps(conf))
    mixes = {
        "tiny-closed": {"loop": "closed", "clients": 4, "warm_start": True,
                        "prompt": {"median": 40, "sigma": 0.5, "min": 16,
                                   "max": 64},
                        "output": {"median": 16, "sigma": 0.5, "min": 8,
                                   "max": 32},
                        "check": {"requests": 16}},
        "tiny-open": {"loop": "open", "rate": 20.0, "lead_in_s": 0.3,
                      "prefix": {"count": 2, "tokens": 32, "zipf_s": 1.1},
                      "prompt": {"median": 20, "sigma": 0.5, "min": 8,
                                 "max": 48},
                      "output": {"median": 12, "sigma": 0.5, "min": 4,
                                 "max": 24},
                      "check": {"requests": 16}}}
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    for mix, spec in mixes.items():
        (tmp / f"portbench/traffic/{mix}.json").write_text(json.dumps(spec))
        cell = f"tiny.{mix}"
        bench["workloads"].append({"name": cell, "config": "tiny",
                                   "traffic": mix, "chips": 1,
                                   "why": "CPU tests"})
        (tmp / f"portbench/limits/{cell}.json").write_text(
            json.dumps(TINY_LIMIT))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m:
                m["workloads"].append(cell)
    # a new per-layer metric is a new reader file and a new entry
    (tmp / "portbench/metrics/tokens_per_tick.py").write_text(
        "def read(r):\n"
        "    d = r.stats_close['decode_ticks'] - r.stats_open['decode_ticks']\n"
        "    t = r.stats_close['decode_tokens'] - r.stats_open['decode_tokens']\n"
        "    return t / d if d else None\n")
    bench["per_layer"].append({"name": "tokens_per_tick", "unit": "tokens",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "engine and scheduler",
                               "moves": "itl_p95_ms",
                               "workloads": ["tiny.tiny-closed",
                                             "tiny.tiny-open"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
