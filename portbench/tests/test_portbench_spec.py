"""``BENCHMARK.json`` and the files it names keep to the benchmark's
contract: names, units and the other strings in their alphabets, every
file the harness looks up by name present, every per-layer metric reported
with the end-to-end metric it moves, and each configuration's program
fields equal to its published sizes."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source", "workloads"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert len(BENCH["command"]) <= 32 and all(_line(w)
                                               for w in BENCH["command"])
    assert (ROOT / BENCH["command"][1]).exists()
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_strings():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"]) and _line(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in BENCH["workloads"]:
        cell = w["name"]
        mine = [m for m in BENCH["end_to_end"] if _reports(m, cell)]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(_reports(m, cell) for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads",
                          [w["name"] for w in BENCH["workloads"]]):
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)


def test_files_found_by_name():
    cells = {w["name"] for w in BENCH["workloads"]}
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
    for w in BENCH["workloads"]:
        assert (ROOT / "portbench/traffic" / f"{w['traffic']}.json").exists()
        limits = json.loads((ROOT / "portbench/limits"
                             / f"{w['name']}.json").read_text())
        assert limits["max_gap"] > 0 and limits["min_tokens"] > 0
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "portbench/metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", cells)) <= cells


# published key -> (program field, conversion)
SAME = {"vocab_size": "vocab_size", "hidden_size": "d_model",
        "intermediate_size": "d_ff", "num_hidden_layers": "n_layers",
        "num_attention_heads": "n_heads",
        "num_key_value_heads": "n_kv_heads",
        "rope_theta": "rope_theta", "tie_word_embeddings": "tie_embeddings",
        "sliding_window": "window"}


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_program_fields_are_the_published_sizes(entry):
    conf = json.loads((ROOT / entry["file"]).read_text())
    pub, prog = conf["published"], conf["program"]
    assert conf["source"] == entry["source"] and entry["reduced"] == []
    for k, field in SAME.items():
        assert pub.get(k) == prog[field], k
    assert prog["d_head"] * prog["n_heads"] == pub["hidden_size"]
    assert prog["act"] == {"silu": "silu",
                           "gelu_pytorch_tanh": "gelu"}[pub["hidden_act"]]
    assert prog["norm"] == "ln"
    assert prog["norm_eps"] == pub.get("norm_epsilon",
                                       pub.get("layer_norm_eps"))
    assert prog["rope_pct"] == pub.get("partial_rotary_factor", 1.0)
    bias = pub.get("use_bias", False)
    assert prog["qkv_bias"] == (bias or pub.get("use_qkv_bias", False))
    assert prog["mlp_bias"] == bias and prog["out_bias"] == bias
    assert pub["torch_dtype"] == "bfloat16"
