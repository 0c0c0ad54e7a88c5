"""The plain reference against the port's ``models.forward`` on reduced
starcoder2-3b and stablelm-1.6b in float32 on the CPU, on the weights the
benchmark makes (biases and norms random, so every one of them counts)."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from portbench import harness, weights
from portbench.reference import load
from repro_torch.models import forward

ROOT = Path(__file__).resolve().parents[2]


def reduced(name):
    conf = json.loads((ROOT / f"portbench/configs/{name}.json").read_text())
    pub, prog = conf["published"], conf["program"]
    heads, kv = 4, (4 if pub["num_key_value_heads"] == pub[
        "num_attention_heads"] else 2)
    pub.update(vocab_size=300, hidden_size=64, intermediate_size=96,
               num_hidden_layers=2, num_attention_heads=heads,
               num_key_value_heads=kv)
    prog.update(vocab_size=300, d_model=64, d_ff=96, n_layers=2,
                n_heads=heads, n_kv_heads=kv, d_head=16)
    if pub.get("sliding_window"):
        pub["sliding_window"] = prog["window"] = 24
    return conf


@pytest.mark.parametrize("name", ["starcoder2-3b", "stablelm-1.6b"])
def test_reference_matches_forward_fp32(name):
    conf = reduced(name)
    cfg = harness.model_config(conf)
    params = weights.make(cfg, 2**31 + 9, "cpu", dtype=torch.float32)
    tokens = torch.randint(0, 300, (1, 57),
                           generator=torch.Generator().manual_seed(1))
    got = forward(cfg, params, {"tokens": tokens}, moe_cf=None,
                  kernel_impl="plain")["logits"][0]
    ref = load(conf["reference"])(conf["published"], params).logits(
        tokens[0], 0)
    assert ref.shape == got.shape
    torch.testing.assert_close(ref, got, rtol=1e-4, atol=1e-4)
    tail = load(conf["reference"])(conf["published"], params).logits(
        tokens[0], 40)
    torch.testing.assert_close(tail, ref[40:], rtol=1e-5, atol=1e-5)
    side = load(conf["reference"])(conf["published"], params)
    cached = side.logits(tokens[0], 40, side.prefix(tokens[0, :30]))
    torch.testing.assert_close(cached, ref[40:], rtol=1e-5, atol=1e-5)


def test_fp8_control_departs_from_fp32():
    conf = reduced("starcoder2-3b")
    cfg = harness.model_config(conf)
    params = weights.make(cfg, 4, "cpu", dtype=torch.float32)
    toks = torch.arange(40) % 300
    ref = load("dense")(conf["published"], params)
    ctl = load("dense")(conf["published"], params, "fp8")
    d = (ref.logits(toks, 0) - ctl.logits(toks, 0)).abs().max().item()
    assert 1e-3 < d < 1.0
