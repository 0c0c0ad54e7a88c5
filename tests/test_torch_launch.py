"""The port's last three serve modes and its examples, on the CPU at a
reduced size.

``--slo``, ``--disagg`` and ``--overload`` run through an
``argparse.Namespace`` as the CLI would pass it: their own assertions
(greedy tokens equal across admission policies, disaggregated tokens
bit-equal to unified serving) hold, and every time they print on the
simulated clock says so.  ``examples/torch_quickstart.py`` and
``examples/torch_train_small.py`` run their ``main`` at tiny sizes.
The mechanisms under the modes are held to the JAX package in
``tests/test_torch_cluster.py``.
"""
import argparse
import importlib.util
import re
from pathlib import Path

import pytest
import torch

from repro_torch.launch import serve, train

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these are eager loops over small tensors, and
    with a thread a core several test workers on one machine
    oversubscribe it (the convergence loop ran ~40x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(**kw):
    base = dict(arch="qwen2.5-3b", d_model=64, device="cpu",
                dtype="float32", seed=0, requests=8, prompt=64, tokens=16,
                slots=4, nodes=12)
    return argparse.Namespace(**dict(base, **kw))


def _example(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _labelled(out: str, pattern: str) -> None:
    """Every line that prints a ``pattern`` time names its clock."""
    lines = [ln for ln in out.splitlines() if re.search(pattern, ln)]
    assert lines
    for ln in lines:
        assert "simulated clock" in ln, ln


def test_slo_mode(capsys):
    serve.run_slo(_args(nodes=6))
    out = capsys.readouterr().out
    assert "fcfs+independent" in out and "edf+arbiter" in out
    assert "greedy tokens bit-equal across both policies" in out
    _labelled(out, r"p99=")


def test_disagg_mode(capsys):
    serve.run_disagg(_args(requests=6, prompt=24, tokens=6, nodes=3))
    out = capsys.readouterr().out
    assert "bit-equal to unified" in out and "wall on cpu" in out
    assert re.search(r"prefills=6 exported=6", out)
    assert re.search(r"adopted=6 ", out)


def test_overload_mode(capsys):
    serve.run_overload(_args())
    out = capsys.readouterr().out
    assert "fcfs collapse" in out and "survival stack" in out
    assert re.search(r"audit: .*preempt=\d+.*shed=\d+", out)
    _labelled(out, r"p99=|t=\s*[\d.]+ms|over [\d.]+s")


def test_serve_cli_dispatches_the_new_modes(monkeypatch):
    seen = []
    for mode in ("slo", "disagg", "overload"):
        monkeypatch.setattr(serve, f"run_{mode}",
                            lambda a, m=mode: seen.append(m))
    for mode in ("slo", "disagg", "overload"):
        serve.main([f"--{mode}", "--device", "cpu"])
    assert seen == ["slo", "disagg", "overload"]


def test_quickstart_example(capsys):
    _example("torch_quickstart").main(["--device", "cpu", "--d-model", "64",
                                       "--tokens", "3"])
    out = capsys.readouterr().out
    assert "tensor-packed into" in out and "served 2 requests × 3" in out


def test_train_small_example(capsys):
    hist = _example("torch_train_small").main(
        ["--device", "cpu", "--d-model", "64", "--layers", "2", "--steps",
         "3", "--batch", "2", "--seq", "32"])
    assert len(hist) == 3
    out = capsys.readouterr().out
    assert "max logit diff = 0.0 (bit-exact)" in out


def test_train_cli(tmp_path, capsys):
    train.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq",
                "32", "--d-model", "64", "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert "done: 2 steps" in out
    assert (tmp_path / "blocks.npy").exists()
    if not torch.cuda.is_available():     # no --device: the GPU or a raise
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--steps", "1"])
