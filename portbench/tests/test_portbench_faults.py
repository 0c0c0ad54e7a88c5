"""The check that decides ``correct`` has to fail: the harness driven end
to end on the CPU (the look for a card skipped) on the tiny cells, sound,
with its float8 control, and with the timed path broken underneath in each
way a serving cell can break: a decode step that leaves its state (the
K/V pages) unchanged, half of the batch left out of the decode step, and a
token altered where it is produced.  The tiny cells live in a throwaway
root that adds a configuration, two mixes and a per-layer metric as new
files and entries only."""
from __future__ import annotations

import pytest
import torch

import tiny
from portbench import harness

SEED = 3


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, **kw):
    return harness.run_cell(root, cell, SEED, 1.5, False, device="cpu", **kw)


@pytest.mark.parametrize("cell", ["tiny.tiny-closed", "tiny.tiny-open"])
def test_sound_run_is_correct_and_control_is_not(root, cell):
    out = _run(root, cell, control=True)
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["run"]["control_gap"] > tiny.TINY_LIMIT["max_gap"]
    assert list(out)[-1] == "check"
    assert {"output_tok_per_s", "itl_p95_ms", "setup_s"} <= set(
        out["metrics"])


def test_traced_run_reports_the_new_metric(root):
    out = harness.run_cell(root, "tiny.tiny-closed", SEED, 1.5, True,
                           device="cpu")
    assert out["correct"]
    assert "tokens_per_tick" in out["metrics"]
    assert "slot_occupancy_pct.batch" in out["metrics"]


def _keep_pages(orig):
    def step(q, k_new, v_new, k_pages, v_pages, *a, **kw):
        return orig(q, k_new, v_new, k_pages.clone(), v_pages.clone(),
                    *a, **kw)
    return step


def _half_batch(orig):
    def step(cfg, params, cache, tokens, **kw):
        logits = orig(cfg, params, cache, tokens, **kw)
        logits[1::2] = 0                # every other slot left out
        return logits
    return step


def _altered(orig):
    def body(self):
        logits = orig(self)
        self._tok.add_(1).remainder_(logits.shape[-1])
        return logits
    return body


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
@pytest.mark.parametrize("cell", ["tiny.tiny-closed", "tiny.tiny-open"])
def test_broken_timed_path_is_not_correct(root, cell, fault, monkeypatch):
    import repro_torch.models.layers as layers
    import repro_torch.serving.engine as engine
    if fault == "state_unchanged":
        monkeypatch.setattr(layers, "paged_decode_step",
                            _keep_pages(layers.paged_decode_step))
    elif fault == "half_batch":
        monkeypatch.setattr(engine, "decode_step_inplace",
                            _half_batch(engine.decode_step_inplace))
    else:
        cls = engine.ContinuousBatchingEngine
        monkeypatch.setattr(cls, "_decode_body", _altered(cls._decode_body))
    out = _run(root, cell)
    assert not out["correct"], out["check"]


def test_forbidden_modules_stop_the_run(root, monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(harness.ForbiddenModules):
        _run(root, "tiny.tiny-open")
    assert torch.get_default_dtype() == torch.float32
