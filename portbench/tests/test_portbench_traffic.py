"""The generator gives the same requests for the same seed, and the same
sizes and arrival gaps, in another order, for another seed."""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from portbench import gen

MIXES = sorted((Path(__file__).resolve().parents[1] / "traffic").glob("*.json"))
SECONDS = 20.0


def _requests(mix, seed, n_closed=40):
    t = gen.Traffic(mix, seed, 49152, SECONDS)
    if mix["loop"] == "open":
        return t.schedule
    c = mix["clients"]
    return ([t.next_closed(k, "wave") for k in range(c)]
            + [t.next_closed(k % c) for k in range(n_closed)])


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_same_seed_same_requests(path):
    mix = json.loads(path.read_text())
    a, b = _requests(mix, 2**31 + 77), _requests(mix, 2**31 + 77)
    assert [(r.prompt, r.max_new, r.due, r.phase) for r in a] == \
        [(r.prompt, r.max_new, r.due, r.phase) for r in b]
    c = _requests(mix, 5)
    assert [r.prompt for r in a] != [r.prompt for r in c]


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_other_seed_same_work(path):
    mix = json.loads(path.read_text())
    cap = gen.max_len(mix)
    if mix["loop"] == "open":
        runs = [gen.Traffic(mix, s, 100, SECONDS).schedule for s in (1, 99)]
        assert [(len(r.prompt), r.max_new, r.due, r.phase, r.tenant)
                for r in runs[0]] == [(len(r.prompt), r.max_new, r.due,
                                       r.phase, r.tenant) for r in runs[1]]
        for r in runs[0]:
            lo, hi = ((-mix["lead_in_s"], 0.0) if r.phase == "lead"
                      else (0.0, SECONDS))
            assert lo <= r.due < hi
            assert len(r.prompt) + r.max_new <= cap
    else:
        c = mix["clients"]
        seqs = []
        for s in (1, 99):
            t = gen.Traffic(mix, s, 100, SECONDS)
            seqs.append(sorted(
                tuple((len(r.prompt), r.max_new) for r in
                      [t.next_closed(k, "wave")]
                      + [t.next_closed(k) for _ in range(5)])
                for k in range(c)))
        assert seqs[0] == seqs[1]          # the same sequences, dealt anew
        for r in _requests(mix, 3):
            assert len(r.prompt) + r.max_new <= cap and r.max_new >= 1


def test_shared_prefix_prompts_open_with_a_system_prompt():
    mix = json.loads((MIXES[0].parent / "shared-prefix.json").read_text())
    t = gen.Traffic(mix, 11, 1000, SECONDS)
    n = mix["prefix"]["tokens"]
    for r in t.schedule[:50]:
        assert r.prompt[:n] == t.system_prompt(r.tenant)
        assert mix["prompt"]["min"] <= len(r.prompt) - n <= mix["prompt"]["max"]
    tenants = Counter(r.tenant for r in t.schedule)
    assert tenants.most_common(1)[0][0] == 0       # Zipf: tenant 0 leads


def test_lengths_are_clipped_log_normal():
    rng = np.random.default_rng(0)
    x = gen.lengths({"median": 600, "sigma": 0.6, "min": 256, "max": 2048},
                    20000, rng)
    assert x.min() >= 256 and x.max() <= 2048
    assert 570 <= np.median(x) <= 630
