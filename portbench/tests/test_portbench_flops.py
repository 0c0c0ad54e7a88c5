"""The frozen formulas against counts by hand and by brute force."""
from __future__ import annotations

import pytest
import torch

from portbench import flops
from repro_torch.configs.base import ModelConfig


def cfg(**kw):
    base = dict(arch_id="t", family="dense", n_layers=2, d_model=8, n_heads=4,
                n_kv_heads=2, d_head=2, d_ff=16, vocab_size=10,
                act="gelu", window=None)
    base.update(kw)
    return ModelConfig(**base)


def test_matmul_params_by_hand():
    # q 8x8, k 8x4, v 8x4, o 8x8 = 192; MLP 2 x 8x16 = 256
    assert flops.layer_matmul_params(cfg()) == 192 + 256
    assert flops.layer_matmul_params(cfg(act="silu")) == 192 + 384


@pytest.mark.parametrize("window", [None, 3])
def test_causal_pairs_brute_force(window):
    for start in range(6):
        for n in range(1, 9):
            want = sum(min(p + 1, window or p + 1)
                       for p in range(start, start + n))
            assert flops.causal_pairs(start, n, window) == want


def test_decode_and_prefill_by_hand():
    c = cfg()
    per_tok = 2 * (2 * 448 + 8 * 10)
    # two slots with 3 and 5 keys: attention 4 * keys * H * dh per layer
    assert flops.decode_flops(c, [3, 5]) == 2 * per_tok + 2 * 4 * 8 * 8
    # 3 tokens from position 2: keys 3 + 4 + 5
    assert flops.prefill_flops(c, 3, 2) == (2 * 3 * 2 * 448 + 2 * 8 * 10
                                            + 2 * 4 * 12 * 8)


def test_paged_decode_cost_matches_the_kernel_table_formula():
    c = cfg(n_heads=16, n_kv_heads=2, d_head=128, d_model=2048)
    lens = torch.tensor([100, 7, 1000])
    ps, esz, B, KVH, H, dh = 16, 2, 3, 2, 16, 128
    stored = int((lens - 1).clamp(min=0).sum())
    # chip_smoke.py, _time_paged_step
    n_bytes = (2 * stored * KVH * dh * esz + 2 * B * H * dh * esz
               + 4 * B * KVH * dh * esz
               + sum(-(-int(n) // ps) for n in lens) * 4 + B * 4)
    got = flops.paged_decode_cost(c, lens.tolist(), ps)
    assert got == {"bytes": n_bytes, "flops": 4 * (stored + B) * H * dh}


def test_flash_cost_matches_the_kernel_table_formula():
    c = cfg(n_heads=32, n_kv_heads=32, d_head=64, d_model=2048)
    S = 512
    pairs = sum(i + 1 for i in range(S))
    # chip_smoke.py, _time_flash (B = 1)
    want = {"bytes": 2 * (2 * 32 * S * 64 + 2 * 32 * S * 64),
            "flops": 4 * pairs * 64 * 32}
    assert flops.flash_cost(c, S) == want


def test_bound_takes_the_slower_roof():
    peaks = {"bf16_flops": 1e12, "hbm_bytes_per_s": 1e9}
    assert flops.bound_s({"flops": 2e12, "bytes": 1e9}, peaks) == 2.0
    assert flops.bound_s({"flops": 1e11, "bytes": 3e9}, peaks) == 3.0
