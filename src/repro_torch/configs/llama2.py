"""Llama-2 7B/13B/70B — the paper's own evaluation models [arXiv:2307.09288].

Used by the serving simulator and the multicast benchmarks to reproduce the
paper's Figs 7-18 (block counts, scaling latencies, trace replay).
"""
from repro_torch.configs.base import ModelConfig


def llama2_7b() -> ModelConfig:
    return ModelConfig(
        arch_id="llama2-7b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_head=128,
        d_ff=11008, vocab_size=32_000,
        layer_pattern=("attn:dense",), norm="rms", act="silu",
        source="arXiv:2307.09288",
    )


def llama2_13b() -> ModelConfig:
    return ModelConfig(
        arch_id="llama2-13b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=40, d_head=128,
        d_ff=13824, vocab_size=32_000,
        layer_pattern=("attn:dense",), norm="rms", act="silu",
        source="arXiv:2307.09288",
    )


def llama2_70b() -> ModelConfig:
    return ModelConfig(
        arch_id="llama2-70b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=28672, vocab_size=32_000,
        layer_pattern=("attn:dense",), norm="rms", act="silu",
        source="arXiv:2307.09288",
    )


def config() -> ModelConfig:   # default for --arch llama2-7b style lookups
    return llama2_7b()
