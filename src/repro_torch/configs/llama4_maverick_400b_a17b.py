"""Llama-4-Maverick-400B-A17B — MoE 128e top-1 + shared, interleaved
dense/MoE FFNs, chunked-local attention (8192) with a global layer every 4
[hf:meta-llama/Llama-4-Scout-17B-16E].

Early fusion is stubbed through the same patch-embedding path as the VLM
family (optional; text-only by default). For long_500k the global
(attn_full) layers fall back to windowed cache — see DESIGN.md §8.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
        d_ff=16384, vocab_size=202_048,
        layer_pattern=("attn:dense", "attn:moe", "attn:dense", "attn_full:moe"),
        norm="rms", act="silu", rope_theta=500_000.0, window=8192,
        n_experts=128, top_k=1, n_shared_experts=1,
        expert_d_ff=8192, shared_expert_d_ff=8192,
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )
