"""Qwen2-MoE-A2.7B — MoE: 60 routed top-4 + 4 shared experts, MHA
[hf:Qwen/Qwen1.5-MoE-A2.7B].

60 experts do not divide the 16-way model axis; expert d_ff (1408) is
sharded instead (see repro_torch.distributed.sharding).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen2-moe-a2.7b", family="moe",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
        d_ff=0, vocab_size=151_936,
        layer_pattern=("attn:moe",),
        norm="rms", act="silu", qkv_bias=True,
        n_experts=60, top_k=4, n_shared_experts=4,
        expert_d_ff=1408, shared_expert_d_ff=5632,
        source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    )
