"""Qwen2.5-3B — dense, GQA(kv=2), QKV bias, tied embeddings [hf:Qwen/Qwen2.5-0.5B]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen2.5-3b", family="dense",
        n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_head=128,
        d_ff=11008, vocab_size=151_936,
        layer_pattern=("attn:dense",),
        norm="rms", act="silu", qkv_bias=True, tie_embeddings=True,
        rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen2.5-0.5B",
    )
