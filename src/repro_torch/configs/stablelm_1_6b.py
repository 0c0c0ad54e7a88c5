"""StableLM-2-1.6B — dense MHA, LayerNorm, 25% rotary [hf:stabilityai/stablelm-2-1_6b]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="stablelm-1.6b", family="dense",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
        d_ff=5632, vocab_size=100_352,
        layer_pattern=("attn:dense",),
        norm="ln", act="silu", qkv_bias=True, rope_pct=0.25,
        source="hf:stabilityai/stablelm-2-1_6b",
    )
