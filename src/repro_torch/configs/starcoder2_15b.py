"""StarCoder2-15B — dense, GQA(kv=4), RoPE, sliding-window 4096 [arXiv:2402.19173]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="starcoder2-15b", family="dense",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, d_head=128,
        d_ff=24576, vocab_size=49152,
        layer_pattern=("attn:dense",),
        norm="ln", act="gelu", qkv_bias=True, mlp_bias=True,
        rope_theta=100_000.0, window=4096,
        source="arXiv:2402.19173",
    )
