"""StarCoder2-3B — dense, GQA(kv=2), RoPE, sliding-window 4096 [arXiv:2402.19173]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="starcoder2-3b", family="dense",
        n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_head=128,
        d_ff=12288, vocab_size=49152,
        layer_pattern=("attn:dense",),
        norm="ln", act="gelu", qkv_bias=True, mlp_bias=True,
        rope_theta=999_999.0, window=4096,
        source="arXiv:2402.19173",
    )
