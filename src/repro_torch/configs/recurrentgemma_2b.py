"""RecurrentGemma-2B — hybrid RG-LRU + local attention, 2:1 [arXiv:2402.19427].

26 layers, repeating (rec, rec, attn) with a 2-layer (rec, rec) remainder.
MQA (kv=1), local attention window 2048.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_head=256,
        d_ff=7680, vocab_size=256_000,
        layer_pattern=("rec:dense", "rec:dense", "attn:dense"),
        norm="rms", act="gelu", window=2048, tie_embeddings=True,
        source="arXiv:2402.19427",
    )
