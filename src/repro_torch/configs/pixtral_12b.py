"""Pixtral-12B backbone — mistral-nemo-style decoder consuming ViT patches
[hf:mistralai/Pixtral-12B-2409].

The Pixtral-ViT vision encoder + projector is STUBBED: ``input_specs()``
supplies (B, 64, 5120) patch embeddings prepended to the text sequence.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="pixtral-12b", family="vlm",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_head=128,
        d_ff=14336, vocab_size=131_072,
        layer_pattern=("attn:dense",),
        norm="rms", act="silu", rope_theta=1_000_000.0,
        n_patches=64,
        source="hf:mistralai/Pixtral-12B-2409",
    )
