"""Whisper-large-v3 backbone — encoder-decoder transformer [arXiv:2212.04356].

The mel-spectrogram + conv feature extractor is STUBBED per the assignment:
``input_specs()`` supplies precomputed (B, 1500, 1280) frame embeddings.
Positions are learned-absolute (rope_pct=0); indices are clamped to the
table, which only matters for the synthetic decode_32k shape.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="whisper-large-v3", family="encdec",
        n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_head=64,
        d_ff=5120, vocab_size=51866,
        layer_pattern=("attn:dense",),
        norm="ln", act="gelu", qkv_bias=True, mlp_bias=True,
        rope_pct=0.0, n_enc_layers=32, enc_seq=1500,
        source="arXiv:2212.04356",
    )
