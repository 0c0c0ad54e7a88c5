"""xLSTM-1.3B — sLSTM + mLSTM blocks, 7:1 interleave [arXiv:2405.04517].

48 residual blocks; blocks own their projections (d_ff=0). mLSTM uses the
parallel (decay-masked) form for train/prefill and the recurrent
matrix-memory form for decode; sLSTM is strictly sequential.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="xlstm-1.3b", family="ssm",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_head=512,
        d_ff=0, vocab_size=50_304,
        layer_pattern=("mlstm:none",) * 7 + ("slstm:none",),
        norm="ln", act="gelu", proj_factor=2.0,
        source="arXiv:2405.04517",
    )
