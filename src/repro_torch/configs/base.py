"""Model / input-shape configuration dataclasses.

Every assigned architecture is expressed as a ``ModelConfig``; the dry-run,
smoke tests, benchmarks and the serving simulator all consume the same
object.  ``layer_pattern`` describes the repeating (mixer, ffn) structure of
the trunk; see ``repro_torch.models.model`` for how it is scanned.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

# Pattern entry grammar: "<mixer>:<ffn>" where
#   mixer ∈ {attn, attn_full, rec, mlstm, slstm}
#     attn       — self attention; windowed iff cfg.window is not None
#     attn_full  — self attention, always full/global (overrides window)
#     rec        — RG-LRU recurrent block (Griffin/RecurrentGemma)
#     mlstm      — xLSTM matrix-memory block (owns its own projections)
#     slstm      — xLSTM scalar-memory block
#   ffn ∈ {dense, moe, none}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    layer_pattern: Tuple[str, ...] = ("attn:dense",)
    norm: str = "rms"                # rms | ln
    act: str = "silu"                # silu | gelu
    qkv_bias: bool = False
    mlp_bias: bool = False
    out_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    rope_pct: float = 1.0            # fraction of d_head rotated; 0.0 → learned abs. pos.
    max_position: int = 1 << 19
    window: Optional[int] = None     # sliding-window size for "attn" mixers
    norm_eps: float = 1e-5
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    shared_expert_d_ff: int = 0
    router_aux_coef: float = 0.01    # load-balance aux loss
    # --- recurrent (RG-LRU / xLSTM) ---
    conv_width: int = 4              # temporal conv in rec / mlstm blocks
    proj_factor: float = 2.0         # mLSTM inner expansion
    # --- encoder-decoder (whisper backbone) ---
    n_enc_layers: int = 0
    enc_seq: int = 0                 # frames produced by the (stubbed) frontend
    # --- VLM (pixtral backbone) ---
    n_patches: int = 0               # patch embeddings produced by the (stubbed) ViT
    # --- citation ---
    source: str = ""

    # ---------------- derived helpers ----------------
    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def pattern_len(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_pattern_reps(self) -> int:
        return self.n_layers // self.pattern_len

    @property
    def n_remainder_layers(self) -> int:
        return self.n_layers % self.pattern_len

    def mixer_of(self, layer_idx: int) -> str:
        return self.layer_pattern[layer_idx % self.pattern_len].split(":")[0]

    def ffn_of(self, layer_idx: int) -> str:
        return self.layer_pattern[layer_idx % self.pattern_len].split(":")[1]

    @property
    def d_inner(self) -> int:
        """Inner width of mlstm/slstm blocks."""
        return int(self.d_model * self.proj_factor)

    @property
    def is_subquadratic(self) -> bool:
        """True iff a 524k-token decode keeps bounded per-token state.

        Requires every mixer in the pattern to be recurrent or windowed
        attention (``attn`` with a finite ``window``).
        """
        for ent in self.layer_pattern:
            mixer = ent.split(":")[0]
            if mixer == "attn_full":
                return False
            if mixer == "attn" and self.window is None:
                return False
        if self.family == "encdec":
            return False
        return True

    def param_count(self) -> int:
        """Analytic parameter count (matches init_params within ties/bias)."""
        d, v = self.d_model, self.vocab_size
        total = v * d                      # embed
        if not self.tie_embeddings:
            total += v * d                 # unembed
        if self.rope_pct == 0.0:
            total += self.max_position_embed * d
        for i in range(self.n_layers):
            total += self._layer_params(i)
        total += d                         # final norm
        if self.family == "encdec":
            total += self.enc_seq * d + d  # enc pos + enc final norm
            for _ in range(self.n_enc_layers):
                total += self._attn_params() + self._dense_ffn_params() + 2 * d
        return total

    @property
    def max_position_embed(self) -> int:
        # learned-position archs (whisper) keep a small table
        return 4096 if self.rope_pct == 0.0 else 0

    def _attn_params(self) -> int:
        d, h, kv, dh = self.d_model, self.n_heads, self.n_kv_heads, self.d_head
        p = d * h * dh + 2 * d * kv * dh + h * dh * d
        if self.qkv_bias:
            p += (h + 2 * kv) * dh
        return p

    def _dense_ffn_params(self) -> int:
        mult = 3 if self.act == "silu" else 2   # gated vs plain MLP
        return mult * self.d_model * self.d_ff

    def _layer_params(self, i: int) -> int:
        mixer, ffn = self.mixer_of(i), self.ffn_of(i)
        d = self.d_model
        p = 2 * d  # two pre-norms (blocks with ffn "none" still count ~2d; fine)
        if mixer in ("attn", "attn_full"):
            p += self._attn_params()
        elif mixer == "rec":
            # RG-LRU block: in/out proj (x2 branches), conv, gates, lambda
            p += 2 * d * d + d * d + self.conv_width * d + 2 * d * d + d
        elif mixer == "mlstm":
            # up-proj (2 branches), head-wise block-diagonal qkv, down-proj
            di = self.d_inner
            p += 2 * d * di + di * d + self.conv_width * di
            p += 3 * di * di // self.n_heads + 3 * di   # headwise qkv + gates
        elif mixer == "slstm":
            # operates at d_model: 4 gate input projs + headwise recurrent +
            # gated FFN at factor 4/3
            p += 4 * d * d + 4 * d * d // self.n_heads + 4 * d
            p += 2 * d * int(d * 4 / 3)
        if ffn == "dense":
            p += self._dense_ffn_params()
        elif ffn == "moe":
            e = self.n_experts * 3 * d * self.expert_d_ff
            e += d * self.n_experts  # router
            if self.n_shared_experts:
                sd = self.shared_expert_d_ff or self.n_shared_experts * self.expert_d_ff
                e += 3 * d * sd
            p += e
        return p

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k experts)."""
        if self.n_experts == 0:
            return self.param_count()
        total = self.param_count()
        # subtract inactive routed experts
        inactive = self.n_experts - self.top_k
        per_expert = 3 * self.d_model * self.expert_d_ff
        n_moe_layers = sum(
            1 for i in range(self.n_layers) if self.ffn_of(i) == "moe")
        return total - n_moe_layers * inactive * per_expert

    def bytes_bf16(self) -> int:
        return 2 * self.param_count()


def reduced(cfg: ModelConfig, *, d_model: int = 256, n_layers: Optional[int] = None,
            vocab: int = 512, max_experts: int = 4) -> ModelConfig:
    """Smoke-test variant of the same family: ≤2 pattern reps, d_model≤512,
    ≤4 experts — runs a real forward/train step on CPU."""
    pat = cfg.layer_pattern
    nl = n_layers if n_layers is not None else min(cfg.n_layers, max(2, len(pat)))
    n_heads = 4
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    if cfg.n_kv_heads == cfg.n_heads:
        n_kv = n_heads
    d_head = d_model // n_heads
    kw = dict(
        n_layers=nl, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
        d_head=d_head, d_ff=0 if cfg.d_ff == 0 else d_model * 3,
        vocab_size=vocab, max_position=8192,
        window=None if cfg.window is None else min(cfg.window, 64),
    )
    if cfg.n_experts:
        kw.update(n_experts=min(cfg.n_experts, max_experts),
                  top_k=min(cfg.top_k, 2),
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  expert_d_ff=d_model,
                  shared_expert_d_ff=d_model if cfg.shared_expert_d_ff else 0)
    if cfg.family == "encdec":
        kw.update(n_enc_layers=2, enc_seq=16)
    if cfg.family == "vlm":
        kw.update(n_patches=4)
    return dataclasses.replace(cfg, **kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,   32, "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",  524_288,    1, "decode"),
}
