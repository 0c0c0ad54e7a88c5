"""Plain float32 PyTorch forward of a dense decoder, the benchmark's
reference for the ``dense`` configurations.

It follows the published architecture descriptions (Hugging Face's
``Starcoder2`` and ``StableLm`` modelling code): pre-LayerNorm blocks,
rotary embedding of the leading ``partial_rotary_factor`` share of each
head's dimensions (halves rotated, not pairs), grouped-query causal
attention, optionally in a sliding window, a GELU (tanh) MLP or a gated
SiLU MLP, biases where the configuration has them, a final LayerNorm and
the head (the embeddings transposed when they are tied).  It reads the
published keys of the configuration file and the weight tensors the
benchmark made, and nothing of the program.

``precision="fp8"`` is the control: every matrix product takes its two
operands rounded to float8 e4m3 (a scale per activation row and per weight
column), the step below the bfloat16 the configurations state.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Q_BLOCK = 512
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """float32 products in float32 (no TF32), restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to e4m3 with one scale per slice along ``dim``."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Reference:
    def __init__(self, pub: Dict, params: Dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision is fp32 or fp8, not {precision!r}")
        self.p, self.params, self.fp8 = pub, params, precision == "fp8"
        self.d = pub["hidden_size"]
        self.h = pub["num_attention_heads"]
        self.kv = pub["num_key_value_heads"]
        self.dh = self.d // self.h
        self.eps = pub.get("norm_epsilon", pub.get("layer_norm_eps"))
        self.window: Optional[int] = pub.get("sliding_window")
        rd = int(self.dh * pub.get("partial_rotary_factor", 1.0))
        self.rd = rd - rd % 2
        self.theta = float(pub["rope_theta"])

    def _mm(self, x, w, b=None):
        w = w.float()
        if self.fp8:
            x, w = _fp8(x, -1), _fp8(w, 0)
        y = x @ w
        return y if b is None else y + b.float()

    def _norm(self, p, x):
        return F.layer_norm(x, (self.d,), p["scale"].float(),
                            p["bias"].float(), self.eps)

    def _rope(self, x, pos):
        """x: (S, heads, dh); pos: (S,) positions."""
        if self.rd == 0:
            return x
        half = self.rd // 2
        inv = self.theta ** (-torch.arange(0, self.rd, 2, dtype=torch.float64,
                                           device=x.device) / self.rd)
        ang = pos.double()[:, None] * inv[None]
        cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
        r, rest = x[..., :self.rd], x[..., self.rd:]
        r1, r2 = r[..., :half], r[..., half:]
        rot = torch.cat([r1 * cos - r2 * sin, r2 * cos + r1 * sin], -1)
        return torch.cat([rot, rest], -1)

    def _attention(self, a, x, pos, past=None):
        """Rows ``x`` at positions ``pos`` attend over the keys ``past``
        (the K/V of every earlier position, after RoPE) and their own.
        Returns (out, (k, v)) with this call's K/V appended to ``past``."""
        S = x.shape[0]
        q = self._mm(x, a["wq"], a.get("bq")).view(S, self.h, self.dh)
        k = self._mm(x, a["wk"], a.get("bk")).view(S, self.kv, self.dh)
        v = self._mm(x, a["wv"], a.get("bv")).view(S, self.kv, self.dh)
        q, k = self._rope(q, pos), self._rope(k, pos)
        if past is not None:
            k, v = torch.cat([past[0], k]), torch.cat([past[1], v])
        kpos = torch.arange(k.shape[0], device=x.device)
        rep = self.h // self.kv
        kh = k.repeat_interleave(rep, dim=1).transpose(0, 1)    # (h, T, dh)
        vh = v.repeat_interleave(rep, dim=1).transpose(0, 1)
        out = torch.empty((S, self.h, self.dh), device=x.device)
        for s0 in range(0, S, Q_BLOCK):
            qb = q[s0:s0 + Q_BLOCK].transpose(0, 1)              # (h, b, dh)
            sc = qb @ kh.transpose(1, 2) / math.sqrt(self.dh)    # (h, b, T)
            rel = pos[s0:s0 + Q_BLOCK, None] - kpos[None, :]
            ok = rel >= 0
            if self.window is not None:
                ok &= rel < self.window
            sc = sc.masked_fill(~ok[None], float("-inf"))
            out[s0:s0 + Q_BLOCK] = (sc.softmax(-1) @ vh).transpose(0, 1)
        return self._mm(out.reshape(S, self.d), a["wo"], a.get("bo")), (k, v)

    def _mlp(self, f, x):
        if self.p["hidden_act"] == "silu":
            g = F.silu(self._mm(x, f["w_gate"]))
            return self._mm(g * self._mm(x, f["w_in"], f.get("b_in")),
                            f["w_out"], f.get("b_out"))
        if self.p["hidden_act"] != "gelu_pytorch_tanh":
            raise ValueError(f"activation {self.p['hidden_act']!r}")
        hid = F.gelu(self._mm(x, f["w_in"], f.get("b_in")), approximate="tanh")
        return self._mm(hid, f["w_out"], f.get("b_out"))

    def _layers(self, tokens, first: int, past=None):
        """The trunk over positions first..len(tokens)-1 (``past``: every
        layer's K/V of the positions before ``first``).  Returns the
        residual rows and every layer's K/V up to the last position."""
        pos = torch.arange(first, tokens.shape[0], device=tokens.device)
        x = self.params["embed"][tokens[first:]].float()
        kvs = []
        for i, lp in enumerate(self.params["layers"]):
            a, kv = self._attention(lp["attn"], self._norm(lp["norm1"], x),
                                    pos, None if past is None else past[i])
            x = x + a
            x = x + self._mlp(lp["ffn"], self._norm(lp["norm2"], x))
            kvs.append(kv)
        return x, kvs

    @torch.no_grad()
    def prefix(self, tokens: torch.Tensor):
        """Every layer's K/V of ``tokens``, to pass as ``past`` to
        ``logits`` for sequences that open with them."""
        with exact_fp32():
            return self._layers(tokens, 0)[1]

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor, start: int,
               past=None) -> torch.Tensor:
        """float32 logits (S - start, vocab) of the positions start..S-1 of
        ``tokens`` (S,), each over every token up to it.  ``past``
        (``prefix`` of the first P tokens, P <= start) skips recomputing
        them; the result is the same."""
        with exact_fp32():
            first = 0 if past is None else past[0][0].shape[0]
            x, _ = self._layers(tokens, first, past)
            x = self._norm(self.params["final_norm"], x[start - first:])
            head = (self.params["embed"].T if self.p["tie_word_embeddings"]
                    else self.params["head"])
            return self._mm(x, head)
