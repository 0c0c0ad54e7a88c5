"""The benchmark's frozen formulas for operations and bytes.

Model FLOPs count what the model needs for the tokens it serves (matrix
products of every weight a token passes, attention over the keys each query
admits), at real lengths, never at a padded bucket.  The kernel bounds are
frozen copies of the formulas ``chip_smoke.py`` uses for the kernel table of
``PERF.md`` section 6 (``_time_paged_step`` and ``_time_flash``): every input
byte read once, every output byte written once.

``cfg`` is the port's ``ModelConfig`` (only its widths are read).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence


def gated(cfg) -> bool:
    return cfg.act == "silu"


def layer_matmul_params(cfg) -> int:
    """Weights a token multiplies in one dense layer."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    attn = d * h * dh + 2 * d * kv * dh + h * dh * d
    return attn + (3 if gated(cfg) else 2) * d * cfg.d_ff


def _keys(pos: int, window: Optional[int]) -> int:
    """Keys the query at position ``pos`` attends (itself included)."""
    return pos + 1 if window is None else min(pos + 1, window)


def causal_pairs(start: int, n: int, window: Optional[int]) -> int:
    """(query, key) pairs of queries at positions start..start+n-1, each
    over every earlier key and itself, at most ``window`` of them."""
    def upto(m):                      # sum of _keys(p) for p < m
        if window is None or m <= window:
            return m * (m + 1) // 2
        return window * (window + 1) // 2 + (m - window) * window
    return upto(start + n) - upto(start)


def decode_flops(cfg, contexts: Sequence[int]) -> float:
    """One decode step of the slots whose query sits at position
    ``ctx - 1`` (``ctx`` keys with its own), logits included."""
    per_tok = 2 * (cfg.n_layers * layer_matmul_params(cfg)
                   + cfg.d_model * cfg.vocab_size)
    attn = sum(4 * _keys(c - 1, cfg.window) * cfg.n_heads * cfg.d_head
               for c in contexts)
    return len(contexts) * per_tok + cfg.n_layers * attn


def prefill_flops(cfg, n: int, start: int = 0) -> float:
    """A prefill of ``n`` real tokens at positions start..start+n-1, the
    logits of the last one only (what the engines read)."""
    pairs = causal_pairs(start, n, cfg.window)
    return (2 * n * cfg.n_layers * layer_matmul_params(cfg)
            + 2 * cfg.d_model * cfg.vocab_size
            + cfg.n_layers * 4 * pairs * cfg.n_heads * cfg.d_head)


def paged_decode_cost(cfg, contexts: Sequence[int], page_size: int,
                      esz: int = 2) -> Dict[str, float]:
    """Bytes and operations of one ``paged_decode_step`` launch (one layer)
    over the live slots: each stored K/V row read once, q in, out, the new
    K/V in and written to the pool, the page-table entries and lengths."""
    kv, h, dh = cfg.n_kv_heads, cfg.n_heads, cfg.d_head
    b = len(contexts)
    stored = sum(_keys(c - 1, cfg.window) - 1 for c in contexts)
    pages = sum(-(-c // page_size) for c in contexts)
    n_bytes = (2 * stored * kv * dh * esz + 2 * b * h * dh * esz
               + 4 * b * kv * dh * esz + pages * 4 + b * 4)
    return {"bytes": n_bytes, "flops": 4 * (stored + b) * h * dh}


def flash_cost(cfg, n: int, esz: int = 2) -> Dict[str, float]:
    """Bytes and operations of one causal ``flash_attention`` launch (one
    layer) over ``n`` real tokens: q, k, v read once, out written once."""
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    pairs = causal_pairs(0, n, cfg.window)
    return {"bytes": esz * (2 * h * n * dh + 2 * kv * n * dh),
            "flops": 4 * pairs * dh * h}


def bound_s(cost: Dict[str, float], peaks: Dict[str, float]) -> float:
    """The least time the card needs: operations at the bf16 peak or bytes
    at the memory peak, whichever is longer."""
    return max(cost["flops"] / peaks["bf16_flops"],
               cost["bytes"] / peaks["hbm_bytes_per_s"])
