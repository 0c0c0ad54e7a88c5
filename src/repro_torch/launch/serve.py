"""Serving entry point of the PyTorch port: bring up a model on the GPU
and serve a static batch through ``InferenceEngine`` (the default, as
``repro.launch.serve.run_engine`` does) or replay a mixed-length burst
through the continuous-batching engine (``--continuous``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b
  PYTHONPATH=src python -m repro_torch.launch.serve --continuous
  PYTHONPATH=src python -m repro_torch.launch.serve --continuous \\
      --d-model 64 --device cpu --requests 6 --prompt 16 --tokens 4

``--arch`` is served at its full published width unless ``--d-model``
asks for a reduced variant (which also cuts the vocabulary to 2048, as
the JAX driver does).  Weights are random, from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.models import init_params, make_batch
from repro_torch.serving import ContinuousBatchingEngine, InferenceEngine

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def mixed_trace(n: int, prompt: int, tokens: int, seed: int = 0):
    """Mixed-length request list (prompt_len, out_tokens) around the
    requested means — the workload shape where continuous batching wins."""
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(max(4, prompt // 2), prompt * 2)),
             int(rng.integers(max(2, tokens // 2), tokens * 2)))
            for _ in range(n)]


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _model(args, device):
    cfg = get_config(args.arch)
    if args.d_model is not None:
        cfg = reduced(cfg, d_model=args.d_model, vocab=2048)
    return cfg, init_params(cfg, seed=args.seed, dtype=DTYPES[args.dtype],
                            device=device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_engine(args) -> None:
    """Serve one static batch of ``--requests`` prompts of ``--prompt``
    tokens, ``--tokens`` new tokens each, through ``InferenceEngine``."""
    device = resolve_device(args.device)
    cfg, params = _model(args, device)
    eng = InferenceEngine(cfg, params, max_len=args.prompt + args.tokens)
    batch = make_batch(cfg, args.requests, args.prompt, seed=args.seed + 1,
                       device=device)
    _sync(device)
    t0 = time.perf_counter()
    out = eng.generate(batch, args.tokens)
    _sync(device)
    dt = time.perf_counter() - t0
    total = args.requests * args.tokens
    print(f"arch={cfg.arch_id} d_model={cfg.d_model} layers={cfg.n_layers} "
          f"dtype={args.dtype}: served {args.requests} requests x "
          f"{args.tokens} tokens in {dt:.3f}s ({total / dt:.1f} tok/s on "
          f"{device_name(device)}); output shape {tuple(out.shape)}")


def run_continuous(args) -> None:
    """Drive the continuous-batching engine through a mixed-length spike:
    every request arrives at once (the burst), slots refill mid-decode."""
    if args.requests < 1:
        raise SystemExit("--continuous needs --requests >= 1")
    device = resolve_device(args.device)
    cfg, params = _model(args, device)
    trace = mixed_trace(args.requests, args.prompt, args.tokens,
                        seed=args.seed)
    max_len = max(p + t for p, t in trace)
    rng = np.random.default_rng(args.seed + 1)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, size=p)))
               for p, _ in trace]
    eng = ContinuousBatchingEngine(cfg, params, n_slots=args.slots,
                                   max_len=max_len)
    for (_, otok), prompt in zip(trace, prompts):
        eng.submit(prompt, otok)
    _sync(device)
    t0 = time.perf_counter()
    out = eng.run()
    _sync(device)
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in out.values())
    s = eng.stats
    print(f"arch={cfg.arch_id} d_model={cfg.d_model} layers={cfg.n_layers} "
          f"dtype={args.dtype}: {len(trace)} requests ({args.slots} slots) "
          f"-> {total} tokens in {dt:.3f}s ({total / dt:.1f} tok/s on "
          f"{device_name(device)})")
    print(f"  prefills={s['prefills']} decode_ticks={s['decode_ticks']} "
          f"mean decode batch="
          f"{s['decode_tokens'] / max(s['decode_ticks'], 1):.2f}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching engine on a mixed-length trace "
                         "(default: one static batch through InferenceEngine)")
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--d-model", type=int, default=None,
                    help="reduce the model to this width (default: full)")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required present)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.continuous:
        run_continuous(args)
    else:
        run_engine(args)


if __name__ == "__main__":
    main()
