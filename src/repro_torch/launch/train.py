"""Training driver of the PyTorch port: train a ~100M-param reduced variant
of any assigned architecture on the synthetic Markov corpus, on the GPU
unless ``--device`` says otherwise.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --steps 300 --batch 16 --seq 256 --d-model 512
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 20 --batch 4 --seq 64 --d-model 64

The flags and defaults are ``repro.launch.train``'s, plus ``--device``.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.training import AdamWConfig, Trainer, data_iterator
from repro_torch.training.checkpoint import save_checkpoint


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--ckpt", default=None,
                    help="directory for a final tensor-packed checkpoint")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required present)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced(get_config(args.arch), d_model=args.d_model,
                  n_layers=args.layers, vocab=2048)
    print(f"arch={cfg.arch_id} family={cfg.family} "
          f"params={cfg.param_count()/1e6:.1f}M layers={cfg.n_layers} "
          f"d={cfg.d_model} device={device}")
    opt = AdamWConfig(lr=args.lr, warmup_steps=min(50, args.steps // 5),
                      total_steps=args.steps)
    tr = Trainer(cfg, opt, device=device)
    it = data_iterator(cfg, args.batch, args.seq)
    t0 = time.time()
    hist = tr.fit(it, args.steps, log_every=max(args.steps // 20, 1))
    dt = time.time() - t0
    toks = args.steps * args.batch * args.seq
    print(f"done: {args.steps} steps, {toks/dt:.0f} tok/s, "
          f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    if args.ckpt:
        save_checkpoint(args.ckpt, cfg, tr.params, n_blocks=8,
                        step=args.steps)
        print(f"checkpoint (tensor-packed blocks) written to {args.ckpt}")


if __name__ == "__main__":
    main()
