"""Train a ~100M-param reduced StarCoder2 with the PyTorch port for a few
hundred steps on the synthetic Markov corpus, then checkpoint it as
λScale tensor-packed blocks and reload.

Run:  PYTHONPATH=src python examples/torch_train_small.py [--steps 300]
      [--device cpu]   (the GPU by default; ``examples/train_small.py``
      is the JAX original)
"""
import argparse
import tempfile

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.models import forward, make_batch
from repro_torch.training import (AdamWConfig, Trainer, data_iterator,
                                  load_checkpoint, save_checkpoint)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    # defaults give ~100M params; on a 1-CPU box use --d-model 256 --steps 60
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required present)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(get_config("starcoder2-3b"), d_model=args.d_model,
                  n_layers=args.layers, vocab=4096)
    print(f"training {cfg.arch_id} (reduced): "
          f"{cfg.param_count()/1e6:.0f}M params, {cfg.n_layers} layers, "
          f"on {device}")

    trainer = Trainer(cfg, AdamWConfig(lr=6e-4, warmup_steps=30,
                                       total_steps=args.steps),
                      device=device)
    it = data_iterator(cfg, batch=args.batch, seq_len=args.seq)
    hist = trainer.fit(it, args.steps, log_every=max(args.steps // 10, 1))
    print(f"\nloss: {hist[0]['loss']:.3f} → {hist[-1]['loss']:.3f}")

    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, cfg, trainer.params, n_blocks=8, step=args.steps)
        params2, step = load_checkpoint(d, cfg, device=device)
        b = make_batch(cfg, 2, 64, device=device)
        diff = float((forward(cfg, trainer.params, b)["logits"]
                      - forward(cfg, params2, b)["logits"]).abs().max())
        print(f"tensor-packed checkpoint roundtrip at step {step}: "
              f"max logit diff = {diff} (bit-exact)")
        assert diff == 0.0, "the checkpoint changed the weights"
    return hist


if __name__ == "__main__":
    main()
