"""Quickstart of the PyTorch port: the λScale core in five minutes.

1. Build a small model, partition it into λScale blocks, tensor-pack them.
2. Plan a 2→8 k-way scale-out (Algorithm 1 + binomial pipeline schedule).
3. Generate execution pipelines (Algorithm 2) and inspect readiness.
4. Price the scale-out on the calibrated link model (paper Fig 7 check).
5. Serve a few requests through the inference engine.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(the GPU by default; ``examples/quickstart.py`` is the JAX original).
"""
import argparse

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.core import LinkModel, pack_model, plan_scale
from repro_torch.models import init_params, make_batch
from repro_torch.serving import InferenceEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required present)")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--tokens", type=int, default=8)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # ------------------------------------------------------------- 1. model
    cfg = reduced(get_config("qwen2.5-3b"), d_model=args.d_model)
    params = init_params(cfg, seed=0, device=device)
    print(f"model: {cfg.arch_id} (reduced) — "
          f"{cfg.param_count()/1e6:.1f}M params on {device}")

    blocks, specs = pack_model(cfg, params, n_blocks=4)
    print(f"tensor-packed into {blocks.shape[0]} contiguous blocks of "
          f"{blocks.shape[1]/2**20:.2f} MiB each "
          f"({sum(s.nbytes for s in specs)/2**20:.2f} MiB payload)")

    # -------------------------------------------------------- 2./3. λPipe
    plan = plan_scale(n_nodes=8, n_blocks=16, k=2)
    print("\n2→8 scale-out, 16 blocks, k=2:")
    print(f"  multicast completes in {plan.total_steps} steps "
          f"(optimal bound: 16 + log2(4) - 1 = 18 per sub-group)")
    for i, (pipe, ready) in enumerate(zip(plan.pipelines,
                                          plan.pipeline_ready)):
        stages = ", ".join(f"node{s.node}:blocks{s.blocks[0]}-{s.blocks[-1]}"
                           for s in pipe.stages)
        print(f"  pipeline {i}: [{stages}] ready at step {ready}")

    # ----------------------------------------------------------- 4. timing
    link = LinkModel(bandwidth=50e9, step_overhead=0.004)  # 400 Gb/s-class
    t13 = link.multicast_time(26e9, n_nodes=8, n_blocks=16)
    print(f"\nLlama-13B (26 GB) → 8 nodes: {t13*1e3:.0f} ms on the link "
          f"model (paper: < 1 s)")

    # ---------------------------------------------------------- 5. serving
    eng = InferenceEngine(cfg, params, max_len=128)
    batch = make_batch(cfg, 2, 32, device=device)
    out = eng.generate(batch, args.tokens)
    print(f"\nserved 2 requests × {args.tokens} tokens: {out.tolist()}")


if __name__ == "__main__":
    main()
