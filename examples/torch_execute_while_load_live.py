"""Live execute-while-load timeline of the PyTorch port (paper Fig 4/9 in
miniature).

A 2→8 scale-out of a reduced model with REAL serving at every multicast
step, every node on one device: watch capability evolve from "sources
only" through λPipe execution pipelines to mode-switched local replicas —
every response's logits checked against the source model.

Run:  PYTHONPATH=src python examples/torch_execute_while_load_live.py \
          [--device cpu]
"""
import argparse
import dataclasses

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.models import forward, init_params, make_batch
from repro_torch.serving.cluster import LiveCluster


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required present)")
    ap.add_argument("--d-model", type=int, default=256)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = dataclasses.replace(
        reduced(get_config("qwen2.5-3b"), d_model=args.d_model), n_layers=8)
    params = init_params(cfg, seed=0, device=device)
    batch = make_batch(cfg, 2, 32, device=device)
    ref = forward(cfg, params, batch, moe_cf=None)["logits"]

    lc = LiveCluster(n_nodes=8, max_len=64, device=device)
    lc.register("qwen", cfg, params, n_blocks=8, hot_nodes=[0, 1])
    rep = lc.scale("qwen", 6, k=2)
    sc = lc.scales["qwen"]
    print(f"2→8 scale-out ({rep.source_tier} sources {rep.sources}), "
          f"{sc.plan.n_blocks} blocks, {sc.plan.total_steps} multicast steps "
          f"({sc.step_time*1e3:.1f} ms/step at 50 GB/s, simulated clock)\n")

    while True:
        r = lc.forward("qwen", batch["tokens"])
        ready = len(lc.ready_pipelines("qwen"))
        done = len(lc.complete_nodes("qwen"))
        if r is None:
            status = "queueing (no capacity)"
        else:
            err = float((r["logits"] - ref).abs().max())
            where = (f"node {r['node']}" if r["mode"] == "local"
                     else f"nodes {r['nodes']}")
            status = f"served via {r['mode']:<8s} on {where}  |Δ|={err:.1e}"
        print(f"step {sc.steps_done:2d}  t={lc.clock*1e3:6.1f}ms  "
              f"pipelines={ready}  complete={done}  {status}")
        if not lc.step():
            break

    r = lc.forward("qwen", batch["tokens"])
    print(f"\nafter completion: all 8 nodes serve locally "
          f"(mode switch §4.4); final check "
          f"|Δ|={float((r['logits'] - ref).abs().max()):.1e}")


if __name__ == "__main__":
    main()
