"""Closed-loop autoscaling on the live cluster of the PyTorch port,
narrated.

The model starts with ZERO GPU replicas — only a host-memory copy on
node 0 (the §5 locality tier).  A bursty trace then arrives and the
``Autoscaler`` closes the loop the paper describes:

  1. queue builds → scale-up: the warm copy promotes (64 GB/s, not SSD)
     and a k-way multicast fans the model out while EWL pipelines serve;
  2. the burst is absorbed; replicas finish the multicast, mode-switch,
     and in-flight requests hand off into DECODE with their tokens;
  3. the trace goes quiet → keep-alive expires → scale-down releases the
     GPUs; the packed blocks fall back to host memory, where the NEXT
     burst finds them warm again.

Every node's engine runs on one device (the GPU by default); times are on
the simulated clock.

Run:  PYTHONPATH=src python examples/torch_autoscale_replay.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.models import init_params
from repro_torch.serving.autoscaler import Autoscaler, AutoscalerConfig
from repro_torch.serving.cluster import LiveCluster
from repro_torch.serving.workload import Request


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required present)")
    ap.add_argument("--d-model", type=int, default=64)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(get_config("stablelm-1.6b"), d_model=args.d_model)
    params = init_params(cfg, seed=1, device=device)
    lc = LiveCluster(n_nodes=6, n_slots=2, max_len=48, device=device)
    lc.register("m", cfg, params, n_blocks=2, warm_nodes=[0])
    print("registered 'm': 0 GPU replicas, host-warm on node 0\n")

    rng = np.random.default_rng(0)
    # two bursts with a quiet gap — long enough for keep-alive to fire
    trace = [Request(i, "m", 0.005 + 0.002 * i, int(rng.integers(4, 8)),
                     int(rng.integers(3, 6))) for i in range(8)]
    trace += [Request(8 + i, "m", 0.6 + 0.002 * i, int(rng.integers(4, 8)),
                      int(rng.integers(3, 6))) for i in range(8)]

    asc = Autoscaler(AutoscalerConfig(cooldown_up=0.05, cooldown_down=0.02,
                                      keepalive=0.15, min_replicas=0,
                                      max_k=2))
    log = lc.replay(trace, autoscaler=asc, tick_seconds=0.002,
                    tail_seconds=0.5)

    s = log.summary()
    print(f"{int(s['n_finished'])}/{len(trace)} requests served; "
          f"TTFT p50={s['ttft_p50']*1e3:.1f}ms "
          f"p99={s['ttft_p99']*1e3:.1f}ms; "
          f"gpu_seconds={s['gpu_seconds']:.3f} (simulated clock)\n")
    print("scale-event audit trail (simulated clock):")
    for e in log.scale_events:
        print(f"  t={e.t*1e3:7.1f}ms {e.kind:6s} {e.detail}")
    print(f"\nfinal replicas: {sorted(lc.serving['m'].locals_)}; "
          f"host-warm payload on {lc._host_payload_nodes('m')} "
          f"(the next burst starts warm)")


if __name__ == "__main__":
    main()
