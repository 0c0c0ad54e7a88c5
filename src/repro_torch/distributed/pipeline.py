"""GPipe-style pipelined forward over stages on devices: λPipe's 2-D
execution pipelines (§4.3) in one process.

Dimension 1 of the paper's 2-D pipelining is the stage (block) axis: each
stage applies its contiguous range of trunk layers and hands the
activation to the next stage's device (``.to(device, non_blocking=True)``).
Dimension 2 is the in-flight microbatch axis: while stage s works on
microbatch m, stage s-1 already works on m+1.  Stage 0 holds the
embedding and the last stage the head (and the tied embedding), so a
stage is exactly what a receiving node runs from the blocks it has
unpacked (``core.partial_exec``).  The counterpart of
``repro.distributed.pipeline``, whose stages are the devices of a JAX
mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.blocks import _unit_of, flatten_params
from repro_torch.core.partial_exec import (apply_layer_range,
                                           embed_from_flat, head_from_flat)
from repro_torch.serving.scheduler import DEFAULT_SLOTS, Scheduler, SeqState


@dataclasses.dataclass
class PipelineStage:
    """Trunk layers [lo, hi) of one stage, as the flat unit-keyed tensors
    (``core.blocks``) it holds on ``device``."""
    lo: int
    hi: int
    flat: Dict[str, torch.Tensor]
    device: torch.device


def stages_from_flat(cfg: ModelConfig, flat: Dict[str, torch.Tensor],
                     n_stages: int, devices: Sequence) -> List[PipelineStage]:
    """Cut a uniform trunk into ``n_stages`` contiguous equal layer ranges,
    stage s on ``devices[s]``: stage 0 also takes '@embed', the last
    '@head' (and '@embed' when the embeddings are tied).  Tensors already
    on their stage's device are used as they are (views into unpacked
    block buffers stay views)."""
    assert cfg.pattern_len == 1 and cfg.n_remainder_layers == 0, \
        "pipelined runner requires a uniform trunk"
    assert cfg.n_layers % n_stages == 0
    assert len(devices) == n_stages, (len(devices), n_stages)
    per = cfg.n_layers // n_stages
    stages = []
    for s in range(n_stages):
        units = {f"@layer{li:04d}" for li in range(s * per, (s + 1) * per)}
        if s == 0:
            units.add("@embed")
        if s == n_stages - 1:
            units.add("@head")
            if cfg.tie_embeddings:
                units.add("@embed")
        dev = torch.device(devices[s])
        stages.append(PipelineStage(
            s * per, (s + 1) * per,
            {k: v.to(dev) for k, v in flat.items() if _unit_of(k) in units},
            dev))
    return stages


def stage_params(cfg: ModelConfig, params, n_stages: int,
                 devices: Sequence) -> List[PipelineStage]:
    """The stages of a whole model in the port's parameter layout."""
    return stages_from_flat(cfg, flatten_params(cfg, params), n_stages,
                            devices)


def _on(device: torch.device):
    """``device`` as the current CUDA device for the block (a no-op for
    the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


@torch.no_grad()
def pipelined_forward(cfg: ModelConfig, stages: Sequence[PipelineStage],
                      batch: Dict, n_microbatches: int, *,
                      last: Optional[torch.Tensor] = None,
                      kernel_impl: str = "kernel") -> torch.Tensor:
    """Forward pass with the trunk pipelined over ``stages``.

    batch["tokens"]: (B, S) with B % n_microbatches == 0.  Returns logits
    (B, S, vocab), equal to ``repro_torch.models.forward``; with ``last``
    ((B,) positions) only the row at each sequence's position goes
    through the head, and the result is (B, vocab)."""
    n_stages = len(stages)
    tokens = batch["tokens"]
    B, S = tokens.shape
    M = n_microbatches
    assert B % M == 0
    mb = B // M
    embeds = embed_from_flat(cfg, stages[0].flat,
                             tokens.to(stages[0].device)).split(mb)
    positions = [torch.arange(S, device=st.device).expand(mb, S)
                 for st in stages]
    inbox: List[Optional[torch.Tensor]] = [None] * n_stages
    outs: List[Optional[torch.Tensor]] = [None] * M
    for t in range(M + n_stages - 1):
        # later stages first: stage s+1 takes what stage s sent last tick
        # before stage s sends again
        for s in reversed(range(n_stages)):
            m = t - s
            if not 0 <= m < M:
                continue
            st = stages[s]
            x = embeds[m] if s == 0 else inbox[s]
            # the kernels launch on the current device: make it the stage's
            with _on(st.device):
                y = apply_layer_range(cfg, st.flat, x, st.lo, st.hi,
                                      positions[s], kernel_impl=kernel_impl)
            if s == n_stages - 1:
                outs[m] = y
            else:
                inbox[s + 1] = y.to(stages[s + 1].device, non_blocking=True)
    hidden = torch.cat(outs)
    if last is not None:
        rows = torch.arange(B, device=hidden.device)
        hidden = hidden[rows, last.to(hidden.device)][:, None]
        return head_from_flat(cfg, stages[-1].flat, hidden)[:, 0]
    return head_from_flat(cfg, stages[-1].flat, hidden)


# ================================================= continuous batching (EWL)
class PipelinedEngine:
    """Continuous-batching serving on a λPipe execution pipeline.

    The transitional (execute-while-load) mode keeps no decode cache: a
    pipeline stage only holds the blocks that have arrived, and the mode
    switch will recompute state anyway (§4.4), so each tick re-runs the
    full-sequence pipelined forward over prompt + generated-so-far for
    every live slot and reads the logits at each sequence's last position
    (only those rows go through the head: at a 152k vocabulary the full
    (n_slots, L, vocab) logits would be gigabytes).  Token batches are
    right-padded to ``pad_to`` multiples (causal-safe) and always span
    the full ``n_slots`` pool, as the JAX engine's fixed shapes do.

    ``forward_fn(tokens (n_slots, L), last (n_slots,))`` returns the
    (n_slots, vocab) logits at ``last``.  Drives the same
    ``repro_torch.serving.scheduler.Scheduler`` as the local
    ``ContinuousBatchingEngine``; ``drain()`` + ``handoff()`` export live
    slot state for adoption by a local replica at mode-switch time.
    """

    def __init__(self, cfg: ModelConfig,
                 forward_fn: Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor], *,
                 device, n_slots: int = DEFAULT_SLOTS, max_len: int = 512,
                 pad_to: int = 16, max_prefill_per_tick: int = 2,
                 policy=None):
        self.cfg = cfg
        self.forward_fn = forward_fn
        self.device = torch.device(device)
        self.n_slots = n_slots
        self.max_len = max_len
        self.pad_to = pad_to
        self.sched = Scheduler(n_slots,
                               max_prefill_per_tick=max_prefill_per_tick,
                               policy=policy)
        self._next_id = 0

    @classmethod
    def from_stages(cls, cfg: ModelConfig, stages: Sequence[PipelineStage],
                    *, n_microbatches: int = 1,
                    n_slots: int = DEFAULT_SLOTS,
                    kernel_impl: str = "kernel", **kw) -> "PipelinedEngine":
        """λPipe trunk over ``stages`` (``stage_params`` or
        ``stages_from_flat``): the forward is ``pipelined_forward``."""
        assert n_slots % n_microbatches == 0

        def fwd(tokens: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
            return pipelined_forward(cfg, stages, {"tokens": tokens},
                                     n_microbatches, last=last,
                                     kernel_impl=kernel_impl)
        return cls(cfg, fwd, device=stages[0].device, n_slots=n_slots, **kw)

    # ------------------------------------------------------------- intake
    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               req_id: Optional[int] = None,
               eos_id: Optional[int] = None,
               t_arrive: Optional[float] = None, slo=None,
               probe: bool = False) -> int:
        if req_id is None:
            req_id = self._next_id
        self._next_id = max(self._next_id, req_id) + 1
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"request needs {len(prompt) + max_new_tokens} positions "
                f"but the engine was built with max_len={self.max_len}")
        self.sched.submit(SeqState(req_id, list(prompt), max_new_tokens,
                                   eos_id=eos_id, t_arrive=t_arrive,
                                   slo=slo, probe=probe))
        return req_id

    # ---------------------------------------------------------- execution
    def _bucket(self, n: int) -> int:
        b = ((n + self.pad_to - 1) // self.pad_to) * self.pad_to
        return min(b, self.max_len)

    def step(self) -> bool:
        tick = self.sched.next_tick()
        if tick.idle:
            return False
        # one padded full-sequence forward serves both the admitted
        # prefills and every in-flight decode this tick
        work: List[Tuple[int, SeqState, bool]] = (
            [(slot, seq, True) for slot, seq in tick.admit]
            + [(slot, self.sched.slots[slot], False)
               for slot in tick.decode])
        L = self._bucket(max(seq.pos for _, seq, _ in work))
        toks = np.zeros((self.n_slots, L), np.int64)
        last = np.zeros((self.n_slots,), np.int64)
        for slot, seq, _ in work:
            t = seq.tokens_so_far[:L]
            toks[slot, :len(t)] = t     # host assembly: one transfer/tick
            last[slot] = seq.pos - 1
        logits = self.forward_fn(torch.from_numpy(toks).to(self.device),
                                 torch.from_numpy(last).to(self.device))
        ids = logits.argmax(-1).tolist()          # one device-to-host read
        for slot, seq, is_admit in work:
            if is_admit:
                self.sched.on_prefilled(slot, ids[slot])
            else:
                self.sched.on_decoded(slot, ids[slot])
        return True

    def run(self) -> Dict[int, List[int]]:
        while self.step():
            pass
        return {rid: s.generated for rid, s in self.sched.finished.items()}

    # --------------------------------------------------------- mode switch
    def drain(self) -> None:
        self.sched.drain()

    def handoff(self) -> List[Tuple[SeqState, None]]:
        """Export in-flight sequences for a local replica to adopt.  A
        pipelined instance holds no decode cache, so every pair carries
        ``None`` — ``ContinuousBatchingEngine.adopt`` rebuilds the cache
        once from the tokens (mode-switch recomputation, §4.4)."""
        return [(seq, None) for seq in self.sched.handoff()]

    @property
    def stats(self) -> Dict[str, int]:
        return self.sched.stats
