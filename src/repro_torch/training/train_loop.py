"""Training step + loop: next-token cross-entropy over the text region
(VLM patch positions and encoder frames excluded), AdamW, rematerialised
layers.

The counterpart of ``repro.training.train_loop``.  The forward is
``models.train_forward``: the plain path with gradients (the JAX package
trains through XLA, not through its Pallas kernels; the port's CUDA
kernels have no backward).  The step runs eagerly.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import upcast
from repro_torch.models import init_params, train_forward
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            decay_mask, init_opt_state,
                                            tree_leaves, tree_map)


def loss_terms(out: Dict, tokens) -> Tuple[torch.Tensor, Dict]:
    """(loss, {"nll", "aux"}) of a forward's output ``out`` ({"logits",
    "aux"}) against ``tokens`` (B, S_text): the mean next-token NLL over
    the text region, in fp32, plus the MoE load-balance ``aux``."""
    logits = upcast(out["logits"])
    # logits are over [patches?, tokens]; predictions for tokens[1:] come
    # from positions P..P+S-2 where P = number of patch positions.
    P = logits.shape[1] - tokens.shape[1]
    pred = logits[:, P:-1]
    tgt = tokens[:, 1:].long()
    logz = torch.logsumexp(pred, dim=-1)
    gold = torch.gather(pred, -1, tgt[..., None])[..., 0]
    nll = (logz - gold).mean()
    loss = nll + out["aux"]
    return loss, {"nll": nll, "aux": out["aux"]}


def lm_loss(cfg: ModelConfig, params, batch: Dict) -> Tuple[torch.Tensor,
                                                            Dict]:
    """The training loss of ``batch`` through ``train_forward``."""
    return loss_terms(train_forward(cfg, params, batch), batch["tokens"])


def value_and_grad(cfg: ModelConfig, params, batch: Dict):
    """((loss, {"nll", "aux"}), grads): the loss and its gradient with
    respect to every leaf of ``params`` (a tree of the same structure;
    zeros where a leaf does not reach the loss).  The leaves take
    ``requires_grad`` for the call only."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, met = lm_loss(cfg, params, batch)
        flat = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    flat = iter([torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, flat)])
    grads = tree_map(lambda p: next(flat), params)
    met = {k: v.detach() for k, v in met.items()}
    return (loss.detach(), met), grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    grad_constraint=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients, then one AdamW update in
    place, weight decay masked as the JAX package's (``decay_mask``,
    derived at the first call).  ``grad_constraint`` (the JAX package's
    ``grad_shardings``): a function applied to the gradient tree before
    the update, e.g. a redistribution of sharded gradients to their
    parameters' placements (``launch.specs``)."""
    decay = {}

    def train_step(params, opt_state, batch):
        if not decay:
            decay["mask"] = decay_mask(cfg, params)
        (loss, met), grads = value_and_grad(cfg, params, batch)
        if grad_constraint is not None:
            grads = grad_constraint(grads)
        params, opt_state, opt_met = adamw_update(
            opt_cfg, params, grads, opt_state, decay=decay["mask"])
        met = dict(met, loss=loss, **opt_met)
        return params, opt_state, met
    return train_step


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (``data_iterator``'s) as tensors on
    ``device``."""
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


class Trainer:
    """Weights, optimizer state and the step.  ``params`` (a tree in the
    port's layout, e.g. ``bridge.params_from_jax``) replaces the random
    ``init_params(cfg, seed, dtype)`` weights; the trainer updates it in
    place.  ``device``: see ``repro_torch.resolve_device``."""

    def __init__(self, cfg: ModelConfig, opt_cfg: AdamWConfig = None,
                 *, seed: int = 0, dtype=torch.float32, device=None,
                 params=None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.device = resolve_device(device)
        self.params = (init_params(cfg, seed, dtype, self.device)
                       if params is None else params)
        self.opt_state = init_opt_state(self.params)
        self._step = make_train_step(cfg, self.opt_cfg)

    def step(self, batch: Dict) -> Dict[str, Any]:
        self.params, self.opt_state, met = self._step(
            self.params, self.opt_state, to_device(batch, self.device))
        return {k: float(v) for k, v in met.items()}

    def fit(self, data_iter, n_steps: int, log_every: int = 10,
            log_fn=print):
        hist = []
        for i in range(n_steps):
            met = self.step(next(data_iter))
            hist.append(met)
            if log_fn and (i % log_every == 0 or i == n_steps - 1):
                log_fn(f"step {i:5d} loss={met['loss']:.4f} "
                       f"nll={met['nll']:.4f} lr={met['lr']:.2e} "
                       f"gnorm={met['grad_norm']:.2f}")
        return hist
