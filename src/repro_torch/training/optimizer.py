"""AdamW + cosine LR schedule, in PyTorch (no ``torch.optim``).

The counterpart of ``repro.training.optimizer``, with its signatures and
its ``{"mu", "nu", "step"}`` state over the port's parameter tree (plain
dicts and lists of tensors, ``repro_torch.models.model``).  Two
differences of form, none of value:

- the update runs leaf by leaf in place, in fp32 arithmetic: each
  parameter, ``mu`` and ``nu`` keeps its own storage, so a model with
  fp32 parameters peaks at 16 bytes a parameter with its gradients
  (weights, gradients, ``mu``, ``nu``), not twice that.  ``mu`` and
  ``nu`` are fp32 from the start: the JAX state starts in the
  parameter's dtype and turns fp32 at the first update (a bf16 ``mu``
  times a float plus an fp32 gradient promotes), so after step 1 both
  hold the same values in the same dtype;
- weight decay follows a mask (``decay_mask``).  The JAX package decays
  a leaf when its ``ndim >= 2``, over a tree whose trunk layers and
  encoder layers are stacked on a leading axis, so every leaf of those
  layers decays (norm scales, biases and RG-LRU ``lam`` included) while
  the remainder layers' and the top level's 1-D leaves do not.  The
  port's layers are unstacked, so the same rule is derived once from
  the config.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


# ------------------------------------------------------------- tree helpers
def tree_leaves(tree) -> List[Any]:
    """The leaves of a tree of dicts and lists, dict keys in sorted
    order (as JAX flattens a dict)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of the
    trees in ``rest``), keeping its structure; leaves are visited in
    ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


# ------------------------------------------------------------------ schedule
def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step``: linear warm-up, then a cosine down
    to ``min_lr_ratio`` of the peak; an fp32 scalar on the CPU, computed
    in fp32 as the JAX package does, with the cosine itself rounded from
    fp64 (XLA's and PyTorch's fp32 cosines differ in the last bit)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cosine = torch.cos(math.pi * prog.double()).float()
    cos = cfg.lr * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio)
                    * 0.5 * (1 + cosine))
    return torch.where(step < cfg.warmup_steps, warm, cos)


# --------------------------------------------------------------------- state
def decay_mask(cfg, params):
    """A tree of bools beside ``params``: True where the JAX package's
    ``ndim >= 2`` test decays the leaf in its stacked layout.  Every leaf
    of a trunk layer (the first ``n_pattern_reps * pattern_len`` entries
    of ``params["layers"]``) and of an encoder layer decays; every other
    leaf decays when it has two or more dimensions."""
    def own(t):
        return tree_map(lambda p: p.ndim >= 2, t)

    def every(t):
        return tree_map(lambda p: True, t)

    n_trunk = cfg.n_pattern_reps * cfg.pattern_len
    mask = {k: own(v) for k, v in params.items()}
    mask["layers"] = [every(lp) if i < n_trunk else own(lp)
                      for i, lp in enumerate(params["layers"])]
    if "enc" in params:
        mask["enc"]["layers"] = [every(lp) for lp in params["enc"]["layers"]]
    return mask


def init_opt_state(params) -> dict:
    """fp32 zeros for ``mu`` and ``nu`` beside every leaf; ``step`` 0."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": 0}


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of every leaf together: the fp32 sum of each leaf's
    squares, as the JAX package sums them (``linalg.vector_norm`` on the
    CPU is ~1e-6 less accurate, which the clip scale would carry into
    every update)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


# -------------------------------------------------------------------- update
@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state, *, decay
                 ) -> Tuple[Any, dict, dict]:
    """One AdamW step with global-norm clipping, in place.  ``decay`` is
    the weight-decay mask beside ``params`` (``decay_mask`` for a
    model's).  Returns (params, state, metrics) with metrics {"lr",
    "grad_norm"}; ``params`` and the state's ``mu``/``nu`` are the
    tensors given, updated."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    stepf = torch.tensor(float(step), dtype=torch.float32)
    b1c = 1.0 - cfg.beta1 ** stepf
    b2c = 1.0 - cfg.beta2 ** stepf
    for p, g, mu, nu, wd in zip(tree_leaves(params), tree_leaves(grads),
                                tree_leaves(state["mu"]),
                                tree_leaves(state["nu"]),
                                tree_leaves(decay)):
        g = g.float() * scale
        mu.mul_(cfg.beta1).add_(g, alpha=1 - cfg.beta1)
        nu.mul_(cfg.beta2).addcmul_(g, g, value=1 - cfg.beta2)
        delta = (mu / b1c).div_((nu / b2c).sqrt_().add_(cfg.eps))
        if wd:
            delta.add_(p.float(), alpha=cfg.weight_decay)
        if p.dtype == torch.float32:
            p.sub_(lr * delta)
        else:
            p.copy_(p.float().sub_(lr * delta))
    state = {"mu": state["mu"], "nu": state["nu"], "step": step}
    return params, state, {"lr": lr, "grad_norm": gnorm}
