"""The port's dense model against the JAX package on the same weights.

The JAX parameters go through ``repro_torch.bridge`` (numpy in between);
then prefill ``forward`` (logits and per-layer K/V) and the paged
``decode_step`` of both packages run on the same tokens, the same page
table (shuffled page ids, a FREE row) and teacher-forced inputs.  Three
reduced dense archs cover the layer variants: qwen2.5-3b (RMS norm, GQA,
QKV bias, tied embeddings), stablelm-1.6b (LayerNorm, 25% rotary, MHA) and
starcoder2-3b (sliding window, gelu, MLP bias).  fp32; the two packages
sum in different orders, so logits and K/V agree within 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import (decode_step, forward, init_paged_cache,
                          init_params, paged_prefill_scatter)
from repro_torch import configs as pconfigs
from repro_torch import models as pm
from repro_torch.bridge import params_from_jax

TOL = 1e-4
ARCHS = ["qwen2.5-3b", "stablelm-1.6b", "starcoder2-3b"]
PS, MP = 4, 6                  # page size, table width (24 tokens per slot)
LENS = [9, 14]                 # prompt lengths of the two live slots
STEPS = 3


def _cfgs(arch):
    cfg = reduced(get_config(arch), d_model=64)
    pcfg = pconfigs.reduced(pconfigs.get_config(arch), d_model=64)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(pcfg)
    return cfg, pcfg


def _pair(arch):
    cfg, pcfg = _cfgs(arch)
    jp = init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(pcfg, jax.device_get(jp), device="cpu")
    return cfg, pcfg, jp, tp


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def test_bridge_unstacks_trunk_per_layer():
    cfg, pcfg, jp, tp = _pair("qwen2.5-3b")
    assert len(tp["layers"]) == cfg.n_layers
    for i, lp in enumerate(tp["layers"]):
        np.testing.assert_array_equal(
            _np(lp["attn"]["wq"]), np.asarray(jp["trunk"][0]["attn"]["wq"][i]))
    np.testing.assert_array_equal(_np(tp["embed"]), np.asarray(jp["embed"]))
    assert "head" not in tp                       # tied embeddings kept


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    cfg, pcfg, jp, tp = _pair(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 13))
    S = toks.shape[1]
    out = forward(cfg, jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                  build_cache=True, cache_len=S)
    pout = pm.forward(pcfg, tp, {"tokens": torch.from_numpy(toks)},
                      build_cache=True)
    np.testing.assert_allclose(_np(pout["logits"]), _np(out["logits"]),
                               atol=TOL, rtol=TOL)
    for i, (k, v) in enumerate(pout["kv"]):
        jk = out["cache"]["trunk"][0]["k"][i][:, :S]
        jv = out["cache"]["trunk"][0]["v"][i][:, :S]
        np.testing.assert_allclose(_np(k), _np(jk), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(_np(v), _np(jv), atol=TOL, rtol=TOL)


def _table(n_slots, n_pages):
    """Rows for the two live slots from a shuffled pool; the last slot is
    FREE (row all -1) and its appends land on the trash page."""
    rng = np.random.default_rng(3)
    ids = list(rng.permutation(n_pages))
    table = np.full((n_slots, MP), -1, np.int32)
    for b in range(len(LENS)):
        for c in range(MP):
            table[b, c] = ids.pop()
    return table


@pytest.mark.parametrize("arch,impl", [(a, "xla") for a in ARCHS]
                         + [("qwen2.5-3b", "pallas")])
def test_paged_decode_matches_jax(arch, impl):
    """Prefill two slots into the pool, then decode STEPS teacher-forced
    ticks with a FREE third row: the live rows' logits agree with the JAX
    paged decode (its XLA path, and once its Pallas fused kernel in
    interpret mode) for both port paths, and the pools agree outside the
    trash page."""
    cfg, pcfg, jp, tp = _pair(arch)
    n_slots, n_pages = 3, 2 * MP
    table = _table(n_slots, n_pages)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)) for n in LENS]
    feed = rng.integers(0, cfg.vocab_size, (STEPS, n_slots))

    jc = init_paged_cache(cfg, n_slots, page_size=PS, n_pages=n_pages,
                          max_pages=MP)
    jc["pages"] = jnp.asarray(table)
    for slot, pr in enumerate(prompts):
        o = forward(cfg, jp, {"tokens": jnp.asarray(pr, jnp.int32)},
                    build_cache=True, cache_len=MP * PS)
        jc = paged_prefill_scatter(cfg, jc, o["cache"], slot,
                                   jc["pages"][slot], n_tokens=pr.shape[1])
    jlog = []
    for t in range(STEPS):
        lg, jc = decode_step(cfg, jp, jc, jnp.asarray(feed[t], jnp.int32),
                             jc["pos"], attn_impl=impl)
        jlog.append(_np(lg))

    for port_impl in ("kernel", "plain"):
        tc = pm.init_paged_cache(pcfg, n_slots, page_size=PS,
                                 n_pages=n_pages, max_pages=MP, device="cpu")
        tc["pages"] = torch.from_numpy(table)
        for slot, pr in enumerate(prompts):
            o = pm.forward(pcfg, tp, {"tokens": torch.from_numpy(pr)},
                           build_cache=True, attn_impl=port_impl)
            pm.paged_prefill_scatter(pcfg, tc, o["kv"], slot,
                                     tc["pages"][slot])
        for t in range(STEPS):
            lg, tc = pm.decode_step(pcfg, tp, tc, torch.from_numpy(feed[t]),
                                    tc["pos"], attn_impl=port_impl)
            # the FREE row's logits are never read (its all-masked XLA
            # softmax and the fused kernel's new-token-only softmax differ
            # within the JAX package too): compare the live rows
            live = len(LENS)
            np.testing.assert_allclose(_np(lg)[:live], jlog[t][:live],
                                       atol=TOL, rtol=TOL,
                                       err_msg=f"{port_impl} step {t}")
        assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()
        for i, pool in enumerate(tc["layers"]):
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    _np(pool[name])[:n_pages],
                    _np(jc["trunk"][0][name][i])[:n_pages],
                    atol=TOL, rtol=TOL)


def test_other_families_raise():
    pcfg = pconfigs.reduced(pconfigs.get_config("recurrentgemma-2b"),
                            d_model=64)
    with pytest.raises(NotImplementedError):
        pm.init_params(pcfg, device="cpu")
