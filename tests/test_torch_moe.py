"""The port's MoE family against the JAX package, on the same weights.

Reduced ``qwen2-moe-a2.7b`` (top-2 of 8 experts and a shared expert) and
``llama4-maverick-400b-a17b`` (top-1 of 8 experts and a shared expert;
dense and MoE layers interleaved, a 64-token window and a global layer)
at ``d_model`` 64; the JAX parameters go through ``repro_torch.bridge``.
Held to the JAX package:
- ``apply_moe`` at the training capacity factor 1.25 (tokens dropped:
  the case asserts that some expert overflows) and with no drops
  (``capacity_factor=None``): outputs within TOL in fp32 and a 2e-2
  relative norm in bf16, the load-balance ``aux`` within TOL, and the
  chosen expert ids equal;
- the engines' greedy tokens: paged (prefix sharing on) and striped;
- ``apply_layer_range`` chained over two ranges, and the live cluster's
  forward at every multicast step (k=2 sources scaling to 6 nodes), each
  against the JAX ``forward`` with ``moe_cf=None``.
The port's own forms are held to each other: the grouped prefill form to
the static one, and the in-place decode step (what the card captures)
bitwise to the functional one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models.moe import apply_moe as jax_apply_moe
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro_torch import configs as pconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.core.blocks import flatten_params
from repro_torch.core.partial_exec import (apply_layer_range,
                                           embed_from_flat, head_from_flat)
from repro_torch.models import decode_step, decode_step_inplace, init_params
from repro_torch.models import moe as tmoe
from repro_torch.models.cache_ops import _leaves
from repro_torch.serving import ContinuousBatchingEngine, LiveCluster

TOL = 1e-4
BF16_TOL = 2e-2
QWEN, LLAMA4 = "qwen2-moe-a2.7b", "llama4-maverick-400b-a17b"
ARCHS = (QWEN, LLAMA4)
EXPERTS = 8
MAX_LEN = 48
PAGE_SIZE = 16
_CTX = {}


def _cfgs(arch, n_layers=None):
    cfg = reduced(get_config(arch), d_model=64, n_layers=n_layers,
                  max_experts=EXPERTS)
    pcfg = pconfigs.reduced(pconfigs.get_config(arch), d_model=64,
                            n_layers=n_layers, max_experts=EXPERTS)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(pcfg)
    return cfg, pcfg


def _ctx(arch, dtype=jnp.float32):
    key = (arch, jnp.dtype(dtype).name)
    if key not in _CTX:
        cfg, pcfg = _cfgs(arch)
        jp = jax_init_params(cfg, jax.random.PRNGKey(0), dtype)
        _CTX[key] = dict(cfg=cfg, pcfg=pcfg, jp=jp,
                         tp=params_from_jax(pcfg, jax.device_get(jp),
                                            device="cpu"))
    return _CTX[key]


def _moe_layer(c):
    """(JAX moe params, port moe params) of the first MoE layer."""
    cfg = c["cfg"]
    li = next(i for i in range(cfg.n_layers) if cfg.ffn_of(i) == "moe")
    pi, rep = li % cfg.pattern_len, li // cfg.pattern_len
    jmoe = jax.tree.map(lambda a: a[rep], c["jp"]["trunk"][pi]["moe"])
    return jmoe, c["tp"]["layers"][li]["moe"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _x(d, dtype, S=32):
    """Activations with a component every token shares, so the router
    favours some experts (and the capacity factor drops pairs)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, S, d), np.float32) \
        + rng.standard_normal((d,), np.float32)
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cf", [1.25, None], ids=["cf1.25", "no-drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch, cf, dtype):
    c = _ctx(arch, dtype)
    cfg, pcfg = c["cfg"], c["pcfg"]
    jmoe, pmoe = _moe_layer(c)
    jx, tx = _x(cfg.d_model, dtype)
    want, want_aux = jax_apply_moe(jmoe, jx, cfg, capacity_factor=cf)
    got, got_aux = tmoe.apply_moe(pmoe, tx, pcfg, capacity_factor=cf)
    assert got.dtype == tx.dtype
    # the same experts chosen for every token
    T = tx.shape[0] * tx.shape[1]
    probs = jax.nn.softmax((jx.reshape(T, -1) @ jmoe["router"]).astype(
        jnp.float32), axis=-1)
    _, jeid = jax.lax.top_k(probs, cfg.top_k)
    _, _, teid = tmoe.route(pmoe, tx.reshape(T, -1), pcfg)
    np.testing.assert_array_equal(teid.numpy(), np.asarray(jeid))
    if cf is not None:
        counts = np.bincount(np.asarray(jeid).ravel(), minlength=cfg.n_experts)
        C = tmoe.capacity(T * cfg.top_k, cfg.n_experts, cf)
        assert counts.max() > C, "no expert overflows: nothing is dropped"
    if dtype == jnp.float32:
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)
    else:
        # the two frameworks round bf16 at other places (JAX's silu rounds
        # its sigmoid to bf16 first): elements differ by an ulp, so the
        # output is held to a relative norm, as the bf16 xLSTM blocks are
        rel = np.linalg.norm(_np(got) - _np(want)) / np.linalg.norm(
            _np(want))
        assert rel < BF16_TOL, rel
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_form_equals_static_form(arch):
    """The prefill's grouped form against the static (decode, reference)
    form with no drops: the same pairs, the same combine order."""
    c = _ctx(arch)
    _, pmoe = _moe_layer(c)
    _, tx = _x(c["pcfg"].d_model, jnp.float32, S=40)
    static, aux_s = tmoe.apply_moe(pmoe, tx, c["pcfg"], capacity_factor=None)
    grouped, aux_g = tmoe.apply_moe(pmoe, tx, c["pcfg"],
                                    capacity_factor=None, grouped=True)
    np.testing.assert_allclose(grouped.numpy(), static.numpy(), atol=TOL,
                               rtol=TOL)
    assert torch.equal(aux_s, aux_g)
    with pytest.raises(ValueError):
        tmoe.apply_moe(pmoe, tx, c["pcfg"], grouped=True)


def _trace(vocab=512):
    """Four prompts: two share a 20-token prefix (a full page matches,
    the second diverges mid-page), two are unrelated."""
    rng = np.random.default_rng(31)
    tok = lambda n: list(map(int, rng.integers(0, vocab, n)))  # noqa: E731
    pre = tok(20)
    prompts = [pre + tok(7), tok(13), pre[:18] + tok(9), tok(5)]
    return [(p, 4 + 2 * i) for i, p in enumerate(prompts)]


def _run(eng, trace):
    for i, (p, n) in enumerate(trace):
        eng.submit(p, n, req_id=i)
    return eng.run()


@pytest.mark.parametrize("arch,paged", [(QWEN, True), (QWEN, False),
                                        (LLAMA4, True)],
                         ids=["qwen-paged", "qwen-striped", "llama4-paged"])
def test_engine_tokens_equal_jax(arch, paged):
    c = _ctx(arch)
    trace = _trace()
    kw = dict(n_slots=3, max_len=MAX_LEN, paged=paged)
    if paged:
        kw["page_size"] = PAGE_SIZE
    want = _run(JaxEngine(c["cfg"], c["jp"], **kw), trace)
    eng = ContinuousBatchingEngine(c["pcfg"], c["tp"], **kw)
    assert _run(eng, trace) == want
    if paged:
        assert eng.stats["shared_tokens"] > 0


def _live_cache(dtype, paged):
    """A qwen2-moe engine mid-generation (3 live slots), its weights from
    the port's own init in ``dtype``."""
    _, pcfg = _cfgs(QWEN)
    params = init_params(pcfg, seed=3, dtype=dtype, device="cpu")
    kw = {"page_size": PAGE_SIZE} if paged else {}
    eng = ContinuousBatchingEngine(pcfg, params, n_slots=3, max_len=MAX_LEN,
                                   paged=paged, max_prefill_per_tick=3, **kw)
    for i, (p, _) in enumerate(_trace()[:3]):
        eng.submit(p, 10, req_id=i)
    for _ in range(3):
        eng.step()
    return pcfg, params, eng


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "striped"])
def test_inplace_step_bitwise_equals_decode_step(paged, dtype):
    pcfg, params, eng = _live_cache(dtype, paged)
    a, b = _clone(eng.cache), _clone(eng.cache)
    ptrs = [t.data_ptr() for t in _leaves(b)]
    tok = eng._tok.clone()
    for _ in range(3):
        want, a = decode_step(pcfg, params, a, tok, a["pos"])
        got = decode_step_inplace(pcfg, params, b, tok)
        assert torch.equal(got, want)
        tok = want.argmax(-1)
    assert [t.data_ptr() for t in _leaves(b)] == ptrs
    for x, y in zip(_leaves(a), _leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _batch(vocab, S=32):
    toks = np.random.default_rng(7).integers(0, vocab, (2, S))
    return jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)


def test_chained_layer_ranges_equal_jax_forward():
    """``tests/test_partial_exec.py`` for qwen2-moe: embed, two chained
    layer ranges and the head from the flat unit dict."""
    c = _ctx(QWEN)
    cfg, pcfg = c["cfg"], c["pcfg"]
    jt, tt = _batch(cfg.vocab_size)
    ref = jax_forward(cfg, c["jp"], {"tokens": jt}, moe_cf=None)["logits"]
    flat = flatten_params(pcfg, c["tp"])
    B, S = tt.shape
    positions = torch.arange(S).expand(B, S)
    x = embed_from_flat(pcfg, flat, tt)
    mid = max(1, pcfg.n_layers // 2)
    x = apply_layer_range(pcfg, flat, x, 0, mid, positions)
    x = apply_layer_range(pcfg, flat, x, mid, pcfg.n_layers, positions)
    out = head_from_flat(pcfg, flat, x)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4,
                               rtol=2e-4)


def test_live_cluster_serves_moe_at_every_step():
    """``tests/test_live_cluster.py``'s qwen2-moe case (k=2, n=6, 8
    layers, 8 blocks): every forward the cluster serves, in pipeline or
    local mode, is within 2e-4 of the JAX forward; every node ends
    local."""
    cfg, pcfg = _cfgs(QWEN, n_layers=8)
    jp = jax_init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(pcfg, jax.device_get(jp), device="cpu")
    jt, tt = _batch(cfg.vocab_size)
    ref = np.asarray(jax_forward(cfg, jp, {"tokens": jt},
                                 moe_cf=None)["logits"])
    n, k = 6, 2
    lc = LiveCluster(n_nodes=n, max_len=64, device="cpu")
    lc.register("m", pcfg, tp, n_blocks=8, hot_nodes=list(range(k)))
    lc.scale("m", n - k, k=k)
    modes = set()
    while True:
        r = lc.forward("m", tt)
        if r is not None:
            err = float(np.abs(r["logits"].numpy() - ref).max())
            assert err < 2e-4, (r["mode"], err)
            modes.add(r["mode"])
        if not lc.step():
            break
    final = lc.forward("m", tt)
    assert final["mode"] == "local"
    assert float(np.abs(final["logits"].numpy() - ref).max()) < 2e-4
    assert len(lc.complete_nodes("m")) == n
    assert "local" in modes
