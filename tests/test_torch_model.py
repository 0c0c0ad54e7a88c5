"""The port's model against the JAX package on the same weights.

The JAX parameters go through ``repro_torch.bridge`` (numpy in between);
then prefill ``forward`` (logits and per-layer K/V or RG-LRU state) and
the paged and striped ``decode_step`` of both packages run on the same
tokens, the same page table (shuffled page ids, a FREE row) and
teacher-forced inputs.  Three reduced dense archs cover the layer
variants: qwen2.5-3b (RMS norm, GQA, QKV bias, tied embeddings),
stablelm-1.6b (LayerNorm, 25% rotary, MHA) and starcoder2-3b (sliding
window, gelu, MLP bias); reduced recurrentgemma-2b at five layers runs one
(rec, rec, attn) pattern repetition and the two-layer rec remainder, MQA,
the embedding scale and a 64-token attention window; reduced xlstm-1.3b
(d_model 64, eight layers: seven mLSTM blocks with head dim 32 and one
sLSTM block with head dim 16) runs the ssm family, with no attention
layer at all.  fp32; the two packages sum in different orders, so logits,
K/V and state agree within 1e-4.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import (batch_axes, cache_gather, cache_scatter,
                          decode_step, forward, init_cache, init_paged_cache,
                          init_params, paged_prefill_scatter)
from repro.models import xlstm as jx
from repro_torch.models import xlstm as tx
from repro_torch import configs as pconfigs
from repro_torch import models as pm
from repro_torch.bridge import params_from_jax

TOL = 1e-4
ARCHS = ["qwen2.5-3b", "stablelm-1.6b", "starcoder2-3b"]
PS, MP = 4, 6                  # page size, table width (24 tokens per slot)
LENS = [9, 14]                 # prompt lengths of the two live slots
STEPS = 3


HYBRID = "recurrentgemma-2b"
HYBRID_LAYERS = 5              # one (rec, rec, attn) rep + 2 rec remainder


def _cfgs(arch):
    n_layers = HYBRID_LAYERS if arch == HYBRID else None
    cfg = reduced(get_config(arch), d_model=64, n_layers=n_layers)
    pcfg = pconfigs.reduced(pconfigs.get_config(arch), d_model=64,
                            n_layers=n_layers)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(pcfg)
    return cfg, pcfg


def _pair(arch, **bridge_kw):
    cfg, pcfg = _cfgs(arch)
    jp = init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(pcfg, jax.device_get(jp), device="cpu", **bridge_kw)
    return cfg, pcfg, jp, tp


def _jax_layer(cache, cfg, i):
    """Layer ``i``'s entry of a JAX cache (trunk leaves carry the pattern
    repetition on axis 0; the remainder layers follow the trunk)."""
    n_trunk = cfg.n_pattern_reps * cfg.pattern_len
    if i >= n_trunk:
        return cache["rem"][i - n_trunk]
    return jax.tree.map(lambda a: a[i // cfg.pattern_len],
                        cache["trunk"][i % cfg.pattern_len])


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
                           build_cache=True, kernel_impl=port_impl)
            pm.paged_prefill_scatter(pcfg, tc, o["kv"], slot,
                                     tc["pages"][slot], pr.shape[1])
        for t in range(STEPS):
            lg, tc = pm.decode_step(pcfg, tp, tc, torch.from_numpy(feed[t]),
                                    tc["pos"], kernel_impl=port_impl)
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


@pytest.mark.parametrize("arch", ["pixtral-12b", "qwen2-moe-a2.7b"])
def test_other_families_raise(arch):
    pcfg = pconfigs.reduced(pconfigs.get_config(arch), d_model=64)
    with pytest.raises(NotImplementedError):
        pm.init_params(pcfg, device="cpu")


# ------------------------------------------------------------ hybrid family
def test_bridge_keeps_lam_fp32_under_bf16():
    cfg, pcfg, jp, tp = _pair(HYBRID, dtype=torch.bfloat16)
    mixers = [e.split(":")[0] for e in
              (cfg.layer_pattern[i % cfg.pattern_len]
               for i in range(cfg.n_layers))]
    assert mixers == ["rec", "rec", "attn", "rec", "rec"]
    for i, (lp, mixer) in enumerate(zip(tp["layers"], mixers)):
        if mixer != "rec":
            assert lp["attn"]["wq"].dtype == torch.bfloat16
            continue
        assert lp["rec"]["lam"].dtype == torch.float32
        assert lp["rec"]["w_x"].dtype == torch.bfloat16
        want = np.asarray(_jax_layer(jp, cfg, i)["rec"]["lam"])
        np.testing.assert_array_equal(lp["rec"]["lam"].numpy(), want)
    native = pm.init_params(pcfg, device="cpu", dtype=torch.bfloat16)
    assert native["layers"][0]["rec"]["lam"].dtype == torch.float32


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_hybrid_forward_matches_jax(impl):
    """80-token prompts, past the 64-token window: logits, every rec
    layer's final state and the attention layer's ring (the last 64
    tokens at their ring slots)."""
    cfg, pcfg, jp, tp = _pair(HYBRID)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 80))
    out = forward(cfg, jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                  build_cache=True, cache_len=96)
    pout = pm.forward(pcfg, tp, {"tokens": torch.from_numpy(toks)},
                      build_cache=True, kernel_impl=impl)
    np.testing.assert_allclose(_np(pout["logits"]), _np(out["logits"]),
                               atol=TOL, rtol=TOL)
    last = pm.forward(pcfg, tp, {"tokens": torch.from_numpy(toks)},
                      last_only=True, kernel_impl=impl)["logits"]
    np.testing.assert_allclose(_np(last), _np(out["logits"])[:, -1:],
                               atol=TOL, rtol=TOL)
    ring = pm.cache_from_prefill(pcfg, pout["kv"], 96, toks.shape[1])
    assert ring["pos"].tolist() == np.asarray(out["cache"]["pos"]).tolist()
    for i in range(cfg.n_layers):
        want = _jax_layer(out["cache"], cfg, i)
        got = ring["layers"][i]
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_allclose(_np(got[name]), _np(want[name]),
                                       atol=TOL, rtol=TOL,
                                       err_msg=f"layer {i} {name}")


@pytest.mark.parametrize("arch", [HYBRID, "qwen2.5-3b"])
def test_striped_decode_past_window_matches_jax(arch):
    """Teacher-forced striped decode from a prefill cache, 20 steps past
    the ring's first wrap (hybrid: window 64; qwen2.5-3b: a linear cache),
    mirroring tests/test_decode_equivalence.py: logits of every step and
    the final caches agree with JAX, for both port paths."""
    cfg, pcfg, jp, tp = _pair(arch)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 50))
    feed = rng.integers(0, cfg.vocab_size, (20, 2))
    max_len = 72
    out = forward(cfg, jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                  build_cache=True, cache_len=max_len)
    jc, jlog = out["cache"], []
    step = jax.jit(functools.partial(decode_step, cfg))
    for t in range(len(feed)):
        lg, jc = step(jp, jc, jnp.asarray(feed[t], jnp.int32), jc["pos"])
        jlog.append(_np(lg))
    for impl in ("kernel", "plain"):
        o = pm.forward(pcfg, tp, {"tokens": torch.from_numpy(toks)},
                       build_cache=True, kernel_impl=impl)
        tc = pm.cache_from_prefill(pcfg, o["kv"], max_len, toks.shape[1])
        for t in range(len(feed)):
            lg, tc = pm.decode_step(pcfg, tp, tc, torch.from_numpy(feed[t]),
                                    tc["pos"], kernel_impl=impl)
            np.testing.assert_allclose(_np(lg), jlog[t], atol=TOL, rtol=TOL,
                                       err_msg=f"{impl} step {t}")
        assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()
        for i in range(cfg.n_layers):
            want = _jax_layer(jc, cfg, i)
            for name in want:
                np.testing.assert_allclose(
                    _np(tc["layers"][i][name]), _np(want[name]), atol=TOL,
                    rtol=TOL, err_msg=f"{impl} layer {i} {name}")


@pytest.mark.parametrize("arch", ["qwen2.5-3b", HYBRID])
def test_cache_scatter_gather_match_jax(arch):
    """A batch-1 striped prefill cache scattered into slot 1 of a 3-slot
    pool, then gathered back, in both packages: the pools agree leaf by
    leaf (slots 0 and 2 still empty) and so do the gathered caches."""
    cfg, pcfg, jp, tp = _pair(arch)
    max_len = 72
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 50))
    out = forward(cfg, jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                  build_cache=True, cache_len=max_len)
    axes = batch_axes(init_cache(cfg, 3, max_len),
                      init_cache(cfg, 1, max_len))
    jpool = cache_scatter(init_cache(cfg, 3, max_len), out["cache"], 1, axes)
    jback = cache_gather(jpool, 1, axes)
    o = pm.forward(pcfg, tp, {"tokens": torch.from_numpy(toks)},
                   build_cache=True)
    tpool = pm.cache_scatter(pm.init_cache(pcfg, 3, max_len, device="cpu"),
                             pm.cache_from_prefill(pcfg, o["kv"], max_len,
                                                   toks.shape[1]), 1)
    tback = pm.cache_gather(tpool, 1)
    for got, want in ((tpool, jpool), (tback, jback)):
        assert got["pos"].tolist() == np.asarray(want["pos"]).tolist()
        for i in range(cfg.n_layers):
            jl = _jax_layer(want, cfg, i)
            assert sorted(got["layers"][i]) == sorted(jl)
            for name in jl:
                np.testing.assert_allclose(
                    _np(got["layers"][i][name]), _np(jl[name]), atol=TOL,
                    rtol=TOL, err_msg=f"layer {i} {name}")


def test_hybrid_paged_decode_matches_jax():
    """Two slots prefilled into shuffled pages (one prompt past the
    window: JAX scatters its 64-entry ring, the port every token, which
    decode masks), a FREE third row, teacher-forced ticks past the
    window: live rows' logits and the rec state agree with JAX."""
    cfg, pcfg, jp, tp = _pair(HYBRID)
    ps, mp, lens, n_slots = 4, 24, [70, 30], 3
    n_pages = len(lens) * mp
    rng = np.random.default_rng(5)
    ids = list(rng.permutation(n_pages))
    table = np.full((n_slots, mp), -1, np.int32)
    for b in range(len(lens)):
        table[b] = [ids.pop() for _ in range(mp)]
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)) for n in lens]
    feed = rng.integers(0, cfg.vocab_size, (8, n_slots))

    jc = init_paged_cache(cfg, n_slots, page_size=ps, n_pages=n_pages,
                          max_pages=mp)
    jc["pages"] = jnp.asarray(table)
    for slot, pr in enumerate(prompts):
        o = forward(cfg, jp, {"tokens": jnp.asarray(pr, jnp.int32)},
                    build_cache=True, cache_len=mp * ps)
        jc = paged_prefill_scatter(cfg, jc, o["cache"], slot,
                                   jc["pages"][slot], n_tokens=pr.shape[1])
    jlog = []
    step = jax.jit(functools.partial(decode_step, cfg))
    for t in range(len(feed)):
        lg, jc = step(jp, jc, jnp.asarray(feed[t], jnp.int32), jc["pos"])
        jlog.append(_np(lg))

    for impl in ("kernel", "plain"):
        tc = pm.init_paged_cache(pcfg, n_slots, page_size=ps,
                                 n_pages=n_pages, max_pages=mp, device="cpu")
        tc["pages"] = torch.from_numpy(table)
        for slot, pr in enumerate(prompts):
            o = pm.forward(pcfg, tp, {"tokens": torch.from_numpy(pr)},
                           build_cache=True, kernel_impl=impl)
            pm.paged_prefill_scatter(pcfg, tc, o["kv"], slot,
                                     tc["pages"][slot], pr.shape[1])
        for t in range(len(feed)):
            lg, tc = pm.decode_step(pcfg, tp, tc, torch.from_numpy(feed[t]),
                                    tc["pos"], kernel_impl=impl)
            live = len(lens)
            np.testing.assert_allclose(_np(lg)[:live], jlog[t][:live],
                                       atol=TOL, rtol=TOL,
                                       err_msg=f"{impl} step {t}")
        for i in (0, 1, 3, 4):                         # the rec layers
            want = _jax_layer(jc, cfg, i)
            for name in ("h", "conv"):
                np.testing.assert_allclose(
                    _np(tc["layers"][i][name])[:live],
                    _np(want[name])[:live], atol=TOL, rtol=TOL)


# --------------------------------------------------------------- ssm family
SSM = "xlstm-1.3b"
SSM_MIXERS = ["mlstm"] * 7 + ["slstm"]
MLSTM_KEEP = ("w_i", "w_f", "b_i", "b_f")


def test_bridge_keeps_xlstm_gates_fp32_under_bf16():
    """JAX keeps the mLSTM gate weights and the sLSTM recurrence fp32 in a
    bf16 model; the bridge and the port's own init do the same."""
    cfg, pcfg, jp, tp = _pair(SSM, dtype=torch.bfloat16)
    mixers = [cfg.layer_pattern[i % cfg.pattern_len].split(":")[0]
              for i in range(cfg.n_layers)]
    assert mixers == SSM_MIXERS
    native = pm.init_params(pcfg, device="cpu", dtype=torch.bfloat16)
    for i, (lp, mixer) in enumerate(zip(tp["layers"], mixers)):
        assert sorted(lp) == sorted(["norm1", mixer])  # ffn "none": no MLP
        keep = MLSTM_KEEP if mixer == "mlstm" else ("r", "b")
        for params in (lp, native["layers"][i]):
            for name, t in params[mixer].items():
                want = torch.float32 if name in keep else torch.bfloat16
                assert t.dtype == want, (i, mixer, name, t.dtype)
        for name in keep:
            np.testing.assert_array_equal(
                lp[mixer][name].numpy(),
                np.asarray(_jax_layer(jp, cfg, i)[mixer][name]))


def test_xlstm_state_init_matches_jax():
    """sLSTM's normaliser starts at 1e-6 and both stabilisers at the
    finite -1e30 (exp(g + m - m_new) must give 0, not NaN)."""
    cfg, pcfg = _cfgs(SSM)
    for jfn, tfn in ((jx.init_mlstm_state, tx.init_mlstm_state),
                     (jx.init_slstm_state, tx.init_slstm_state)):
        want = jfn(cfg, 2, jnp.float32)
        got = tfn(pcfg, 2, torch.float32, "cpu")
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].dtype == torch.float32 or name == "conv"
            np.testing.assert_array_equal(_np(got[name]), _np(want[name]))
    assert float(tx.init_slstm_state(pcfg, 1, torch.float32, "cpu")
                 ["n"][0, 0]) == pytest.approx(1e-6)


@pytest.mark.parametrize("S", [13, 256])
def test_ssm_forward_matches_jax(S):
    """Logits and every layer's final state (mLSTM C, n, m, conv; sLSTM c,
    n, h, m) of a prefill; at S = 256 JAX takes its chunked branch, the
    port its 64-token chunks."""
    cfg, pcfg, jp, tp = _pair(SSM)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, S))
    out = forward(cfg, jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                  build_cache=True)
    for impl in ("kernel", "plain"):
        pout = pm.forward(pcfg, tp, {"tokens": torch.from_numpy(toks)},
                          build_cache=True, kernel_impl=impl)
        np.testing.assert_allclose(_np(pout["logits"]), _np(out["logits"]),
                                   atol=TOL, rtol=TOL, err_msg=impl)
        cache = pm.cache_from_prefill(pcfg, pout["kv"], S + 8, S)
        assert cache["pos"].tolist() == [S, S]
        for i in range(cfg.n_layers):
            want = _jax_layer(out["cache"], cfg, i)
            got = cache["layers"][i]
            assert sorted(got) == sorted(want)
            for name in want:
                np.testing.assert_allclose(_np(got[name]), _np(want[name]),
                                           atol=TOL, rtol=TOL,
                                           err_msg=f"{impl} layer {i} {name}")


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_xlstm_blocks_bf16_match_jax(block):
    """One block of a bf16 model (JAX's bf16 init, bridged as it is): the
    fp32 gate products, k divided by sqrt(dh) in the activation dtype, the
    sLSTM input product in the activation dtype cast to fp32 afterwards,
    the tanh GELU and the head norm's eps 1e-6 follow JAX.  The two
    frameworks round bf16 at other places (each lies about 1% from the
    fp32 result), so the output is held to a 2% relative norm and the fp32
    state to 5e-2; the gate pre-activations and the state stay fp32."""
    cfg, pcfg = _cfgs(SSM)
    jp = init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    tp = params_from_jax(pcfg, jax.device_get(jp), device="cpu")
    i = 0 if block == "mlstm" else 7
    jl = _jax_layer(jp, cfg, i)[block]
    x = np.random.default_rng(8).standard_normal((2, 70, cfg.d_model))
    txb = torch.tensor(x, dtype=torch.float32).to(torch.bfloat16)
    japply = jx.apply_mlstm if block == "mlstm" else jx.apply_slstm
    tapply = tx.apply_mlstm if block == "mlstm" else tx.apply_slstm
    jo, jst = japply(jl, jnp.asarray(x, jnp.bfloat16), cfg)
    to, tst = tapply(tp["layers"][i][block], txb, pcfg)
    assert to.dtype == torch.bfloat16
    rel = np.linalg.norm(_np(to) - _np(jo)) / np.linalg.norm(_np(jo))
    assert rel < 2e-2, rel
    for name in jst:
        assert (tst[name].dtype == torch.float32) == (name != "conv")
        np.testing.assert_allclose(_np(tst[name]), _np(jst[name]),
                                   atol=5e-2, rtol=5e-2, err_msg=name)
    if block == "mlstm":
        _, k, _, i_pre, f_pre, _, _ = tx._mlstm_qkvif(
            tp["layers"][i][block], txb, pcfg, tst["conv"])
        assert i_pre.dtype == f_pre.dtype == torch.float32
        assert k.dtype == torch.bfloat16


@pytest.mark.parametrize("layout", ["striped", "paged"])
def test_ssm_decode_matches_jax(layout):
    """Two prompts (70 tokens: past one 64-token chunk; 30) prefilled into
    a 3-slot cache, striped or paged (a page table and no pools, as JAX
    builds it), then 10 teacher-forced decode steps: every step's logits
    of the live rows and the final state of every layer agree with JAX."""
    cfg, pcfg, jp, tp = _pair(SSM)
    ps, mp, lens, n_slots = 16, 6, [70, 30], 3
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)) for n in lens]
    feed = rng.integers(0, cfg.vocab_size, (10, n_slots))
    table = np.full((n_slots, mp), -1, np.int32)
    table[:2] = rng.permutation(2 * mp).reshape(2, mp)
    if layout == "paged":
        jc = init_paged_cache(cfg, n_slots, page_size=ps, n_pages=2 * mp,
                              max_pages=mp)
        jc["pages"] = jnp.asarray(table)
    else:
        jc = init_cache(cfg, n_slots, mp * ps)
        axes = batch_axes(jc, init_cache(cfg, 1, mp * ps))
    for slot, pr in enumerate(prompts):
        o = forward(cfg, jp, {"tokens": jnp.asarray(pr, jnp.int32)},
                    build_cache=True, cache_len=mp * ps)
        if layout == "paged":
            jc = paged_prefill_scatter(cfg, jc, o["cache"], slot,
                                       jc["pages"][slot],
                                       n_tokens=pr.shape[1])
        else:
            jc = cache_scatter(jc, o["cache"], slot, axes)
    jlog = []
    step = jax.jit(functools.partial(decode_step, cfg))
    for t in range(len(feed)):
        lg, jc = step(jp, jc, jnp.asarray(feed[t], jnp.int32), jc["pos"])
        jlog.append(_np(lg))

    if layout == "paged":
        tc = pm.init_paged_cache(pcfg, n_slots, page_size=ps,
                                 n_pages=2 * mp, max_pages=mp, device="cpu")
        assert all("k" not in e for e in tc["layers"])   # no pools at all
        tc["pages"] = torch.from_numpy(table)
    else:
        tc = pm.init_cache(pcfg, n_slots, mp * ps, device="cpu")
    for slot, pr in enumerate(prompts):
        o = pm.forward(pcfg, tp, {"tokens": torch.from_numpy(pr)},
                       build_cache=True)
        if layout == "paged":
            pm.paged_prefill_scatter(pcfg, tc, o["kv"], slot,
                                     tc["pages"][slot], pr.shape[1])
        else:
            pm.cache_scatter(tc, pm.cache_from_prefill(
                pcfg, o["kv"], mp * ps, pr.shape[1]), slot)
    assert tc["pos"].tolist() == lens + [0]
    live = len(lens)
    for t in range(len(feed)):
        lg, tc = pm.decode_step(pcfg, tp, tc, torch.from_numpy(feed[t]),
                                tc["pos"])
        np.testing.assert_allclose(_np(lg)[:live], jlog[t][:live], atol=TOL,
                                   rtol=TOL, err_msg=f"step {t}")
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()
    if layout == "paged":
        assert torch.equal(tc["pages"], torch.from_numpy(table))
    for i in range(cfg.n_layers):
        want = _jax_layer(jc, cfg, i)
        assert sorted(tc["layers"][i]) == sorted(want)
        for name in want:
            np.testing.assert_allclose(
                _np(tc["layers"][i][name])[:live], _np(want[name])[:live],
                atol=TOL, rtol=TOL, err_msg=f"layer {i} {name}")
