"""Every model family of ``configs/`` in the port, against the JAX package.

Reduced configs at ``d_model`` 64 (``pconfigs.reduced``: 4 experts top-2
or top-1 for MoE, 4 patches for the VLM, 2 encoder layers over 16 frames
for whisper), the JAX parameters carried across by
``repro_torch.bridge``, fp32.  Held to the JAX package:
- ``forward``'s logits and MoE ``aux`` for the four families added last
  (qwen2-moe, llama4, pixtral with patches, whisper with frames), with
  the JAX default capacity factor and, for MoE, with no drops;
- the ``InferenceEngine``'s greedy tokens for pixtral (patches; the
  default cache length, which leaves the patches out and wraps the ring
  in the last steps, as in the JAX package, and a cache long enough for
  all) and for whisper (frames), and the continuous-batching engine's
  on pixtral text, paged and striped;
- llama4's long-context ring: a cache past 100k positions windows the
  global layer in prefill and sizes its ring to the window, and
  multi-step decode past the window stays with JAX's logits;
- ``pack_model``'s bytes and specs for all eleven configs (every leaf:
  experts, encoder, learned positions, patch projection), and
  ``unpack_model`` gives the parameters back.
Held to the port's own full forward (``tests/test_decode_equivalence.py``
and ``tests/test_mode_switch.py`` on the port): prefill then one decode
step for every config, decode past the llama4 window, and whisper's
recomputed cache continuing exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import models as jm
from repro.configs import get_config, list_archs, reduced
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro.serving.engine import InferenceEngine as JaxStaticEngine
from repro_torch import configs as pconfigs
from repro_torch import models as pm
from repro_torch.bridge import params_from_jax
from repro_torch.core import blocks as tb
from repro_torch.core.mode_switch import recompute_cache
from repro_torch.models import model as mm
from repro_torch.serving import ContinuousBatchingEngine, InferenceEngine

TOL = 1e-4
DECODE_TOL = 2e-4              # tests/test_decode_equivalence.py's
MOE, LLAMA4 = "qwen2-moe-a2.7b", "llama4-maverick-400b-a17b"
VLM, ENCDEC = "pixtral-12b", "whisper-large-v3"
NEW = (MOE, LLAMA4, VLM, ENCDEC)
_CTX = {}


def _cfgs(arch):
    cfg = reduced(get_config(arch), d_model=64)
    pcfg = pconfigs.reduced(pconfigs.get_config(arch), d_model=64)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(pcfg)
    return cfg, pcfg


def _ctx(arch, dtype=jnp.float32):
    key = (arch, jnp.dtype(dtype).name)
    if key not in _CTX:
        cfg, pcfg = _cfgs(arch)
        jp = jm.init_params(cfg, jax.random.PRNGKey(0), dtype)
        _CTX[key] = dict(cfg=cfg, pcfg=pcfg, jp=jp,
                         tp=params_from_jax(pcfg, jax.device_get(jp),
                                            device="cpu"))
    return _CTX[key]


def _batch(cfg, B, S_text, seed=0):
    """The same numpy-drawn batch for both packages: tokens, plus
    patches (vlm) or frames (encdec)."""
    rng = np.random.default_rng(seed)
    np_b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S_text))}
    if cfg.n_patches:
        np_b["patches"] = rng.standard_normal((B, cfg.n_patches,
                                               cfg.d_model), np.float32)
    if cfg.family == "encdec":
        np_b["frames"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model),
                                             np.float32)
    jb = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
          for k, v in np_b.items()}
    tb_ = {k: torch.from_numpy(v) for k, v in np_b.items()}
    return jb, tb_


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("arch,cf", [(MOE, 1.25), (MOE, None),
                                     (LLAMA4, 1.25), (LLAMA4, None),
                                     (VLM, 1.25), (ENCDEC, 1.25)],
                         ids=["moe", "moe-no-drops", "llama4",
                              "llama4-no-drops", "vlm", "encdec"])
def test_forward_matches_jax(arch, cf):
    c = _ctx(arch)
    jb, tbatch = _batch(c["cfg"], 2, 24)
    want = jm.forward(c["cfg"], c["jp"], jb, moe_cf=cf)
    got = pm.forward(c["pcfg"], c["tp"], tbatch, moe_cf=cf)
    assert got["logits"].shape == want["logits"].shape
    np.testing.assert_allclose(_np(got["logits"]), _np(want["logits"]),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(got["aux"]), float(want["aux"]),
                               atol=1e-7, rtol=TOL)
    if c["cfg"].family == "moe":
        assert float(got["aux"]) > 0


def test_whisper_bf16_frames_match_jax():
    """Reduced whisper in bf16 (JAX's bf16 init bridged as it is) on bf16
    frames: the port's last logits lie within a 2e-2 relative norm of
    JAX's (the bf16 MoE layers' bound: the two frameworks round bf16 at
    other places).  With bf16 frames both run the encoder in bf16; fp32
    frames make JAX's bf16 forward raise (``repro/models/model.py``:314,
    a bf16 scan carry meets an fp32 one)."""
    c = _ctx(ENCDEC, jnp.bfloat16)
    rng = np.random.default_rng(14)
    toks = rng.integers(0, c["cfg"].vocab_size, (2, 24))
    frames = rng.standard_normal((2, c["cfg"].enc_seq, c["cfg"].d_model))
    want = jm.forward(c["cfg"], c["jp"], {
        "tokens": jnp.asarray(toks, jnp.int32),
        "frames": jnp.asarray(frames, jnp.bfloat16)})["logits"][:, -1]
    got = pm.forward(c["pcfg"], c["tp"], {
        "tokens": torch.from_numpy(toks),
        "frames": torch.tensor(frames, dtype=torch.float32).to(
            torch.bfloat16)})["logits"][:, -1]
    assert got.dtype == torch.bfloat16
    w = _np(want).astype(np.float64)
    rel = np.linalg.norm(_np(got) - w) / np.linalg.norm(w)
    assert rel < 2e-2, rel


def test_every_config_inits_runs_and_makes_batches():
    """init_params, make_batch, forward and decode_step for every config
    of ``configs/`` (no family is refused any more)."""
    for arch in list_archs():
        _, pcfg = _cfgs(arch)
        p = pm.init_params(pcfg, device="cpu")
        b = pm.make_batch(pcfg, 2, 12, device="cpu")
        assert set(b) == {"tokens"} | ({"patches"} if pcfg.n_patches
                                       else set()) | \
            ({"frames"} if pcfg.family == "encdec" else set())
        n = pm.n_positions(pcfg, b)
        assert n == 12
        out = pm.forward(pcfg, p, b, build_cache=True, moe_cf=None)
        assert out["logits"].shape == (2, 12, pcfg.vocab_size)
        cache = pm.cache_from_prefill(pcfg, out["kv"], n + 4, n)
        logits, _ = pm.decode_step(pcfg, p, cache, b["tokens"][:, -1],
                                   cache["pos"])
        assert torch.isfinite(logits).all(), arch


def test_encdec_refuses_paged_caches():
    _, pcfg = _cfgs(ENCDEC)
    with pytest.raises(ValueError, match="decoder-only"):
        pm.init_paged_cache(pcfg, 2, page_size=4, n_pages=4, max_pages=2,
                            device="cpu")
    eng = ContinuousBatchingEngine(pcfg, pm.init_params(pcfg, device="cpu"),
                                   n_slots=2, max_len=32)
    assert not eng.paged and not pm.supports_prefix_sharing(pcfg)
    with pytest.raises(ValueError, match="paged KV layout"):
        ContinuousBatchingEngine(pcfg, eng.params, n_slots=2, max_len=32,
                                 role="decode")


# ---------------------------------------------------- decode equivalence
@pytest.mark.parametrize("arch", list_archs())
def test_prefill_then_decode_matches_full_forward(arch):
    """``tests/test_decode_equivalence.py`` on the port (its weights from
    its own init): prefill all but the last token, one decode step, the
    full forward's last logits."""
    _, pcfg = _cfgs(arch)
    p = pm.init_params(pcfg, seed=1, device="cpu")
    S = 32
    b = pm.make_batch(pcfg, 2, S, seed=2, device="cpu")
    full = pm.forward(pcfg, p, b, moe_cf=None)["logits"]
    pre_b = dict(b, tokens=b["tokens"][:, :-1])
    n = pm.n_positions(pcfg, pre_b)
    pre = pm.forward(pcfg, p, pre_b, build_cache=True, cache_len=S + 8,
                     moe_cf=None)
    cache = pm.cache_from_prefill(pcfg, pre["kv"], S + 8, n)
    logits, _ = pm.decode_step(pcfg, p, cache, b["tokens"][:, -1],
                               cache["pos"])
    err = float((logits - full[:, -1]).abs().max())
    assert err < DECODE_TOL, err


def _decode_logits(prefill, step, tokens, S_pre, cache_len):
    """Prefill ``S_pre`` tokens into a cache of ``cache_len``, then
    teacher-force the rest: every step's logits, and the last cache."""
    cache = prefill(tokens[:, :S_pre], cache_len)
    steps = []
    for t in range(S_pre, tokens.shape[1]):
        logits, cache = step(cache, tokens[:, t], cache["pos"])
        steps.append(_np(logits))
    return steps, cache


@pytest.mark.parametrize("cache_len", [96, 200_000],
                         ids=["past-window", "long-context"])
def test_llama4_ring_past_window_matches_jax(cache_len):
    """``test_multistep_decode_past_window`` for llama4 (window 64; the
    ring wraps) at a 96-position cache and past the long-context
    threshold, where the global layer's prefill is windowed too and its
    ring is the window's: every decode step's logits within TOL of
    JAX's; with the short cache, also within 2e-4 of the full forward."""
    c = _ctx(LLAMA4)
    pcfg = c["pcfg"]
    assert pcfg.window == 64 and "attn_full:moe" in pcfg.layer_pattern
    S_total, S_pre = 96, 60
    toks = np.random.default_rng(3).integers(0, pcfg.vocab_size,
                                             (2, S_total))
    cfg, jp, tp = c["cfg"], c["jp"], c["tp"]
    jax_step = jax.jit(functools.partial(jm.decode_step, cfg))
    want, _ = _decode_logits(
        lambda t, n: jm.forward(cfg, jp, {"tokens": t}, build_cache=True,
                                cache_len=n, moe_cf=None)["cache"],
        lambda cache, tok, pos: jax_step(jp, cache, tok, pos),
        jnp.asarray(toks, jnp.int32), S_pre, cache_len)
    got, cache = _decode_logits(
        lambda t, n: pm.cache_from_prefill(pcfg, pm.forward(
            pcfg, tp, {"tokens": t}, build_cache=True, cache_len=n,
            moe_cf=None)["kv"], n, t.shape[1]),
        lambda cache, tok, pos: pm.decode_step(pcfg, tp, cache, tok, pos),
        torch.from_numpy(toks), S_pre, cache_len)
    for t, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL,
                                   err_msg=f"step {t}")
    widths = [e["k"].shape[1] for e in cache["layers"]]
    if cache_len > mm.LONG_CONTEXT_THRESHOLD:
        assert widths == [64] * pcfg.n_layers
    else:
        assert widths == [64, 64, 64, cache_len]
        full = pm.forward(pcfg, c["tp"], {"tokens": torch.from_numpy(toks)},
                          moe_cf=None)["logits"]
        for t, g in enumerate(got):
            assert np.abs(g - _np(full[:, S_pre + t])).max() < DECODE_TOL


def test_whisper_recomputed_cache_continues_exactly():
    """``tests/test_mode_switch.py`` for whisper on the port: a cache
    recomputed from prompt + generated tokens (the encoder run again on
    the frames) gives the live cache's next logits."""
    _, pcfg = _cfgs(ENCDEC)
    p = pm.init_params(pcfg, seed=4, device="cpu")
    S_prompt, n_gen = 24, 8
    b = pm.make_batch(pcfg, 2, S_prompt, seed=5, device="cpu")
    cache_len = S_prompt + n_gen + 4
    eng = InferenceEngine(pcfg, p)
    logits, cache = eng.prefill(b, cache_len=cache_len)
    toks = [logits.argmax(-1)]
    for _ in range(n_gen - 1):
        logits, cache = pm.decode_step(pcfg, p, cache, toks[-1],
                                       cache["pos"])
        toks.append(logits.argmax(-1))
    live, _ = pm.decode_step(pcfg, p, cache, toks[-1], cache["pos"])
    all_toks = torch.cat([b["tokens"], torch.stack(toks, 1)], 1)
    cache3 = recompute_cache(pcfg, p, dict(b, tokens=all_toks[:, :-1]),
                             cache_len=cache_len)
    switched, _ = pm.decode_step(pcfg, p, cache3, toks[-1], cache3["pos"])
    assert float((switched - live).abs().max()) < DECODE_TOL


# ------------------------------------------------------------------ engines
@pytest.mark.parametrize("arch,cache_len", [(VLM, None), (VLM, 48),
                                            (ENCDEC, None), (MOE, None)],
                         ids=["vlm-wraps", "vlm-full", "encdec", "moe"])
def test_static_engine_tokens_equal_jax(arch, cache_len):
    """Greedy tokens of ``InferenceEngine.generate`` with patches or
    frames.  For pixtral the default cache length (text + new tokens, as
    the JAX package computes it) is shorter than its patches + text + new
    positions: the ring wraps over the first patch positions in the last
    steps, in both packages alike."""
    c = _ctx(arch)
    jb, tbatch = _batch(c["cfg"], 2, 20, seed=6)
    n_new = 10
    if arch == VLM and cache_len is None:
        n_pos = pm.n_positions(c["pcfg"], tbatch)
        assert n_pos + n_new - 2 >= 20 + n_new       # the ring wraps
    want = JaxStaticEngine(c["cfg"], c["jp"]).generate(
        jb, n_new, cache_len=cache_len)
    got = InferenceEngine(c["pcfg"], c["tp"]).generate(
        tbatch, n_new, cache_len=cache_len)
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "striped"])
def test_vlm_text_engine_tokens_equal_jax(paged):
    """The continuous-batching engine serves pixtral's text (no patches),
    as the JAX package does: two prompts share a 20-token prefix."""
    c = _ctx(VLM)
    rng = np.random.default_rng(41)
    tok = lambda n: list(map(int, rng.integers(0, 512, n)))  # noqa: E731
    pre = tok(20)
    trace = [(pre + tok(6), 5), (tok(11), 7), (pre + tok(3), 6)]
    kw = dict(n_slots=2, max_len=48, paged=paged)
    if paged:
        kw["page_size"] = 16

    def run(eng):
        for i, (p, n) in enumerate(trace):
            eng.submit(p, n, req_id=i)
        return eng.run()
    want = run(JaxEngine(c["cfg"], c["jp"], **kw))
    eng = ContinuousBatchingEngine(c["pcfg"], c["tp"], **kw)
    assert run(eng) == want
    if paged:
        assert eng.stats["shared_tokens"] > 0


# -------------------------------------------------------------- packing
@pytest.mark.parametrize("arch", list_archs())
def test_pack_model_bytes_equal_jax(arch):
    """Every leaf of every config packs to the JAX package's bytes and
    specs (3 blocks), and unpacks to the parameters it came from."""
    c = _ctx(arch)
    cfg, pcfg = c["cfg"], c["pcfg"]
    assert sorted(tb.flatten_params(pcfg, c["tp"])) == \
        sorted(jcore.flatten_params(cfg, c["jp"]))
    got, gspecs = tb.pack_model(pcfg, c["tp"], 3)
    want, wspecs = jcore.pack_model(cfg, c["jp"], 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert [dataclasses.astuple(s) for s in gspecs] == \
        [dataclasses.astuple(s) for s in wspecs]
    back = tb.unpack_model(pcfg, got, gspecs)
    flat_a = tb.flatten_params(pcfg, back)
    flat_b = tb.flatten_params(pcfg, c["tp"])
    assert sorted(flat_a) == sorted(flat_b)
    assert all(torch.equal(flat_a[k], flat_b[k]) for k in flat_b)
