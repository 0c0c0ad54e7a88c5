"""The port's bucketed prefills against the JAX package's per-length ones.

On a CUDA device the port captures each serving step as a CUDA graph per
length bucket (``serving.engine``, ``distributed.pipeline``): a prompt is
right-padded to ``prefill_bucket(n)`` tokens and its real length, slot
and suffix start ride in one-element device tensors.  The padded step
body is the same code on the CPU, where it runs eagerly, so these tests
hold it, at lengths that are multiples of neither the bucket nor the
page size, to the JAX package, which compiles one executable per exact
length, on the same weights (``repro_torch.bridge``, reduced configs at
``d_model`` 64, fp32):
- the continuous-batching fresh prefill (``_prefill_step``) against
  JAX's ``prefill_scatter`` of ``_paged_executables`` and
  ``_cb_executables``, for dense, hybrid, ssm and vlm: the first token,
  ``_tok`` and every slot's position equal, the pools outside the trash
  page and the recurrent state equal in their zeros and within 1e-4
  elsewhere (the two packages sum in different orders:
  ``tests/test_torch_model.py``), and every leaf outside the trash page
  bitwise equal to the port's own unpadded step at the exact length;
- the suffix prefill on a mid-page fork against JAX's ``suffix_prefill``;
- greedy tokens on one trace: ``ContinuousBatchingEngine`` paged with
  prefix sharing and striped, ``InferenceEngine`` dense and
  encoder-decoder (keyed by exact shape, unpadded), and the λPipe ``PipelinedEngine`` at token buckets
  that pad.
The capture itself runs on the card (``tests/test_torch_gpu.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.distributed.pipeline import PipelinedEngine as JaxPipelined
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_paged_cache as jax_init_paged
from repro.models import init_params as jax_init_params
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro.serving.engine import InferenceEngine as JaxStatic
from repro.serving.engine import _cb_executables, _paged_executables
from repro_torch import configs as pconfigs
from repro_torch import models as pm
from repro_torch.bridge import params_from_jax
from repro_torch.distributed import PipelinedEngine, stage_params
from repro_torch.serving import ContinuousBatchingEngine, InferenceEngine
from repro_torch.serving.engine import prefill_bucket

DENSE, HYBRID, SSM = "qwen2.5-3b", "recurrentgemma-2b", "xlstm-1.3b"
VLM, ENCDEC = "pixtral-12b", "whisper-large-v3"
# hybrid: one (rec, rec, attn) repetition; ssm: an mLSTM and an sLSTM
# block (its pattern cut from seven mLSTM blocks and an sLSTM to one each)
N_LAYERS = {DENSE: 2, HYBRID: 3, SSM: 2, VLM: 2, ENCDEC: 2}
SSM_PATTERN = ("mlstm:none", "slstm:none")
MAX_LEN = {DENSE: 64, HYBRID: 96, SSM: 96, VLM: 64}
PS = 8
TOL = 1e-4
_CTX = {}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: small eager loops, several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ctx(arch):
    if arch not in _CTX:
        cfg = reduced(get_config(arch), d_model=64, n_layers=N_LAYERS[arch])
        pcfg = pconfigs.reduced(pconfigs.get_config(arch), d_model=64,
                                n_layers=N_LAYERS[arch])
        if arch == SSM:
            cfg, pcfg = (dataclasses.replace(c, layer_pattern=SSM_PATTERN)
                         for c in (cfg, pcfg))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(pcfg)
        jp = jax_init_params(cfg, jax.random.PRNGKey(0))
        _CTX[arch] = (cfg, pcfg, jp,
                      params_from_jax(pcfg, jax.device_get(jp), device="cpu"))
    return _CTX[arch]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _jax_layer(cache, cfg, i):
    """Layer ``i``'s entry of a JAX cache (trunk leaves carry the pattern
    repetition on axis 0; the remainder layers follow the trunk)."""
    n_trunk = cfg.n_pattern_reps * cfg.pattern_len
    if i >= n_trunk:
        return cache["rem"][i - n_trunk]
    return jax.tree.map(lambda a: a[i // cfg.pattern_len],
                        cache["trunk"][i % cfg.pattern_len])


def _leaf_pairs(pcfg, cfg, got, want, n_pages: int):
    """(layer, name, port leaf, other leaf) for every leaf of a port
    cache against a JAX cache (``cfg`` given) or another port cache, the
    pools cut to their first ``n_pages`` pages (the trash page off)."""
    for i in range(pcfg.n_layers):
        ol = _jax_layer(want, cfg, i) if cfg else want["layers"][i]
        gl = got["layers"][i]
        assert sorted(gl) == sorted(ol), (i, sorted(gl), sorted(ol))
        for name in ol:
            g, o = gl[name], ol[name]
            if "pages" in got and name in ("k", "v"):
                g, o = g[:n_pages], o[:n_pages]
            yield i, name, g, o


def _assert_cache_equal(pcfg, cfg, got, want, n_pages: int):
    """Positions equal; every other leaf equal in its zeros and within
    TOL elsewhere (stored ring positions exactly)."""
    assert got["pos"].tolist() == np.asarray(want["pos"]).tolist()
    for i, name, g, w in _leaf_pairs(pcfg, cfg, got, want, n_pages):
        g, w = _np(g), _np(w)
        if name == "pos":
            np.testing.assert_array_equal(g, w, err_msg=f"{i} {name}")
            continue
        np.testing.assert_array_equal(g == 0, w == 0,
                                      err_msg=f"layer {i} {name} zeros")
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL,
                                   err_msg=f"layer {i} {name}")


def _exact(pcfg, tp, kw, table, prompt, slot):
    """The port's step at the prompt's exact length, unpadded, as the
    engine ran it before its prefills were bucketed: (first token, the
    engine's cache)."""
    eng = ContinuousBatchingEngine(pcfg, tp, **kw)
    if table is not None:
        eng.cache["pages"].copy_(torch.from_numpy(table))
    n = len(prompt)
    out = pm.forward(pcfg, tp, {"tokens": torch.tensor([prompt])},
                     build_cache=True, cache_len=eng.max_len, moe_cf=None,
                     last_only=True)
    if eng.paged:
        pm.paged_prefill_scatter(pcfg, eng.cache, out["kv"], slot,
                                 eng.cache["pages"][slot], n)
    else:
        pm.cache_scatter(eng.cache, pm.cache_from_prefill(
            pcfg, out["kv"], eng.max_len, n), slot)
    return int(out["logits"][0, -1].argmax()), eng.cache


def _table(rng, n_slots, mp, slot):
    """A page table with ``slot``'s row a shuffled set of page ids and
    the other rows FREE."""
    table = np.full((n_slots, mp), -1, np.int32)
    table[slot] = rng.permutation(n_slots * mp)[:mp]
    return table


# prompt lengths, none a multiple of the bucket or the page: past a page;
# the striped hybrid's past its 64-token window (its ring keeps the last
# 64: the paged pools keep every token there, which JAX's do not, so the
# paged hybrid stays inside the window); the ssm's past the mLSTM's
# 64-token chunk
@pytest.mark.parametrize("arch,paged,n", [
    (DENSE, True, 21), (DENSE, False, 21), (HYBRID, True, 45),
    (HYBRID, False, 70), (SSM, True, 70), (VLM, True, 21)],
    ids=["dense-paged", "dense-striped", "hybrid-paged", "hybrid-striped",
         "ssm-paged", "vlm-paged"])
def test_fresh_prefill_equals_jax(arch, paged, n):
    """One prompt into slot 1 of 3 through the engine's padded step (its
    bucket pads it) and through JAX's executable at the exact length."""
    cfg, pcfg, jp, tp = _ctx(arch)
    max_len, n_slots, slot = MAX_LEN[arch], 3, 1
    assert prefill_bucket(n, max_len) > n and n % PS
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, n)
    kw = dict(n_slots=n_slots, max_len=max_len, paged=paged,
              prefix_sharing=False)
    if paged:
        kw["page_size"] = PS
    eng = ContinuousBatchingEngine(pcfg, tp, **kw)
    last_tok = jnp.zeros((n_slots,), jnp.int32)
    tokens = jnp.asarray(prompt[None], jnp.int32)
    n_pages, table = 0, None
    if paged:
        mp = eng.max_pages
        n_pages = n_slots * mp
        table = _table(rng, n_slots, mp, slot)
        eng.cache["pages"].copy_(torch.from_numpy(table))
        prefill = _paged_executables(cfg, max_len, PS, n_pages, mp, "xla")[0]
        jc = jax_init_paged(cfg, n_slots, page_size=PS, n_pages=n_pages,
                            max_pages=mp)
        jc["pages"] = jnp.asarray(table)
    else:
        prefill = _cb_executables(cfg, max_len)[0]
        jc = jax_init_cache(cfg, n_slots, max_len)
    last_tok, jc = prefill(jp, jc, last_tok, tokens, slot)
    prompt = list(map(int, prompt))
    first = eng._prefill_step("fresh", slot, prompt)
    assert int(first[0]) == int(last_tok[slot])
    assert eng._tok.tolist() == np.asarray(last_tok).tolist()
    _assert_cache_equal(pcfg, cfg, eng.cache, jc, n_pages)
    want, ref = _exact(pcfg, tp, kw, table, prompt, slot)
    assert int(first[0]) == want
    assert torch.equal(eng.cache["pos"], ref["pos"])
    for i, name, g, r in _leaf_pairs(pcfg, None, eng.cache, ref, n_pages):
        assert torch.equal(g, r), (i, name)


def test_suffix_prefill_equals_jax():
    """Slot 1 shares slot 0's first page and forks its second mid-page
    (12 shared tokens, 8-token pages); a 13-token suffix (bucket 16)
    through the engine's padded suffix step and JAX's ``suffix_prefill``:
    the first token, positions and pools outside the trash page."""
    cfg, pcfg, jp, tp = _ctx(DENSE)
    max_len, n_slots = 64, 3
    rng = np.random.default_rng(2)
    prompt = list(map(int, rng.integers(0, cfg.vocab_size, 20)))
    suffix = list(map(int, rng.integers(0, cfg.vocab_size, 13)))
    shared = 12
    eng = ContinuousBatchingEngine(pcfg, tp, n_slots=n_slots,
                                   max_len=max_len, page_size=PS,
                                   prefix_sharing=False)
    mp = eng.max_pages
    n_pages = n_slots * mp
    table = np.full((n_slots, mp), -1, np.int32)
    table[0, :3] = [5, 9, 2]
    table[1, :4] = [5, 11, 7, 3]            # page 11: the fork of page 9
    eng.cache["pages"].copy_(torch.from_numpy(table))
    fns = _paged_executables(cfg, max_len, PS, n_pages, mp, "xla")
    prefill, suffix_prefill, copy_page = fns[0], fns[2], fns[3]
    jc = jax_init_paged(cfg, n_slots, page_size=PS, n_pages=n_pages,
                        max_pages=mp)
    jc["pages"] = jnp.asarray(table)
    last_tok = jnp.zeros((n_slots,), jnp.int32)
    last_tok, jc = prefill(jp, jc, last_tok, jnp.asarray([prompt], jnp.int32),
                           0)
    jc = copy_page(jc, 9, 11)
    last_tok, jc = suffix_prefill(jp, jc, last_tok,
                                  jnp.asarray([suffix], jnp.int32), 1,
                                  shared)
    eng._prefill_step("fresh", 0, prompt)
    pm.paged_copy_page(pcfg, eng.cache, 9, 11)
    eng._start.fill_(shared)
    first = eng._prefill_step("suffix", 1, suffix)
    assert prefill_bucket(len(suffix), max_len) == 16
    assert int(first[0]) == int(last_tok[1])
    assert eng._tok.tolist() == np.asarray(last_tok).tolist()
    _assert_cache_equal(pcfg, cfg, eng.cache, jc, n_pages)


def _trace(vocab, seed):
    """Prompts of 21..37 tokens (a shared 20-token prefix, one mid-page
    divergence) and 3..6 new tokens."""
    rng = np.random.default_rng(seed)
    tok = lambda n: list(map(int, rng.integers(0, vocab, n)))  # noqa: E731
    pre = tok(20)
    prompts = [pre + tok(5), tok(37), pre[:13] + tok(9), pre + tok(1)]
    return [(p, 3 + i % 4) for i, p in enumerate(prompts)]


def _serve(eng, trace):
    for i, (p, n) in enumerate(trace):
        eng.submit(p, n, req_id=i)
    return eng.run()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "striped"])
def test_engine_tokens_equal_jax(paged):
    """``ContinuousBatchingEngine`` on one trace, paged with prefix
    sharing (shared suffixes pad too) and striped."""
    cfg, pcfg, jp, tp = _ctx(DENSE)
    trace = _trace(cfg.vocab_size, 3)
    kw = dict(n_slots=3, max_len=48, paged=paged, max_prefill_per_tick=2)
    if paged:
        kw["page_size"] = PS
    want = _serve(JaxEngine(cfg, jp, **kw), trace)
    eng = ContinuousBatchingEngine(pcfg, tp, **kw)
    assert _serve(eng, trace) == want
    if paged:
        assert eng.stats["shared_tokens"] > 0
    assert eng.decode_graph is None and len(eng.prefill_graphs) == 0


@pytest.mark.parametrize("arch", [DENSE, ENCDEC])
def test_static_engine_tokens_equal_jax(arch):
    """``InferenceEngine.generate`` at a text length that is no power of
    two (the decoder's, beside whisper's frames), twice: the second call
    reuses the engine's cache for the same shape."""
    cfg, pcfg, jp, tp = _ctx(arch)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 19))
    jb = {"tokens": jnp.asarray(toks, jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks)}
    if arch == ENCDEC:
        frames = rng.standard_normal((2, cfg.enc_seq, cfg.d_model),
                                     dtype=np.float32)
        jb["frames"], tb["frames"] = jnp.asarray(frames), \
            torch.from_numpy(frames)
    want = np.asarray(JaxStatic(cfg, jp).generate(jb, 6))
    eng = InferenceEngine(pcfg, tp)
    for _ in range(2):
        assert eng.generate(tb, 6).tolist() == want.tolist()
    assert len(eng._shapes) == 1
    # a public prefill returns copies: decoding them moves nothing of the
    # engine's own cache
    logits, cache = eng.prefill(tb, cache_len=25)
    pm.decode_step(pcfg, tp, cache, logits.argmax(-1), cache["pos"])
    assert cache["pos"].tolist() == [20, 20]
    (st,) = eng._shapes.values()
    assert st["cache"]["pos"].tolist() == [19, 19]


def test_static_engine_keeps_its_latest_shapes():
    """``InferenceEngine`` keeps the inputs, cache and graphs of its
    MAX_SHAPES most recent batch shapes: a further shape drops the least
    recently used one with its graphs, and that shape, when it comes
    back, is set up anew and gives the same tokens."""
    from repro_torch.serving.engine import MAX_SHAPES
    _, pcfg, _, tp = _ctx(DENSE)
    rng = np.random.default_rng(6)
    batches = [{"tokens": torch.from_numpy(
        rng.integers(0, pcfg.vocab_size, (1, 5 + i)))}
        for i in range(MAX_SHAPES + 1)]
    eng = InferenceEngine(pcfg, tp)
    first = eng.generate(batches[0], 3)
    (key0,) = eng._shapes
    for graphs in (eng.prefill_graphs, eng.decode_graphs):
        graphs.steps[key0] = "a captured step"     # dropped with its shape
    for b in batches[1:]:
        eng.generate(b, 3)
    assert len(eng._shapes) == MAX_SHAPES and key0 not in eng._shapes
    assert key0 not in eng.prefill_graphs.steps
    assert key0 not in eng.decode_graphs.steps
    assert torch.equal(eng.generate(batches[0], 3), first)
    assert len(eng._shapes) == MAX_SHAPES and key0 in eng._shapes


def test_pipelined_engine_tokens_equal_jax():
    """The λPipe engine (four stages, two microbatches, ``pad_to`` 8 with
    prompts of 5, 11 and 13 tokens) through its stage steps and head, as
    ``PipelineGraphs`` runs them, against JAX's pipelined engine on the
    plain forward."""
    cfg, pcfg, jp, tp = _ctx(DENSE)
    cfg, pcfg = (dataclasses.replace(c, n_layers=4) for c in (cfg, pcfg))
    jp = jax_init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(pcfg, jax.device_get(jp), device="cpu")

    @jax.jit
    def fwd(tokens):
        return jax_forward(cfg, jp, {"tokens": tokens}, moe_cf=None)["logits"]

    rng = np.random.default_rng(5)
    trace = [(list(map(int, rng.integers(0, cfg.vocab_size, n))), m)
             for n, m in [(5, 6), (11, 4), (13, 5)]]
    want = _serve(JaxPipelined(cfg, fwd, n_slots=2, max_len=48, pad_to=8),
                  trace)
    eng = PipelinedEngine.from_stages(
        pcfg, stage_params(pcfg, tp, 4, ["cpu"] * 4), n_microbatches=2,
        n_slots=2, max_len=48, pad_to=8)
    assert _serve(eng, trace) == want
    assert eng.graphs is not None and len(eng.graphs) == 0
