"""The port's engines and page allocator against the JAX package.

The engine cases run one mixed trace with shared prompt prefixes (a
page-aligned match and a mid-page divergence that forks) through the
JAX ``ContinuousBatchingEngine`` and the port's, on the same weights via
``repro_torch.bridge``, and require IDENTICAL greedy tokens, with prefix
sharing on and off.  The static ``InferenceEngine``, the striped layout
(``paged=False``) and the hybrid family (reduced recurrentgemma-2b, five
layers, window 64; prompts and decodes cross the window) and the ssm
family (reduced xlstm-1.3b, eight layers, no attention; prompts cross the
port's 64-token mLSTM chunk) are held to the JAX engines the same way.  The allocator cases are the property tests of
``tests/test_paged.py`` and ``tests/test_prefix_sharing.py`` re-run
against the port's ``PageTable`` and ``PrefixIndex``.
"""
import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config, reduced
from repro.models import init_params
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro.serving.engine import InferenceEngine as JaxStaticEngine
from repro_torch import configs as pconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.models import PageTable, PrefixIndex, pages_for
from repro_torch.serving import ContinuousBatchingEngine, InferenceEngine

MAX_LEN = 48
PAGE_SIZE = 16
HYBRID = "recurrentgemma-2b"
SSM = "xlstm-1.3b"
HYBRID_MAX_LEN = 96            # the ring (window 64) is shorter than the pool
_CTX = {}


def _ctx(arch="qwen2.5-3b"):
    if arch not in _CTX:
        n_layers = 5 if arch == HYBRID else None
        cfg = reduced(get_config(arch), d_model=64, n_layers=n_layers)
        pcfg = pconfigs.reduced(pconfigs.get_config(arch), d_model=64,
                                n_layers=n_layers)
        jp = init_params(cfg, jax.random.PRNGKey(0))
        _CTX[arch] = dict(cfg=cfg, pcfg=pcfg, jp=jp,
                          tp=params_from_jax(pcfg, jax.device_get(jp),
                                             device="cpu"))
    return _CTX[arch]


def _trace():
    """(prompt, max_new_tokens) pairs: a 20-token prefix shared by three
    prompts (one full page matches), a 32-token prompt and two that
    diverge from it mid-page at token 24 (fork), and unrelated prompts."""
    rng = np.random.default_rng(11)
    tok = lambda n: list(map(int, rng.integers(0, 512, n)))
    pre, base = tok(20), tok(32)
    prompts = [pre + tok(6), base, pre + tok(9), tok(7),
               base[:24] + tok(8), pre + tok(3), base[:24] + tok(5), tok(12)]
    return [(p, 4 + i % 5) for i, p in enumerate(prompts)]


def _run(engine, trace, **submit_kw):
    for i, (p, n) in enumerate(trace):
        engine.submit(p, n, req_id=i, **submit_kw)
    return engine.run()


@pytest.mark.parametrize("sharing", [True, False])
def test_engine_tokens_equal_jax(sharing):
    c = _ctx()
    trace = _trace()
    kw = dict(n_slots=3, max_len=MAX_LEN, page_size=PAGE_SIZE,
              prefix_sharing=sharing)
    want = _run(JaxEngine(c["cfg"], c["jp"], **kw), trace)
    eng = ContinuousBatchingEngine(c["pcfg"], c["tp"], **kw)
    got = _run(eng, trace)
    assert got == want
    assert all(len(got[i]) == n for i, (_, n) in enumerate(trace))
    if sharing:
        assert eng.stats["shared_tokens"] > 0
        eng.pages.prefix.clear(eng.pages)
    eng.pages.check_invariants()
    assert eng.pages.n_allocated == 0 and eng.pages.n_reserved == 0


def test_engine_eos_eager_mode_equal_jax():
    """An eos_id switches both engines to per-tick host reads and stops a
    sequence at its stop token."""
    c = _ctx()
    trace = _trace()[:4]
    kw = dict(n_slots=2, max_len=MAX_LEN, page_size=PAGE_SIZE)
    free_run = _run(JaxEngine(c["cfg"], c["jp"], **kw), trace)
    eos = free_run[0][2]                       # request 0 stops early
    want = _run(JaxEngine(c["cfg"], c["jp"], **kw), trace, eos_id=eos)
    got = _run(ContinuousBatchingEngine(c["pcfg"], c["tp"], **kw), trace,
               eos_id=eos)
    assert got == want
    assert got[0][-1] == eos and len(got[0]) <= 3


def test_engine_plain_attention_equal_kernel_path():
    c = _ctx()
    trace = _trace()[:5]
    kw = dict(n_slots=3, max_len=MAX_LEN, page_size=PAGE_SIZE)
    a = _run(ContinuousBatchingEngine(c["pcfg"], c["tp"], **kw), trace)
    b = _run(ContinuousBatchingEngine(c["pcfg"], c["tp"], kernel_impl="plain",
                                      **kw), trace)
    assert a == b


def test_engine_rejects_auto_page_size_and_oversize():
    c = _ctx()
    with pytest.raises(NotImplementedError):
        ContinuousBatchingEngine(c["pcfg"], c["tp"], max_len=MAX_LEN,
                                 page_size="auto")
    eng = ContinuousBatchingEngine(c["pcfg"], c["tp"], max_len=MAX_LEN)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(list(range(40)), 10)


def _hybrid_trace():
    """Prompts past the window (70: the keep-last-W prefill) and ones
    whose decode crosses it (60 + 12), three distinct lengths."""
    rng = np.random.default_rng(12)
    tok = lambda n: list(map(int, rng.integers(0, 512, n)))
    lens_new = [(70, 6), (20, 9), (60, 12), (20, 5), (70, 10)]
    return [(tok(n), m) for n, m in lens_new]


@pytest.mark.parametrize("arch", ["qwen2.5-3b", HYBRID, SSM])
def test_static_engine_tokens_equal_jax(arch):
    c = _ctx(arch)
    S = 20 if arch == "qwen2.5-3b" else 70
    toks = np.random.default_rng(13).integers(0, 512, (3, S))
    want = JaxStaticEngine(c["cfg"], c["jp"]).generate(
        {"tokens": jax.numpy.asarray(toks, jax.numpy.int32)}, 8)
    eng = InferenceEngine(c["pcfg"], c["tp"])
    got = eng.generate({"tokens": torch.from_numpy(toks)}, 8)
    assert got.tolist() == np.asarray(want).tolist()
    # sampling: reproducible from an explicit generator, tokens in range
    draws = [eng.generate({"tokens": torch.from_numpy(toks)}, 4,
                          greedy=False,
                          generator=torch.Generator().manual_seed(5))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1]) and draws[0].shape == (3, 4)
    assert 0 <= int(draws[0].min()) and int(draws[0].max()) < 512
    with pytest.raises(ValueError, match="Generator"):
        eng.generate({"tokens": torch.from_numpy(toks)}, 2, greedy=False)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", HYBRID, SSM])
def test_striped_engine_tokens_equal_jax(arch):
    c = _ctx(arch)
    if arch != "qwen2.5-3b":
        trace, max_len = _hybrid_trace(), HYBRID_MAX_LEN
    else:
        trace, max_len = _trace()[:5], MAX_LEN
    kw = dict(n_slots=3, max_len=max_len, paged=False)
    want = _run(JaxEngine(c["cfg"], c["jp"], **kw), trace)
    eng = ContinuousBatchingEngine(c["pcfg"], c["tp"], **kw)
    got = _run(eng, trace)
    assert got == want
    assert all(len(got[i]) == n for i, (_, n) in enumerate(trace))
    assert eng.pages is None and not eng.prefix_sharing


def test_hybrid_paged_engine_tokens_equal_jax():
    c = _ctx(HYBRID)
    trace = _hybrid_trace()
    kw = dict(n_slots=3, max_len=HYBRID_MAX_LEN, page_size=PAGE_SIZE)
    want = _run(JaxEngine(c["cfg"], c["jp"], **kw), trace)
    eng = ContinuousBatchingEngine(c["pcfg"], c["tp"], **kw)
    got = _run(eng, trace)
    assert got == want
    assert not eng.prefix_sharing           # recurrent state: forced off
    eng.pages.check_invariants()
    assert eng.pages.n_allocated == 0


def test_ssm_paged_engine_tokens_equal_jax():
    """The paged engine on a model with no attention layer: a page table
    and no pools.  Pages are still charged at admission, as in JAX: with
    2 slots and a pool of 8 pages, two requests of 5 pages (a 60- or
    70-token prompt and its decode) cannot run side by side, so the
    schedule, hence the tokens, must follow the JAX engine's."""
    c = _ctx(SSM)
    trace = _hybrid_trace()
    kw = dict(n_slots=2, max_len=HYBRID_MAX_LEN, page_size=PAGE_SIZE,
              n_pages=8)
    want = _run(JaxEngine(c["cfg"], c["jp"], **kw), trace)
    eng = ContinuousBatchingEngine(c["pcfg"], c["tp"], **kw)
    got = _run(eng, trace)
    assert got == want
    assert all(len(got[i]) == n for i, (_, n) in enumerate(trace))
    assert not eng.prefix_sharing
    assert all("k" not in e for e in eng.cache["layers"])
    eng.pages.check_invariants()
    assert eng.pages.n_allocated == 0


def test_hybrid_engines_agree_across_layouts_and_impls():
    """Static, striped and paged engines give one greedy continuation per
    request, on the kernel path and the plain one."""
    c = _ctx(HYBRID)
    trace = [(p, 8) for p, _ in _hybrid_trace()[:3]]
    runs = []
    for impl in ("kernel", "plain"):
        for paged in (True, False):
            runs.append(_run(ContinuousBatchingEngine(
                c["pcfg"], c["tp"], n_slots=2, max_len=HYBRID_MAX_LEN,
                paged=paged, kernel_impl=impl), trace))
    assert all(r == runs[0] for r in runs)
    static = InferenceEngine(c["pcfg"], c["tp"], kernel_impl="plain")
    for i, (p, n) in enumerate(trace):
        got = static.generate({"tokens": torch.tensor([p])}, n)
        assert got[0].tolist() == runs[0][i]


# ------------------------------------------------------------- allocator
def test_device_table_uploads_only_on_change():
    pt = PageTable(n_pages=8, page_size=4, n_slots=2, max_pages=4)
    t0 = pt.device_table("cpu")
    assert t0.dtype == torch.int32 and t0.shape == (2, 4)
    assert pt.device_table("cpu") is t0
    pt.ensure(0, 5)
    t1 = pt.device_table("cpu")
    assert t1 is not t0 and t1[0, :2].tolist() == pt.slot_pages(0)
    assert (t1[0, 2:] == -1).all() and (t0 == -1).all()


@settings(max_examples=25, deadline=None)
@given(ops=st.lists(st.tuples(st.integers(0, 2), st.integers(0, 3),
                              st.integers(0, 40)),
                    min_size=1, max_size=50))
def test_page_table_never_leaks_or_double_frees(ops):
    pt = PageTable(n_pages=8, page_size=4, n_slots=4, max_pages=4)
    for kind, slot, arg in ops:
        if kind == 0:
            pt.reserve(slot, arg % 17)
        elif kind == 1:
            want = arg % 17
            if pages_for(want, 4) <= 4:
                try:
                    pt.ensure(slot, want)
                except RuntimeError:
                    pass            # pool exhausted: admission's job
        else:
            freed = pt.release(slot)
            assert len(freed) == len(set(freed))
        pt.check_invariants()
    for s in range(4):
        pt.release(s)
    pt.check_invariants()
    assert pt.n_allocated == 0 and pt.n_reserved == 0


def test_page_table_double_free_raises():
    pt = PageTable(n_pages=4, page_size=4, n_slots=2, max_pages=2)
    pt.ensure(0, 5)
    stolen = pt._slot_pages[0][0]
    pt._slot_pages[1].append(stolen)       # corrupt: two owners
    with pytest.raises(RuntimeError, match="double free"):
        pt.release(1)


def test_page_table_admission_accounting():
    pt = PageTable(n_pages=4, page_size=4, n_slots=4, max_pages=4)
    assert pt.can_admit(16) and not pt.can_admit(17)
    pt.reserve(0, 9)                       # 3 pages worst case
    assert pt.can_admit(4) and not pt.can_admit(5)
    pt.ensure(0, 5)                        # 2 of the 3 materialize
    assert pt.n_allocated == 2 and pt.n_reserved == 3
    pt.release(0)
    assert pt.can_admit(16)


@settings(max_examples=30, deadline=None)
@given(ops=st.lists(st.tuples(st.integers(0, 5), st.integers(0, 3),
                              st.integers(0, 40)),
                    min_size=1, max_size=60))
def test_share_fork_release_interleavings_never_leak(ops):
    pt = PageTable(n_pages=10, page_size=4, n_slots=4, max_pages=5)
    holds = []
    for kind, slot, arg in ops:
        if kind == 0:                                  # grow a slot
            want = min(arg % 21, pt.max_pages * pt.page_size)
            try:
                pt.ensure(slot, want)
            except RuntimeError:
                pass                                   # pool exhausted
        elif kind == 1:                                # CoW attach
            allocated = [p for p in range(pt.n_pages)
                         if pt.refcount(p) > 0]
            if allocated:
                pid = allocated[arg % len(allocated)]
                run = pt.slot_pages(slot)
                if pid not in run and len(run) < pt.max_pages:
                    pt.share(slot, [pid])
        elif kind == 2:                                # fork
            run = pt.slot_pages(slot)
            if run:
                try:
                    pt.fork(slot, arg % len(run))
                except RuntimeError:
                    pass
        elif kind == 3:                                # retention hold
            allocated = [p for p in range(pt.n_pages)
                         if pt.refcount(p) > 0]
            if allocated:
                pid = allocated[arg % len(allocated)]
                pt.hold(pid)
                holds.append(pid)
        elif kind == 4 and holds:                      # drop a hold
            pt.unhold(holds.pop(arg % len(holds)))
        elif kind == 5:
            pt.release(slot)
        pt.check_invariants()
    for slot in range(pt.n_slots):
        pt.release(slot)
    for pid in holds:
        pt.unhold(pid)
    pt.check_invariants()
    assert pt.n_allocated == 0 and pt.n_reserved == 0


def test_staged_bind_keeps_device_row_empty_until_prefill():
    pt = PageTable(n_pages=8, page_size=4, n_slots=2, max_pages=4)
    pt.prefix = PrefixIndex(4)
    prompt = list(range(10))
    pt.reserve(0, 12)
    pt.ensure(0, 10)
    pt.prefix.insert(pt, prompt, pt.slot_pages(0))
    shared = pt.bind(1, prompt, 12)
    assert shared == 8                     # the two fully-indexed pages
    assert pt.slot_pages(1)                # refcounts moved...
    assert (pt.device_table("cpu")[1] == -1).all()   # ...row stays empty
    assert pt.refcount(pt.slot_pages(0)[0]) > 1
    pt.check_invariants()
    pt.ensure(1, 10)                       # prefill time: row activates
    run = pt.slot_pages(1)
    assert pt.device_table("cpu")[1][:len(run)].tolist() == run
    pt.check_invariants()
    pt.release(0), pt.release(1)
    pt.prefix.clear(pt)
    assert pt.n_allocated == 0


def test_prefix_index_partial_match_and_leaf_eviction():
    pt = PageTable(n_pages=12, page_size=4, n_slots=2, max_pages=6)
    idx = PrefixIndex(4)
    pt.prefix = idx
    a = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12]
    pt.reserve(0, 12)
    pt.ensure(0, 12)
    idx.insert(pt, a, pt.slot_pages(0))
    assert len(idx) == 3
    ids, m = idx.lookup([1, 2, 3, 4, 5, 6, 99, 99, 7])
    assert m == 6 and len(ids) == 2        # one full page + 2 of page 2
    ids, m = idx.lookup(a)                 # identical prompt: cap at 11
    assert m == 11 and len(ids) == 3
    assert idx.lookup([9, 9, 9, 9, 9]) == ([], 0)
    pt.release(0)                          # orphans: index holds survive
    assert pt.n_allocated == 3
    freed = idx.evict(pt, 1)               # LRU leaf only
    assert freed == 1 and len(idx) == 2 and pt.n_allocated == 2
    idx.clear(pt)
    assert pt.n_allocated == 0 and len(idx) == 0
