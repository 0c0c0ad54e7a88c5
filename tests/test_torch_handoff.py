"""The port's handoff machinery against the JAX package: drain → handoff →
adopt, wire dedupe under prefix sharing, preemption, engine roles and the
PackedKV wire.

Each engine case runs one scenario, written once, through the JAX
``ContinuousBatchingEngine`` and the port's on the same weights
(``repro_torch.bridge``), and requires IDENTICAL greedy tokens and
identical scheduler ``stats``; every ``PackedKV`` the scenario exports has
the same token count, page ids, carried positions and ``nbytes`` as JAX's
``payload_nbytes`` of the JAX payload, and per-layer pages within 1e-4
(the two packages compute K/V with matmuls that sum in different orders).
The pack and adopt functions themselves are held to JAX bit for bit on
the same pool and ring bytes, in fp32 and bf16.  Reduced configs at
d_model 64: qwen2.5-3b (two attention layers), recurrentgemma-2b (five
layers, window 64) and xlstm-1.3b (two layers, no attention).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import models as jm
from repro.configs import get_config, reduced
from repro.serving import scheduler as jsched
from repro.serving import workload as jwork
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro_torch import configs as pconfigs
from repro_torch import models as pm
from repro_torch.bridge import _tensor, params_from_jax
from repro_torch.serving import scheduler as tsched
from repro_torch.serving import workload as twork
from repro_torch.serving.engine import ContinuousBatchingEngine

MAX_LEN = 48
PAGE_SIZE = 16
TOL = 1e-4
DENSE, HYBRID, SSM = "qwen2.5-3b", "recurrentgemma-2b", "xlstm-1.3b"
N_LAYERS = {HYBRID: 5, SSM: 2}
_CTX = {}


def _ctx(arch=DENSE):
    if arch not in _CTX:
        n_layers = N_LAYERS.get(arch)
        cfg = reduced(get_config(arch), d_model=64, n_layers=n_layers)
        pcfg = pconfigs.reduced(pconfigs.get_config(arch), d_model=64,
                                n_layers=n_layers)
        jp = jm.init_params(cfg, jax.random.PRNGKey(1 if arch == SSM
                                                    else 0))
        _CTX[arch] = dict(cfg=cfg, pcfg=pcfg, jp=jp,
                          tp=params_from_jax(pcfg, jax.device_get(jp),
                                             device="cpu"))
    return _CTX[arch]


def _side(is_jax, arch=DENSE):
    """One package's engine class, config, weights and scheduler/workload
    modules, so a scenario is written once for both."""
    c = _ctx(arch)
    cfg, params = (c["cfg"], c["jp"]) if is_jax else (c["pcfg"], c["tp"])
    engine = JaxEngine if is_jax else ContinuousBatchingEngine
    return types.SimpleNamespace(
        jax=is_jax, sched=jsched if is_jax else tsched,
        work=jwork if is_jax else twork,
        nbytes=jm.payload_nbytes if is_jax else pm.payload_nbytes,
        PackedKV=jm.PackedKV if is_jax else pm.PackedKV,
        engine=lambda **kw: engine(cfg, params, **{
            "max_len": MAX_LEN, "page_size": PAGE_SIZE, **kw}))


def _both(scenario, arch=DENSE):
    """Run ``scenario(side)`` on both packages; compare what it returns:
    "out" token dicts, "stats" lists and "payloads" lists of PackedKV."""
    want, got = scenario(_side(True, arch)), scenario(_side(False, arch))
    assert got.keys() == want.keys()
    for key in got:
        if key == "payloads":
            assert len(got[key]) == len(want[key])
            for t, j in zip(got[key], want[key]):
                _same_payload(t, j, _ctx(arch)["cfg"])
        elif key == "stats":
            assert [dict(s) for s in got[key]] == [dict(s)
                                                   for s in want[key]]
        else:
            assert got[key] == want[key], key
    return got


def _toks(seed, length):
    return list(map(int, np.random.default_rng(seed).integers(0, 512,
                                                              length)))


def _jax_layer(kv, cfg, i):
    """Layer ``i``'s entry of a JAX cache or PackedKV pytree (trunk leaves
    carry the pattern repetition on axis 0; the remainder follows)."""
    n_trunk = cfg.n_pattern_reps * cfg.pattern_len
    if i >= n_trunk:
        return kv["rem"][i - n_trunk]
    return jax.tree.map(lambda a: a[i // cfg.pattern_len],
                        kv["trunk"][i % cfg.pattern_len])


def _bits(x):
    """A leaf's exact contents: numpy, bf16 as its uint16 bit patterns."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _same_payload(t, j, cfg, exact=False):
    """A port PackedKV against a JAX one: metadata and nbytes equal, each
    layer's leaves equal (bit for bit with ``exact``, else within TOL)."""
    assert isinstance(t, pm.PackedKV) and isinstance(j, jm.PackedKV)
    assert (t.n_tokens, t.page_size, t.n_pages) == \
        (j.n_tokens, j.page_size, j.n_pages)
    assert t.page_ids == j.page_ids and t.carried == j.carried
    assert (t.batch is None) == (j.batch is None)
    assert pm.payload_nbytes(t) == jm.payload_nbytes(j) == t.nbytes
    assert len(t.kv) == cfg.n_layers
    for i, entry in enumerate(t.kv):
        want = _jax_layer(j.kv, cfg, i)
        assert sorted(entry) == sorted(want), i
        for name, leaf in entry.items():
            a, b = _bits(leaf), _bits(want[name])
            assert a.shape == b.shape and a.dtype == b.dtype, (i, name)
            if exact:
                np.testing.assert_array_equal(a, b, err_msg=f"{i} {name}")
            else:
                np.testing.assert_allclose(
                    leaf.float().numpy(), np.asarray(want[name], np.float32),
                    atol=TOL, rtol=TOL, err_msg=f"layer {i} {name}")


def _drain(eng, budget=600):
    for _ in range(budget):
        if not eng.step():
            break
    eng.flush()


def _assert_drained(eng):
    eng.flush()
    eng.pages.check_invariants()
    assert eng.pages.n_slot_owned == 0 and eng.pages.n_reserved == 0
    assert eng._dedupe == {}
    if eng.pages.prefix is not None:
        eng.pages.prefix.clear(eng.pages)
    assert eng.pages.n_allocated == 0


# ------------------------------------------------ pack / adopt, bit exact
def _random_pool(cfg, pcfg, dtype, n_slots, n_pages, seed):
    """The same random paged cache in both packages: pools, states, pos."""
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    jc = jm.init_paged_cache(cfg, n_slots, page_size=PAGE_SIZE,
                             n_pages=n_pages, max_pages=n_pages, dtype=jdt)
    rng = np.random.default_rng(seed)
    jc = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, jc)
    tc = pm.init_paged_cache(pcfg, n_slots, page_size=PAGE_SIZE,
                             n_pages=n_pages, max_pages=n_pages,
                             device="cpu")
    for i, entry in enumerate(tc["layers"]):
        src = _jax_layer(jc, cfg, i)
        tc["layers"][i] = {k: _tensor(np.asarray(src[k]), "cpu", None)
                           for k in entry}
    return jc, tc


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", [DENSE, HYBRID, SSM])
def test_paged_pack_and_adopt_scatter_bit_equal_jax(arch, dtype):
    """On the same pool bytes, the port's ``paged_pack`` (whole and
    deduped to a page subset) equals JAX's bit for bit, its wire buffer
    rebuilds it bit for bit, and ``paged_adopt_scatter`` into fresh pages
    of an empty pool leaves the same pool and state rows as JAX's."""
    c = _ctx(arch)
    cfg, pcfg = c["cfg"], c["pcfg"]
    jc, tc = _random_pool(cfg, pcfg, dtype, 3, 8, seed=5)
    ids, n_tok, slot = [6, 1, 3], 37, 2
    for ship in (None, [1, 3]):
        jpk = jm.paged_pack(cfg, jc, slot, ids, n_tok, PAGE_SIZE, ship=ship)
        tpk = pm.paged_pack(pcfg, tc, slot, ids, n_tok, PAGE_SIZE,
                            ship=ship)
        _same_payload(tpk, jpk, cfg, exact=True)
        rt = tpk.from_wire(*tpk.wire())
        _same_payload(rt, jpk, cfg, exact=True)
    jpk = jm.paged_pack(cfg, jc, slot, ids, n_tok, PAGE_SIZE)
    tpk = pm.paged_pack(pcfg, tc, slot, ids, n_tok, PAGE_SIZE)
    j0, t0 = _random_pool(cfg, pcfg, dtype, 3, 8, seed=6)
    j1 = jm.paged_adopt_scatter(cfg, j0, jpk, 0, [4, 0, 7])
    t1 = pm.paged_adopt_scatter(pcfg, t0, tpk, 0, [4, 0, 7])
    assert t1["pos"].tolist() == np.asarray(j1["pos"]).tolist()
    for i, entry in enumerate(t1["layers"]):
        want = _jax_layer(j1, cfg, i)
        for name, leaf in entry.items():
            np.testing.assert_array_equal(_bits(leaf), _bits(want[name]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", [DENSE, HYBRID, SSM])
def test_pack_single_cache_bit_equal_jax(arch, dtype):
    """A batch-1 striped cache (JAX prefill of an 80-token prompt; the
    hybrid's 64-token ring wraps) packs into the same pages bit for bit:
    the port's ring and JAX's hold the same bytes at max_len 96."""
    c = _ctx(arch)
    cfg, pcfg = c["cfg"], c["pcfg"]
    jp = c["jp"] if dtype == "f32" else jax.tree.map(
        lambda a: a.astype(jnp.bfloat16)
        if a.dtype == jnp.float32 else a, c["jp"])
    toks = np.random.default_rng(7).integers(0, 512, (1, 80))
    cache = jm.forward(cfg, jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                       build_cache=True, cache_len=96)["cache"]
    single = {"layers": [{k: _tensor(np.asarray(v), "cpu", None)
                          for k, v in _jax_layer(cache, cfg, i).items()}
                         for i in range(cfg.n_layers)],
              "pos": torch.from_numpy(np.array(cache["pos"]))}
    _same_payload(pm.pack_single_cache(pcfg, single, PAGE_SIZE),
                  jm.pack_single_cache(cfg, cache, PAGE_SIZE), cfg,
                  exact=True)


# --------------------------------------------- page-granular handoff
def _mid_gen(side, n_slots=4, n_reqs=4, base_seed=600, ntok=6, **kw):
    eng = side.engine(n_slots=n_slots, max_prefill_per_tick=n_slots, **kw)
    for i in range(n_reqs):
        eng.submit(_toks(base_seed + i, 5 + i), ntok, req_id=i)
    for _ in range(3):
        eng.step()
    eng.drain()
    return eng


def test_paged_handoff_park_resume_equal_jax():
    """Drain → page-granular handoff → adopt with overflow: two of four
    live sequences park in the resume queue and enter DECODE as pages and
    slots free up; no sequence re-runs prefill."""
    def scenario(s):
        a = _mid_gen(s)
        pairs = a.handoff()
        assert all(isinstance(c, s.PackedKV) for _, c in pairs)
        assert a.pages.n_allocated == 0      # source released every page
        b = s.engine(n_slots=2)
        b.adopt(pairs)
        assert b.sched.stats["adopted"] == 2
        assert len(b.sched.resume_queue) == 2
        out = b.run()
        assert b.sched.stats["prefills"] == 0
        assert b.sched.stats["adopted"] == 4
        b.pages.check_invariants()
        assert b.pages.n_allocated == 0
        return {"out": out, "stats": [a.stats, b.stats],
                "payloads": [c for _, c in pairs]}
    _both(scenario)


def test_paged_handoff_moves_fewer_bytes_than_pooled():
    """Page-granular payloads are a fraction of the striped gather, and
    both packages price both wires at the same byte counts."""
    def scenario(s):
        paged = sum(s.nbytes(c) for _, c in _mid_gen(s).handoff())
        pooled = sum(s.nbytes(c) for _, c in
                     _mid_gen(s, paged=False).handoff())
        assert 0 < paged < 0.7 * pooled
        return {"bytes": (paged, pooled)}
    _both(scenario)


def test_paged_wire_roundtrip_and_dropped_payload_equal_jax():
    """The contiguous wire buffer rebuilds each payload bit for bit, and
    dropping the payloads entirely (recompute path, §4.4) still gives the
    JAX engine's tokens at adoption."""
    def scenario(s):
        outs = []
        for drop in (False, True):
            a = _mid_gen(s, n_slots=2, n_reqs=2, base_seed=700)
            pairs = a.handoff()
            if drop:
                pairs = [(q, None) for q, _ in pairs]
            elif not s.jax:
                for _, c in pairs:
                    rt = c.from_wire(*c.wire())
                    for x, y in zip(pm.cache_ops._leaves(c.kv),
                                    pm.cache_ops._leaves(rt.kv)):
                        assert torch.equal(x, y)
                pairs = [(q, c.from_wire(*c.wire())) for q, c in pairs]
            b = s.engine(n_slots=2)
            b.adopt(pairs)
            outs.append(b.run())
            assert b.stats["prefills"] == 0
        return {"out": outs}
    _both(scenario)


@pytest.mark.parametrize("paged", [False, True])
def test_attention_free_model_handoff_equal_jax(paged):
    """Pure-recurrent xLSTM (no pools, O(d) state per slot) on both
    layouts: payloads carry the engine's page size and the state within
    TOL of JAX's, and drain → adopt gives JAX's tokens."""
    def scenario(s):
        eng = s.engine(n_slots=2, paged=paged)
        eng.submit(_toks(2, 6), 6, req_id=0)
        for _ in range(3):
            eng.step()
        eng.drain()
        pairs = eng.handoff()
        if paged:
            assert all(c.page_size == PAGE_SIZE for _, c in pairs)
        b = s.engine(n_slots=2, paged=paged)
        b.adopt(pairs)
        out = b.run()
        assert len(out[0]) == 6
        return {"out": out, "stats": [b.stats],
                "payloads": [c for _, c in pairs] if paged else []}
    _both(scenario, SSM)


def test_adopt_parks_in_order_no_small_request_bypass():
    """Once one adoption parks for lack of pages, every later pair parks
    too, and the parked sequences resume in handoff order."""
    def scenario(s):
        a = s.engine(n_slots=2, max_prefill_per_tick=2)
        a.submit(_toks(750, 18), 6, req_id=0)   # 24 tokens → 2 pages
        a.submit(_toks(751, 5), 5, req_id=1)    # 10 tokens → 1 page
        for _ in range(3):
            a.step()
        a.drain()
        pairs = a.handoff()
        assert [q.req_id for q, _ in pairs] == [0, 1]
        b = s.engine(n_slots=3, n_pages=3)
        b.submit(_toks(752, 18), 6, req_id=9)   # holds 2 of the 3 pages
        b.step()
        b.adopt(pairs)
        assert b.sched.stats["adopted"] == 0
        assert [q.req_id for q in b.sched.resume_queue] == [0, 1]
        out = b.run()
        assert b.sched.stats["prefills"] == 1   # only req 9
        b.pages.check_invariants()
        return {"out": out, "stats": [b.stats],
                "payloads": [c for _, c in pairs]}
    _both(scenario)


@pytest.mark.parametrize("dst_paged", [False, True])
def test_striped_handoff_equal_jax(dst_paged):
    """A striped engine's slot rows (``cache_gather``) adopt into a
    striped engine (scattered whole) or a paged one (repacked through
    ``pack_single_cache``), with JAX's tokens."""
    def scenario(s):
        a = _mid_gen(s, n_slots=2, n_reqs=3, base_seed=720, paged=False)
        pairs = a.handoff()
        assert all(c is None or not isinstance(c, s.PackedKV)
                   for _, c in pairs)
        b = s.engine(n_slots=2, paged=dst_paged)
        b.adopt(pairs)
        out = b.run()
        assert b.stats["adopted"] == 2
        return {"out": out, "stats": [b.stats]}
    _both(scenario)


# ------------------------------------------------------------ wire dedupe
def _sharing_prompts(seed, base):
    pre = _toks(seed, 20)
    return [pre + _toks(base + i, 4) for i in range(3)]


def _mid_gen_sharing(s, prompts, ntok=6):
    eng = s.engine(n_slots=4)
    for i, p in enumerate(prompts):
        eng.submit(p, ntok, req_id=i)
    for _ in range(len(prompts) + 2):
        eng.step()
    eng.drain()
    return eng


def test_handoff_dedupes_shared_pages_and_restores_equal_jax():
    """One export batch ships each shared page once: sharers carry only
    their private suffix pages and resolve the prefix through the batch
    remap at adoption (wire roundtrip included); both ends drain."""
    prompts = _sharing_prompts(11, 400)

    def scenario(s):
        a = _mid_gen_sharing(s, prompts)
        pairs = a.handoff()
        _assert_drained(a)
        by_id = {q.req_id: c for q, c in pairs}
        carriers = [c for c in by_id.values()
                    if c.carried == tuple(range(c.n_pages))]
        sharers = [c for c in by_id.values()
                   if c.carried != tuple(range(c.n_pages))]
        assert carriers and len(sharers) == 2
        for c in sharers:                 # the prefix page rides elsewhere
            assert c.carried and min(c.carried) > 0 and c.deduped
            assert s.nbytes(c) < s.nbytes(carriers[0])
        b = s.engine()
        b.adopt([(q, c.from_wire(*c.wire())) for q, c in pairs])
        out = b.run()
        assert b.sched.stats["prefills"] == 0
        _assert_drained(b)
        return {"out": out, "stats": [b.stats],
                "payloads": [c for _, c in pairs]}
    _both(scenario)


@pytest.mark.parametrize("carrier_elsewhere", [False, True])
def test_parked_sharers_and_unresolvable_refs_equal_jax(carrier_elsewhere):
    """Adopting into a 1-slot engine parks the sharers, which restore
    through the held remap later; sharers whose carrier went to another
    engine cannot resolve their refs and rebuild from tokens.  Either
    way JAX's tokens, and the dedupe state drains."""
    prompts = _sharing_prompts(12, 500)

    def scenario(s):
        pairs = _mid_gen_sharing(s, prompts).handoff()
        if carrier_elsewhere:
            pairs = [(q, c) for q, c in pairs
                     if c.carried != tuple(range(c.n_pages))]
            b = s.engine()
        else:
            b = s.engine(n_slots=1)
        b.adopt(pairs)
        out = b.run()
        assert b.sched.stats["prefills"] == 0
        _assert_drained(b)
        return {"out": out, "stats": [b.stats]}
    _both(scenario)


# ------------------------------------------------------------- preemption
def test_preempt_frees_slot_pages_and_quota():
    S = tsched
    pt = pm.PageTable(n_pages=12, page_size=4, n_slots=2, max_pages=4)
    sched = S.Scheduler(2, pages=pt, policy=S.StrictPriorityPolicy(
        quotas={"batch": S.PageQuota(ceiling_frac=1.0)}))
    sched.submit(S.SeqState(0, [1] * 4, 4, slo=twork.BATCH))
    (slot, seq), = sched.next_tick().admit
    sched.on_prefilled(slot, 1)
    assert pt.n_reserved > 0 and sched._class_pages.get("batch", 0) > 0
    assert sched.preempt(slot) is seq
    assert sched.state[slot] is S.SlotState.FREE
    assert sched.stats["preempted"] == 1
    assert pt.n_reserved == 0 and pt.n_slot_owned == 0
    assert sched._class_pages.get("batch", 0) == 0
    pt.check_invariants()
    assert seq.req_id not in sched.finished


def _decode_slots(eng, s):
    return [i for i in eng.sched.live_slots()
            if eng.sched.slots[i] is not None
            and eng.sched.state[i] is s.sched.SlotState.DECODE]


@pytest.mark.parametrize("second_engine", [False, True])
def test_preempt_park_resume_equal_jax(second_engine):
    """preempt_export → hold the payload off-engine → adopt it back later
    (into the same engine while the survivor keeps decoding, or into a
    second engine): JAX's tokens and payloads, both pools drained."""
    def scenario(s):
        eng = s.engine(n_slots=2, policy=s.sched.StrictPriorityPolicy())
        eng.submit(_toks(1, 6), 8, slo=s.work.BATCH, t_arrive=0.0,
                   req_id=0)
        if not second_engine:
            eng.submit(_toks(2, 6), 8, slo=s.work.BATCH, t_arrive=0.1,
                       req_id=1)
        for _ in range(4):
            eng.step()
        victims = _decode_slots(eng, s)
        triples = eng.preempt_export(victims[:1])
        parked = eng.take_preempted()
        assert [t[0].req_id for t in triples] == \
            [t[0].req_id for t in parked] and len(parked) == 1
        seq, payload, pages = parked[0]
        assert pages > 0 and seq.generated and not seq.finished
        assert eng.sched.stats["preempted"] == 1
        dst = s.engine(n_slots=2, policy=s.sched.StrictPriorityPolicy()) \
            if second_engine else eng
        for _ in range(6):
            eng.step()
        dst.adopt([(seq, payload)])
        _drain(dst)
        _drain(eng)
        out = {r: q.generated for e in {id(eng): eng, id(dst): dst}.values()
               for r, q in e.sched.finished.items()}
        _assert_drained(eng)
        _assert_drained(dst)
        return {"out": out, "stats": [eng.stats, dst.stats],
                "payloads": [payload]}
    _both(scenario)


def test_standalone_engine_auto_preempts_and_self_readopts():
    """preemption=True without a cluster: an interactive arrival evicts a
    batch slot this very tick and the victim re-enters through the
    engine's own outbox → resume queue next step."""
    def scenario(s):
        eng = s.engine(n_slots=2, preemption=True,
                       policy=s.sched.StrictPriorityPolicy())
        W = s.work
        for i, (slo, n_tok) in enumerate([(W.BATCH, 10), (W.BATCH, 10),
                                          (W.INTERACTIVE, 4)]):
            eng.submit(_toks(20 + i, 6), n_tok, slo=slo, t_arrive=float(i),
                       req_id=i)
            if i == 1:
                for _ in range(3):
                    eng.step()
        eng.step()
        assert eng.sched.stats["preempted"] >= 1
        live = [eng.sched.slots[i] for i in eng.sched.live_slots()
                if eng.sched.slots[i] is not None]
        assert any(q.slo is W.INTERACTIVE for q in live)
        _drain(eng)
        out = {r: q.generated for r, q in eng.sched.finished.items()}
        assert set(out) == {0, 1, 2}
        _assert_drained(eng)
        return {"out": out, "stats": [eng.stats]}
    _both(scenario)


@settings(max_examples=4, deadline=None)
@given(ops=st.lists(st.integers(0, 9), min_size=4, max_size=20))
def test_random_submit_preempt_park_resume_interleavings(ops):
    """The same random op sequence on both packages: allocator invariants
    after every op, no sequence both shed and completed, none lost, the
    pool drained, and JAX's tokens, sheds and stats."""
    def scenario(s):
        classes = (s.work.BATCH, s.work.STANDARD, s.work.INTERACTIVE)
        eng = s.engine(n_slots=3, shed_limit=3,
                       policy=s.sched.StrictPriorityPolicy())
        parked, sent, shed = [], set(), set()
        for k, op in enumerate(ops):
            if op <= 3:                                        # submit
                sent.add(eng.submit(_toks(1000 + k, 5), 2 + k % 4,
                                    slo=classes[op % 3], t_arrive=float(k)))
            elif op <= 6:                                      # one tick
                eng.step()
            elif op == 7:                                      # preempt
                live = [i for i in _decode_slots(eng, s)
                        if not eng.sched.slots[i].finished
                        and eng.sched.slots[i].generated]
                if live:
                    eng.preempt_export([live[k % len(live)]])
                    parked.extend(eng.take_preempted())
            elif op == 8 and parked:                           # resume
                seq, payload, _ = parked.pop(0)
                eng.adopt([(seq, payload)])
            else:
                shed |= {r for r, _, _ in eng.take_shed()}
            eng.pages.check_invariants()
        for seq, payload, _ in parked:
            eng.adopt([(seq, payload)])
        _drain(eng)
        shed |= {r for r, _, _ in eng.take_shed()}
        out = {r: q.generated for r, q in eng.sched.finished.items()}
        assert not shed & set(out) and sent == shed | set(out)
        _assert_drained(eng)
        return {"out": out, "shed": shed, "stats": [eng.stats]}
    _both(scenario)


# ------------------------------------------------------------ engine roles
def test_scheduler_roles():
    """The copied scheduler's role gates (``tests/test_disagg.py``):
    validation, decode refuses submits, prefill refuses adoption, prompt-
    sized prefill admission, and export without decode."""
    S = tsched
    assert S.ROLES == ("unified", "prefill", "decode")
    with pytest.raises(ValueError):
        S.Scheduler(4, role="verifier")
    with pytest.raises(RuntimeError):
        S.Scheduler(4, role="decode").submit(S.SeqState(0, [1, 2, 3], 4))
    pre = S.Scheduler(4, role="prefill")
    for call in (lambda q: pre.adopt(q, 0), pre.enqueue_resume):
        with pytest.raises(RuntimeError):
            call(S.SeqState(0, [1, 2, 3], 4, generated=[7]))
    seq = S.SeqState(0, list(range(10)), 90)
    assert [S.Scheduler(4, role=r).admit_tokens(seq)
            for r in ("prefill", "decode", "unified")] == [10, 100, 100]
    pages = pm.PageTable(16, 4, 2, 8)
    s = S.Scheduler(2, role="prefill", pages=pages)
    s.submit(S.SeqState(0, [1, 2, 3], 4))
    slot = s.next_tick().admit[0][0]
    s.on_prefilled(slot, 11)
    assert s.next_tick().decode == [] and s.prefilled_slots() == [slot]
    assert s.export_slot(slot).req_id == 0 and s.stats["exported"] == 1
    assert 0 not in s.finished and slot in s.free_slots()
    assert pages.occupancy()["pages_live"] == 0


def test_engine_role_gates_and_set_role():
    c = _ctx()
    E = lambda **kw: ContinuousBatchingEngine(c["pcfg"], c["tp"], n_slots=2,
                                              max_len=32, **kw)
    uni, dec, pre = E(), E(role="decode"), E(role="prefill")
    with pytest.raises(RuntimeError):
        uni.export_prefilled()           # unified engines drain instead
    with pytest.raises(RuntimeError):
        dec.submit([1, 2, 3], 4)
    with pytest.raises(RuntimeError):
        pre.adopt([(tsched.SeqState(0, [1], 2, generated=[5]), None)])
    dec.set_role("unified")              # decode ↔ unified relaxes
    assert dec.role == dec.sched.role == "unified"
    dec.submit([1, 2, 3], 4)
    dec.set_role("decode")
    with pytest.raises(RuntimeError):
        dec.submit([1, 2, 3], 4)
    for eng, role in ((uni, "prefill"), (pre, "unified")):
        with pytest.raises(ValueError):
            eng.set_role(role)
    with pytest.raises(ValueError):      # non-paged cannot take a role
        E(paged=False, role="prefill")


@pytest.mark.parametrize("sharing", [True, False])
def test_prefill_export_decode_adopt_equal_jax(sharing):
    """Disaggregation on the wire: a prefill-role engine streams each
    prefilled slot out (``export_prefilled``, deduped under sharing) and
    a decode-role engine adopts and finishes it; JAX's tokens, stats and
    payloads, and the prefill pool turns its slots over."""
    pre = _toks(31, 20)
    prompts = [pre + _toks(800 + i, 3 + i) for i in range(3)] + \
        [_toks(810, 9), _toks(811, 14)]

    def scenario(s):
        p = s.engine(n_slots=2, role="prefill", prefix_sharing=sharing,
                     max_prefill_per_tick=2)
        d = s.engine(n_slots=3, role="decode", prefix_sharing=sharing)
        for i, pr in enumerate(prompts):
            p.submit(pr, 6, req_id=i)
        payloads = []
        while p.step() or p.sched.prefilled_slots():
            pairs = p.export_prefilled()
            payloads += [c for _, c in pairs]
            d.adopt(pairs)
            d.step()
        _drain(d)
        assert d.stats["prefills"] == 0 and p.stats["exported"] == 5
        _assert_drained(d)
        return {"out": {r: q.generated for r, q in d.sched.finished.items()},
                "stats": [p.stats, d.stats], "payloads": payloads}
    _both(scenario)
