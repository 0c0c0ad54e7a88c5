"""The port's execute-while-load path against the JAX package: block
packing, the copied λPipe planners, partial execution, the pipelined
forward and engine, and the mode switch.

Reduced configs at d_model 64 on the same weights (``repro_torch.bridge``).
The port's ``pack_model`` gives the same bytes and specs as the JAX one,
in fp32 and bf16 (the weight carry-over in wire form); block
unpacking, chained layer ranges and the multicast are bit-exact against
the port's own ``forward``; the pipelined forward agrees within 1e-4 (the
microbatches are separate matmuls); tokens equal the JAX
``InferenceEngine``'s.  The two end-to-end scenarios are the JAX
package's ``EWL_END_TO_END`` and ``CB_PIPELINE``
(``tests/test_multidevice.py``), on the CPU in one process.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import core as jcore
from repro import models as jm
from repro.configs import get_config, reduced
from repro.core import mode_switch as jms
from repro.serving.engine import InferenceEngine as JaxStaticEngine
from repro_torch import configs as pconfigs
from repro_torch import models as pm
from repro_torch.bridge import params_from_jax
from repro_torch.core import blocks as tb
from repro_torch.core import ewl as tewl
from repro_torch.core import mode_switch as tms
from repro_torch.core import multicast as tmc
from repro_torch.core import pipeline as tpl
from repro_torch.core.partial_exec import (apply_layer_range,
                                           embed_from_flat, head_from_flat,
                                           layer_range_of_units)
from repro_torch.distributed import (PipelinedEngine, multicast,
                                     multicast_reference, pipelined_forward,
                                     stage_params, stages_from_flat)
from repro_torch.serving import ContinuousBatchingEngine

TOL = 1e-4
DENSE, HYBRID, SSM = "qwen2.5-3b", "recurrentgemma-2b", "xlstm-1.3b"
N_LAYERS = {HYBRID: 5}
_CTX = {}


def _pair(arch=DENSE, dtype="f32", n_layers=None):
    key = (arch, dtype, n_layers)
    if key not in _CTX:
        n_layers = n_layers or N_LAYERS.get(arch)
        cfg = reduced(get_config(arch), d_model=64, n_layers=n_layers)
        pcfg = pconfigs.reduced(pconfigs.get_config(arch), d_model=64,
                                n_layers=n_layers)
        jp = jm.init_params(cfg, jax.random.PRNGKey(0),
                            dtype=jnp.bfloat16 if dtype == "bf16"
                            else jnp.float32)
        _CTX[key] = (cfg, pcfg, jp,
                     params_from_jax(pcfg, jax.device_get(jp), device="cpu"))
    return _CTX[key]


def _tokens(B, S, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 512,
                                                                 (B, S)))


# ------------------------------------------------ copied λPipe planners
SWEEP = [(2, 1, 1), (4, 4, 1), (8, 6, 1), (5, 7, 1), (7, 3, 2), (8, 6, 2),
         (8, 6, 3), (12, 9, 3), (16, 16, 4), (24, 10, 4)]


def _pipes(pipes):
    return [[(s.node, tuple(s.blocks)) for s in p.stages] for p in pipes]


@pytest.mark.parametrize("n,b,k", SWEEP)
def test_planners_equal_jax(n, b, k):
    """``binomial_schedule``, ``kway_schedule``, ``plan_scale`` and
    ``generate_pipelines`` give JAX's steps, orders and pipelines."""
    for fn in (lambda m: m.binomial_schedule(n, b),
               lambda m: m.kway_schedule(n, b, k)):
        got, want = fn(tmc), fn(jcore.multicast)
        assert got.steps == want.steps
        assert got.block_orders == want.block_orders
        assert got.sub_groups == want.sub_groups
    assert tmc.optimal_steps(n, b) == jcore.multicast.optimal_steps(n, b)
    got, want = tewl.plan_scale(n, b, k), jcore.plan_scale(n, b, k)
    assert got.schedule.steps == want.schedule.steps
    assert _pipes(got.pipelines) == _pipes(want.pipelines)
    assert got.pipeline_ready == want.pipeline_ready
    assert got.node_complete == want.node_complete
    assert [got.serving_instances_at(s) for s in range(got.total_steps + 1)] \
        == [want.serving_instances_at(s)
            for s in range(want.total_steps + 1)]
    groups = [g[1:] for g in got.schedule.sub_groups]
    assert _pipes(tpl.generate_pipelines(groups, b)) == \
        _pipes(jcore.generate_pipelines(groups, b))


# ------------------------------------------------------------------ blocks
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", [DENSE, HYBRID, SSM])
def test_pack_model_bytes_equal_jax(arch, dtype):
    """The port's flat keys are JAX's letter for letter, and its packed
    (n_blocks, P) buffer and block specs equal the JAX ``pack_model``'s
    byte for byte (bf16 leaves as bf16, the kept-fp32 leaves as fp32)."""
    cfg, pcfg, jp, tp = _pair(arch, dtype)
    assert sorted(tb.flatten_params(pcfg, tp)) == \
        sorted(jcore.flatten_params(cfg, jp))
    for n_blocks in (3, 4):
        got, gspecs = tb.pack_model(pcfg, tp, n_blocks)
        want, wspecs = jcore.pack_model(cfg, jp, n_blocks)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert [dataclasses.astuple(s) for s in gspecs] == \
            [dataclasses.astuple(s) for s in wspecs]


@settings(max_examples=20, deadline=None)
@given(shapes=st.lists(st.tuples(st.integers(1, 8), st.integers(1, 16)),
                       min_size=1, max_size=6),
       dt=st.sampled_from(["float32", "bfloat16", "int32"]))
def test_pack_roundtrip_bit_exact(shapes, dt):
    """Any tensors round-trip bit for bit; a tensor whose byte offset is a
    multiple of its item size comes back as a view into the buffer."""
    gen = torch.Generator().manual_seed(0)
    flat = {}
    for i, (a, b) in enumerate(shapes):
        x = torch.randn((a, b), generator=gen)
        flat[f"t{i}"] = (x * 100).to(torch.int32) if dt == "int32" \
            else x.to(getattr(torch, dt))
    flat["u"] = torch.ones((3,), dtype=torch.bfloat16)   # odd byte count
    flat["v"] = torch.arange(5, dtype=torch.float32)     # may misalign
    buf, spec = tb.pack_block(flat, list(flat))
    assert buf.dtype == torch.uint8 and buf.numel() % tb.PAD_ALIGN == 0
    out = tb.unpack_block(buf, spec)
    base = buf.data_ptr()
    for ts in spec.tensors:
        got = out[ts.key]
        assert got.dtype == flat[ts.key].dtype
        assert torch.equal(got, flat[ts.key])
        aligned = ts.offset % got.element_size() == 0
        assert (got.data_ptr() == base + ts.offset) == aligned


@pytest.mark.parametrize("arch", [DENSE, HYBRID, SSM])
def test_model_pack_roundtrip_drives_identical_forward(arch):
    cfg, pcfg, jp, tp = _pair(arch)
    stacked, specs = tb.pack_model(pcfg, tp, 4)
    p2 = tb.unpack_model(pcfg, stacked, specs)
    want, got = tb.flatten_params(pcfg, tp), tb.flatten_params(pcfg, p2)
    assert sorted(got) == sorted(want)
    for k, t in want.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    batch = {"tokens": _tokens(2, 32)}
    o1 = pm.forward(pcfg, tp, batch)["logits"]
    o2 = pm.forward(pcfg, p2, batch)["logits"]
    assert float((o1 - o2).abs().max()) == 0.0


@pytest.mark.parametrize("n_blocks", [1, 2, 5, 16])
@pytest.mark.parametrize("arch", ["starcoder2-3b", "whisper-large-v3",
                                  "xlstm-1.3b", "recurrentgemma-2b"])
def test_block_assignment_equal_jax(arch, n_blocks):
    pcfg = pconfigs.reduced(pconfigs.get_config(arch))
    cfg = reduced(get_config(arch))
    assign = tb.block_assignment(pcfg, n_blocks)
    assert assign == jcore.block_assignment(cfg, n_blocks)
    units = [u for blk in assign for u in blk]
    assert len(units) == len(set(units)) == len(tb.unit_order(pcfg))


# --------------------------------------------------------- partial exec
@pytest.mark.parametrize("arch", [DENSE, HYBRID, SSM])
def test_chained_ranges_equal_forward(arch):
    """Embedding, two chained layer ranges and the head, from the flat
    dict, give exactly the port's forward and JAX's within TOL."""
    cfg, pcfg, jp, tp = _pair(arch)
    flat = tb.flatten_params(pcfg, tp)
    tokens = _tokens(2, 32)
    B, S = tokens.shape
    positions = torch.arange(S).expand(B, S)
    x = embed_from_flat(pcfg, flat, tokens)
    mid = max(1, pcfg.n_layers // 2)
    x = apply_layer_range(pcfg, flat, x, 0, mid, positions)
    x = apply_layer_range(pcfg, flat, x, mid, pcfg.n_layers, positions)
    out = head_from_flat(pcfg, flat, x)
    assert torch.equal(out, pm.forward(pcfg, tp, {"tokens": tokens})
                       ["logits"])
    want = jm.forward(cfg, jp, {"tokens": jnp.asarray(tokens.numpy(),
                                                      jnp.int32)})["logits"]
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_layer_range_of_units():
    pcfg = pconfigs.reduced(pconfigs.get_config(DENSE), n_layers=2)
    assign = tb.block_assignment(pcfg, 2)
    assert layer_range_of_units(assign[0]) == (0, 1)
    assert layer_range_of_units(assign[-1]) == (1, 2)
    assert layer_range_of_units(["@embed"]) == (0, 0)


def test_missing_layer_raises():
    _, pcfg, _, tp = _pair()
    flat = {k: v for k, v in tb.flatten_params(pcfg, tp).items()
            if not k.startswith("@layer0001")}
    with pytest.raises(KeyError, match="layer 1"):
        apply_layer_range(pcfg, flat, torch.zeros((1, 4, pcfg.d_model)),
                          0, 2, torch.zeros((1, 4), dtype=torch.int64))


# -------------------------------------------------------------- pipeline
@pytest.mark.parametrize("n_microbatches", [1, 4])
def test_pipelined_forward_equals_forward(n_microbatches):
    """Four CPU stages of two layers each, with 1 and 4 microbatches,
    against the port's forward (full logits, and the head on each row's
    last position alone)."""
    _, pcfg, _, tp = _pair(DENSE, n_layers=8)
    stages = stage_params(pcfg, tp, 4, ["cpu"] * 4)
    assert [(s.lo, s.hi) for s in stages] == [(0, 2), (2, 4), (4, 6),
                                              (6, 8)]
    assert "@embed/embed" in stages[0].flat and \
        "@embed/embed" in stages[-1].flat            # tied embeddings
    tokens = _tokens(8, 32, seed=3)
    ref = pm.forward(pcfg, tp, {"tokens": tokens})["logits"]
    out = pipelined_forward(pcfg, stages, {"tokens": tokens},
                            n_microbatches)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=TOL,
                               rtol=TOL)
    last = torch.tensor([31, 0, 5, 17, 31, 2, 9, 30])
    rows = pipelined_forward(pcfg, stages, {"tokens": tokens},
                             n_microbatches, last=last)
    assert torch.equal(rows, out[torch.arange(8), last])


def test_stage_params_rejects_non_uniform_trunk():
    _, pcfg, _, tp = _pair(HYBRID)
    with pytest.raises(AssertionError, match="uniform"):
        stage_params(pcfg, tp, 5, ["cpu"] * 5)


# ------------------------------------------------------------ mode switch
@pytest.mark.parametrize("arch", [DENSE, HYBRID, SSM])
def test_recomputed_cache_continues_exactly(arch):
    """A cache recomputed from prompt + generated tokens continues with
    the logits of a cache decoded live all along (attention K/V and
    recurrent state), and both agree with JAX's live decode."""
    cfg, pcfg, jp, tp = _pair(arch)
    S_prompt, n_gen = 24, 8
    tokens = _tokens(2, S_prompt, seed=4)
    cache_len = S_prompt + n_gen + 4
    pre = pm.forward(pcfg, tp, {"tokens": tokens}, build_cache=True)
    cache = pm.cache_from_prefill(pcfg, pre["kv"], cache_len, S_prompt)
    toks = [pre["logits"][:, -1].argmax(-1)]
    for _ in range(n_gen - 1):
        logits, cache = pm.decode_step(pcfg, tp, cache, toks[-1],
                                       cache["pos"])
        toks.append(logits.argmax(-1))
    live, _ = pm.decode_step(pcfg, tp, cache, toks[-1], cache["pos"])
    seq = torch.cat([tokens, torch.stack(toks, 1)], 1)
    cache3 = tms.recompute_cache(pcfg, tp, {"tokens": seq[:, :-1]},
                                 cache_len=cache_len)
    switch, _ = pm.decode_step(pcfg, tp, cache3, toks[-1], cache3["pos"])
    assert float((switch - live).abs().max()) < 2e-4
    jcache = jms.recompute_cache(cfg, jp, {"tokens": jnp.asarray(
        seq[:, :-1].numpy(), jnp.int32)}, cache_len=cache_len)
    jlive, _ = jm.decode_step(cfg, jp, jcache, jnp.asarray(
        toks[-1].numpy(), jnp.int32), jcache["pos"])
    np.testing.assert_allclose(switch.numpy(), np.asarray(jlive), atol=TOL,
                               rtol=TOL)


def test_redistribute_and_costs_equal_jax():
    assert tms.redistribute(list(range(10)), [1, 2, 3]) == \
        jms.redistribute(list(range(10)), [1, 2, 3])
    for arch in ("llama2-13b", DENSE, HYBRID, SSM):
        pcfg, cfg = pconfigs.get_config(arch), get_config(arch)
        assert tms.recompute_cost(pcfg, 64, 8, 197e12) == \
            jms.recompute_cost(cfg, 64, 8, 197e12)
        assert tms.kv_transfer_cost(pcfg, 64, 8, 8, 50e9) == \
            jms.kv_transfer_cost(cfg, 64, 8, 8, 50e9)
    pcfg = pconfigs.get_config("llama2-13b")
    assert tms.recompute_cost(pcfg, 64, 8, 197e12) < 0.2


# ------------------------------------------------------------ end to end
def test_execute_while_load_end_to_end():
    """``EWL_END_TO_END``: pack on the source, multicast the blocks with
    the λPipe 1→8 schedule across 8 node buffers, unpack on node 7: every
    node holds the source's bytes and node 7's logits equal the source's
    exactly."""
    _, pcfg, _, tp = _pair(DENSE, n_layers=8)
    stacked, specs = tb.pack_model(pcfg, tp, 6)
    assert stacked.shape[0] == 6
    plan = tewl.plan_scale(8, 6, k=1)
    bufs = [stacked.clone()] + [torch.zeros_like(stacked)
                                for _ in range(7)]
    ref = multicast_reference(np.stack([b.numpy() for b in bufs]),
                              plan.schedule)
    multicast(bufs, plan.schedule)
    for n, buf in enumerate(bufs):
        assert torch.equal(buf, stacked), n
        np.testing.assert_array_equal(buf.numpy(), ref[n])
    params7 = tb.unpack_model(pcfg, bufs[7], specs)
    batch = {"tokens": _tokens(2, 32)}
    got = pm.forward(pcfg, params7, batch)["logits"]
    want = pm.forward(pcfg, tp, batch)["logits"]
    assert float((got - want).abs().max()) == 0.0


@pytest.mark.parametrize("source", ["params", "blocks"])
def test_pipelined_engine_mode_switch_equal_jax(source):
    """``CB_PIPELINE``: the pipelined engine (four stages, two
    microbatches; its stages cut from the weights or from a receiving
    node's unpacked blocks) serves four ticks mid-multicast, drains, and
    hands off to a local engine, which recomputes each cache once and
    finishes: JAX ``InferenceEngine``'s tokens, and no adopted sequence
    is prefilled again."""
    cfg, pcfg, jp, tp = _pair(DENSE, n_layers=4)
    if source == "params":
        stages = stage_params(pcfg, tp, 4, ["cpu"] * 4)
    else:
        stacked, specs = tb.pack_model(pcfg, tp, 4)
        node = torch.zeros_like(stacked)
        multicast([stacked, node], tmc.binomial_schedule(2, 4))
        stages = stages_from_flat(pcfg, tb.unpack_flat(node, specs), 4,
                                  ["cpu"] * 4)
    pipe = PipelinedEngine.from_stages(pcfg, stages, n_microbatches=2,
                                       n_slots=2, max_len=48, pad_to=8)
    ref = JaxStaticEngine(cfg, jp, max_len=48)
    prompts = {0: list(range(1, 9)), 1: list(range(3, 15)),
               2: [5, 4, 3, 2, 1]}
    want = {i: list(map(int, ref.generate(
        {"tokens": jnp.asarray(p, jnp.int32)[None]}, 6,
        cache_len=48)[0])) for i, p in prompts.items()}
    for i, p in prompts.items():
        pipe.submit(p, 6, req_id=i)
    for _ in range(4):                  # serve mid-multicast ...
        pipe.step()
    pipe.drain()                        # ... then mode-switch
    local = ContinuousBatchingEngine(pcfg, tp, n_slots=4, max_len=48)
    pairs = pipe.handoff()
    queued = sum(not s.generated for s, _ in pairs)
    local.adopt(pairs)
    done = {r: s.generated for r, s in pipe.sched.finished.items()}
    done.update(local.run())
    assert done == want
    # only requests still queued at the drain are prefilled locally
    assert local.stats["adopted"] >= 1
    assert local.stats["prefills"] == queued
