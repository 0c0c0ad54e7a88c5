"""The port's dry-run and fit stack against the JAX package.

Sharding rules: JAX's ``_weight_spec`` cases; ``param_shardings`` for
every config at full width (cut to two repetitions of its layer pattern
and its remainder) on JAX's stand-in mesh shapes
({"data":16,"model":16} and {"pod":2,"data":16,"model":16}) under each
option, leaf by leaf through ``repro_torch.bridge``'s correspondence
(shapes from ``jax.eval_shape`` and ``FakeTensorMode``), the local shard
shapes the specs imply; ``batch_shardings`` and ``cache_shardings``
(``dh``, ``seq``); ``supports_long``, ``applicable`` and ``batch_specs``.
Cost: ``OpCost`` counts the loops and the reduced forward exactly as
``HloCost`` counts JAX's compiled programs.  On placeholder ranks (one
subprocess, started first and read last, with a time limit): a column-
and a row-parallel product on a 2×2 mesh against a reckoning, JAX's
mini multi-pod dry-run (``tests/test_multidevice.py`` ``MINI_DRYRUN``)
through ``build_dryrun`` and ``run_one``, DTensor's own local shapes at
full width, and the execute-while-load pipeline's per-device trunk
FLOPs against the M/(M+N−1) reckoning.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.configs import list_archs
from repro.configs import reduced as jreduced
from repro.distributed import sharding as jsh
from repro.launch import specs as jspecs
from repro.launch.hlo_cost import HloCost
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro_torch import bridge
from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed import sharding as psh
from repro_torch.launch import specs as pspecs
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import init_cache, init_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list_archs() + ["llama2-7b"]
MINI_ARCHS = ("qwen2.5-3b", "qwen2-moe-a2.7b")


class FakeMesh:
    """JAX's stand-in mesh (``tests/test_sharding_and_hlo.py``): a shape
    mapping and its axis names, for both packages' rules."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"16x16": FakeMesh({"data": 16, "model": 16}),
          "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16})}
OPTIONS = [{}, {"fsdp": False}, {"moe_expert_parallel": True},
           {"tp_pairs": True}, {"pure_fsdp": True}]

# the keys of a record of the JAX package's ``launch.dryrun.run_one``
JAX_RECORD_KEYS = sorted([
    "arch", "shape", "mesh", "status", "n_chips", "lower_s", "compile_s",
    "memory", "hlo_flops", "hlo_bytes", "xla_cost_flops",
    "collective_bytes", "collective_counts", "t_compute", "t_memory",
    "t_collective", "model_flops", "bottleneck", "useful_flops_ratio"])
JAX_MEMORY_KEYS = sorted(["argument_size_in_bytes", "output_size_in_bytes",
                          "temp_size_in_bytes",
                          "generated_code_size_in_bytes"])

# ------------------------------------------------ placeholder-rank script
MESH_SCRIPT = r"""
import dataclasses, json, sys, torch
torch.set_num_threads(1)
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.distributed import sharding as psh
from repro_torch.launch.dryrun import run_one
from repro_torch.launch.dryrun_ewl import run_ewl
from repro_torch.launch.mesh import placeholder_mesh
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import init_params

def emit(name, value):
    print(json.dumps({name: value}), flush=True)

# 1. JAX's MINI_DRYRUN: reduced qwen2.5-3b and qwen2-moe-a2.7b, train at
# 8x128 and decode at 8x256 on a (pod, data, model) = (2, 2, 2) mesh (the
# (arch, shape) pairs given to this process)
mesh = placeholder_mesh((2, 2, 2), ("pod", "data", "model"))
for item in sys.argv[1:]:
    if item == "rest":
        continue
    arch, sn = item.split(":")
    seq = {"train_4k": 128, "decode_32k": 256}[sn]
    shape = dataclasses.replace(SHAPES[sn], seq_len=seq, global_batch=8)
    rec = run_one(arch, sn, mesh=mesh, cfg=reduced(get_config(arch)),
                  shape=shape, multi_pod=True, verbose=False)
    rec.pop("traceback", None)
    emit("mini_" + item, rec)
if "rest" not in sys.argv:
    sys.exit(0)

# 2. column- then row-parallel product on (data=2, model=2)
mesh = placeholder_mesh((2, 2), ("data", "model"))
with FakeTensorMode():
    x = DTensor.from_local(torch.empty(4, 16), mesh, (Shard(0), Replicate()),
                           run_check=False)
    w1 = DTensor.from_local(torch.empty(16, 16), mesh,
                            (Replicate(), Shard(1)), run_check=False)
    w2 = DTensor.from_local(torch.empty(16, 16), mesh,
                            (Replicate(), Shard(0)), run_check=False)
    with OpCost() as col:
        y = x @ w1
    with OpCost() as row:
        z = (y @ w2).redistribute(mesh, (Shard(0), Replicate()))
emit("tp", {"col": [col.flops, col.collective_bytes, list(y.placements)
                    .__repr__()],
            "row": [row.flops, row.collective_bytes,
                    row.collective_counts, z.to_local().shape[0]]})

# 3. DTensor's own shard shapes of the full-width rules
for dims, axes in (((16, 16), ("data", "model")),
                   ((2, 16, 16), ("pod", "data", "model"))):
    mesh = placeholder_mesh(dims, axes)
    bad = []
    for arch in ("qwen2.5-3b", "whisper-large-v3"):
        with FakeTensorMode():
            params = init_params(get_config(arch), 0, torch.bfloat16,
                                 device="cpu")
        place = psh.param_shardings(get_config(arch), mesh, params)
        flat = []
        psh._map_with_path(lambda p, t: flat.append(
            (p, t.shape, psh._leaf_at(place, p))), params)
        for path, shape, pl in flat:
            want, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
            if tuple(want) != psh.local_shape(shape, pl, mesh):
                bad.append([arch, str(path)])
    emit("local_" + "x".join(map(str, dims)), bad)

# 4. execute-while-load: 4 stages over "data", 2-way "model"
mesh = placeholder_mesh((4, 2), ("data", "model"))
cfg = dataclasses.replace(reduced(get_config("llama2-7b"), d_model=64),
                          n_layers=8)
rec = run_ewl("llama2-7b", batch=8, seq=32, microbatches=2, mesh=mesh,
              cfg=cfg, verbose=False)
emit("ewl", rec)
"""


@pytest.fixture(scope="module")
def mesh_run():
    """The placeholder-rank script in its own processes (the fake group is
    process-wide; one for each mini training step, one for the rest), all
    started when first asked for and read at the end."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    parts = [[f"{a}:train_4k"] for a in MINI_ARCHS] + [
        [f"{a}:decode_32k" for a in MINI_ARCHS] + ["rest"]]
    procs = [subprocess.Popen([sys.executable, "-c", MESH_SCRIPT, *part],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for part in parts]
    box = {}

    def result():
        if not box:
            for proc in procs:
                try:
                    out, err = proc.communicate(timeout=240)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    raise
                assert proc.returncode == 0, err[-3000:]
                for line in out.splitlines():
                    if line.startswith("{"):
                        box.update(json.loads(line))
        return box

    yield result
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_data_axes_equal_jax(mesh_run):
    """``data_axes`` names JAX's data axes of both production meshes.
    (Asking for ``mesh_run`` starts the placeholder-rank processes here,
    before the long in-process tests; the tests that read them come
    last.)"""
    from types import SimpleNamespace

    from repro.launch.mesh import data_axes as jax_data_axes
    from repro_torch.launch.mesh import data_axes

    for axes in (("data", "model"), ("pod", "data", "model")):
        assert data_axes(SimpleNamespace(mesh_dim_names=axes)) == \
            jax_data_axes(SimpleNamespace(axis_names=axes))


# ----------------------------------------------------------------- helpers
def _norm(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _jax_spec(spec, ndim):
    out = [_norm(e) for e in tuple(spec)]
    return tuple(out + [()] * (ndim - len(out)))


def _port_spec(place, mesh, ndim):
    return tuple(_norm(e) for e in psh.to_spec(place, mesh, ndim))


def _implied(shape, spec, mesh):
    return tuple(n // int(np.prod([mesh.shape[a] for a in s]))
                 for n, s in zip(shape, spec))


def _is_stacked(path):
    keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
    return "trunk" in keys or ("layers" in keys and "enc" in keys)


def _correspond(cfg, jtree, to_port):
    """(jax path, jax leaf, stacked) for each port leaf path, through the
    bridge: every JAX leaf becomes its index (a vector of it over a
    stacked leaf's repetitions) and goes through ``to_port``."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jtree)
    ids = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jtree),
        [np.full((leaf.shape[0],), i) if _is_stacked(path)
         else np.asarray(i) for i, (path, leaf) in enumerate(flat)])
    port = to_port(cfg, ids, device="cpu")
    out = {}
    psh._map_with_path(lambda p, t: out.__setitem__(
        p, (flat[int(t)][0], flat[int(t)][1], _is_stacked(flat[int(t)][0]))),
        port)
    return out


def _depth_cut(cfg):
    """Full width, two repetitions of the layer pattern and the remainder
    (the rules read no depth; the stacked trunk, its unstacking and the
    remainder layers all stay)."""
    n = min(cfg.n_layers, 2 * cfg.pattern_len
            + cfg.n_layers % cfg.pattern_len)
    kw = {"n_enc_layers": 2} if cfg.family == "encdec" else {}
    return dataclasses.replace(cfg, n_layers=n, **kw)


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(JAX config, port config, JAX shape tree, port fake params, their
    correspondence) of a full-width config cut in depth."""
    cfg, pcfg = _depth_cut(jget(arch)), _depth_cut(get_config(arch))
    jtree = jax.eval_shape(
        lambda: jinit_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16))
    with FakeTensorMode():
        params = init_params(pcfg, 0, torch.bfloat16, device="cpu")
    return cfg, pcfg, jtree, params, _correspond(cfg, jtree,
                                                 bridge.params_from_jax)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ rules
def test_weight_spec_cases_equal_jax():
    mesh = MESHES["16x16"]
    for shape, skip in (((2048, 4096), 0), ((51866, 1280), 0),
                        ((60, 2048, 1408), 0), ((7, 13), 0),
                        ((24, 2048, 4096), 1)):
        want = jsh._weight_spec(shape, mesh, skip_leading=skip)
        got = psh._weight_spec(shape, mesh, skip_leading=skip)
        assert _port_spec(got, mesh, len(shape)) == \
            _jax_spec(want, len(shape)), shape
    assert psh.to_spec(psh._weight_spec((2048, 4096), mesh), mesh, 2) == \
        ("data", "model")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_equal_jax(arch, mesh_name):
    """Every option: the same spec for every leaf (a stacked JAX leaf's
    leading entry is None and the rest is the port layer leaf's), and
    the same local shard shape."""
    mesh = MESHES[mesh_name]
    cfg, pcfg, jtree, params, corr = _shapes(arch)
    assert cfg.d_model == jget(arch).d_model
    assert len(corr) == len(jax.tree.leaves(jtree)) + sum(
        (leaf.shape[0] - 1) for path, leaf in
        jax.tree_util.tree_flatten_with_path(jtree)[0] if _is_stacked(path))
    for opts in OPTIONS:
        jspec = jsh.param_shardings(cfg, mesh, jtree, **opts)
        jflat = {jax.tree_util.keystr(p): s for p, s in
                 jax.tree_util.tree_flatten_with_path(
                     jspec, is_leaf=lambda x: isinstance(x, P))[0]}
        place = psh.param_shardings(pcfg, mesh, params, **opts)
        for path, (jpath, jleaf, stacked) in corr.items():
            leaf = psh._leaf_at(params, path)
            want = _jax_spec(jflat[jax.tree_util.keystr(jpath)], jleaf.ndim)
            if stacked:
                assert want[0] == (), (arch, path)
                want, jshape = want[1:], tuple(jleaf.shape[1:])
            else:
                jshape = tuple(jleaf.shape)
            assert tuple(leaf.shape) == jshape, (arch, path)
            pl = psh._leaf_at(place, path)
            assert _port_spec(pl, mesh, leaf.ndim) == want, \
                (arch, mesh_name, opts, path)
            assert psh.local_shape(leaf.shape, pl, mesh) == \
                _implied(jshape, want, mesh), (arch, opts, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_shardings_equal_jax(arch):
    """``batch_shardings`` on each shape's batch, and ``cache_shardings``
    (``dh`` and ``seq``) on the decode_32k cache, leaf by leaf through
    ``bridge.cache_from_jax``."""
    cfg, pcfg = jget(arch), get_config(arch)
    for mesh in MESHES.values():
        for name in SHAPES:
            sh = JSHAPES[name]
            jb = jspecs.batch_specs(cfg, sh.global_batch, sh.seq_len)
            pb = pspecs.batch_specs(pcfg, sh.global_batch, sh.seq_len)
            js, ps = jsh.batch_shardings(mesh, jb), \
                psh.batch_shardings(mesh, pb)
            for k in jb:
                assert _port_spec(ps[k], mesh, pb[k].ndim) == \
                    _jax_spec(js[k], jb[k].ndim), (arch, name, k)
        B, L = SHAPES["decode_32k"].global_batch, SHAPES["decode_32k"].seq_len
        jc = jax.eval_shape(lambda: jinit_cache(cfg, B, L, jnp.bfloat16))
        with FakeTensorMode():
            pc = init_cache(pcfg, B, L, dtype=torch.bfloat16, device="cpu")
        corr = _correspond(cfg, jc, bridge.cache_from_jax)
        for mode in ("dh", "seq"):
            js = jsh.cache_shardings(cfg, mesh, jc, mode=mode)
            jflat = {jax.tree_util.keystr(p): s for p, s in
                     jax.tree_util.tree_flatten_with_path(
                         js, is_leaf=lambda x: isinstance(x, P))[0]}
            place = psh.cache_shardings(pcfg, mesh, pc, mode=mode)
            for path, (jpath, jleaf, _) in corr.items():
                want = _jax_spec(jflat[jax.tree_util.keystr(jpath)],
                                 jleaf.ndim)
                if "trunk" in str(jpath):
                    assert want[0] == ()
                    want = want[1:]
                leaf = psh._leaf_at(pc, path)
                got = _port_spec(psh._leaf_at(place, path), mesh, leaf.ndim)
                assert got == want, (arch, mode, path)


def test_supports_long_and_applicable_equal_jax():
    for arch in ARCHS:
        cfg, pcfg = jget(arch), get_config(arch)
        assert pspecs.supports_long(pcfg) == jspecs.supports_long(cfg), arch
        for name in SHAPES:
            assert pspecs.applicable(pcfg, SHAPES[name]) == \
                jspecs.applicable(cfg, JSHAPES[name]), (arch, name)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_batch_specs_equal_jax(dtype):
    for arch in ARCHS:
        cfg, pcfg = jget(arch), get_config(arch)
        for name, sh in SHAPES.items():
            jb = jspecs.batch_specs(cfg, sh.global_batch, sh.seq_len,
                                    getattr(jnp, dtype))
            pb = pspecs.batch_specs(pcfg, sh.global_batch, sh.seq_len,
                                    getattr(torch, dtype))
            assert sorted(jb) == sorted(pb)
            for k in jb:
                assert tuple(pb[k].shape) == jb[k].shape, (arch, name, k)
                assert str(pb[k].dtype).removeprefix("torch.") == \
                    jnp.dtype(jb[k].dtype).name, (arch, name, k)


# ------------------------------------------------------------------- cost
def _hlo_flops(f, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return HloCost(jax.jit(f).lower(*args).compile().as_text()).flops


def test_loops_count_like_hlo_cost():
    """A ten-step loop and a 3×5 nested loop of matmuls: ``OpCost`` on
    the eager loops counts what ``HloCost`` counts on JAX's scans."""
    def scan10(x, w):
        return jax.lax.scan(lambda c, _: (c @ w, None), x, None,
                            length=10)[0]

    def nested(x, w):
        def outer(c, _):
            return jax.lax.scan(lambda c2, _: (c2 @ w, None), c, None,
                                length=5)[0], None
        return jax.lax.scan(outer, x, None, length=3)[0]

    with FakeTensorMode():
        x, w = torch.empty(256, 256), torch.empty(256, 256)
        with OpCost() as c10:
            for _ in range(10):
                x = x @ w
        x, w = torch.empty(128, 128), torch.empty(128, 128)
        with OpCost() as c15:
            for _ in range(3):
                for _ in range(5):
                    x = x @ w
    assert c10.flops == _hlo_flops(scan10, (256, 256), (256, 256)) \
        == 10 * 2 * 256 ** 3 == 335_544_320
    assert c15.flops == _hlo_flops(nested, (128, 128), (128, 128)) \
        == 15 * 2 * 128 ** 3 == 62_914_560
    # a matmul loop writes one (256, 256) fp32 output a step; two live
    assert c10.bytes == 10 * 256 * 256 * 4
    assert c10.peak_bytes == 2 * 256 * 256 * 4


def test_reduced_forward_flops_equal_hlo_cost():
    """``reduced(qwen2.5-3b)`` forward at 4×128 in fp32: the port's plain
    forward counts JAX's compiled forward's FLOPs exactly."""
    from repro.models import forward as jforward
    from repro_torch.models import forward

    cfg = jreduced(jget("qwen2.5-3b"))
    shapes = jax.eval_shape(
        lambda: jinit_params(cfg, jax.random.PRNGKey(0), jnp.float32))
    batch = jspecs.batch_specs(cfg, 4, 128, jnp.float32)
    want = HloCost(jax.jit(lambda p, b: jforward(cfg, p, b)["logits"])
                   .lower(shapes, batch).compile().as_text()).flops
    from repro_torch.configs import reduced
    pcfg = reduced(get_config("qwen2.5-3b"))
    with FakeTensorMode():
        params = init_params(pcfg, 0, torch.float32, device="cpu")
        b = pspecs.batch_specs(pcfg, 4, 128, torch.float32)
        with pspecs.fresh_consts(), OpCost() as cost:
            forward(pcfg, params, b, kernel_impl="plain")
    assert cost.flops == want == 1_879_048_192


def test_loops_traced_for_one_trip_count_like_the_loops():
    """The dry-run traces the mLSTM chunk loop and the sLSTM step loop for
    one trip counted once a trip: the forward counts the loops' own
    FLOPs; the backward, one trip's backward with every input and carry
    differentiated, counts no fewer and at most 10% more in all (the
    loops skip the gradient of their zero initial state and of the
    carry their last trip leaves)."""
    from repro_torch.configs import reduced
    from repro_torch.kernels.ref import mlstm_chunkwise_ref
    from repro_torch.models import xlstm as X

    cfg = reduced(get_config("xlstm-1.3b"), d_model=64)
    B, H, S, dh, chunk = 2, 2, 48, 16, 16
    with FakeTensorMode():
        mk = lambda *s: torch.empty(s).requires_grad_()  # noqa: E731
        q, k, v = mk(B, H, S, dh), mk(B, H, S, dh), mk(B, H, S, dh)
        i_pre, f_pre = mk(B, H, S), mk(B, H, S)
        p = init_params(cfg, 0, torch.float32, device="cpu")["layers"][7]
        p = {n: t.requires_grad_() for n, t in p["slstm"].items()}
        x = mk(B, S, cfg.d_model)
        fwd, total = [], []
        for mlstm, slstm in ((mlstm_chunkwise_ref, X.apply_slstm),
                             (pspecs._mlstm_trips, pspecs._slstm_trips)):
            with OpCost() as cost:
                h, _ = mlstm(q, k, v, i_pre, f_pre, chunk=chunk)
                out, _ = slstm(p, x, cfg)
                fwd.append(cost.flops)
                torch.autograd.grad(h.sum() + out.sum(),
                                    [q, k, v, x] + list(p.values()))
            total.append(cost.flops)
    assert fwd[0] == fwd[1] > 0
    assert total[0] <= total[1] <= 1.1 * total[0]


def test_autotune_without_device_raises_on_cpu(tmp_path, monkeypatch):
    """No ``measure``, no ``device`` and no GPU: the sweep refuses instead
    of timing the CPU; an injected ``measure`` keys as before."""
    from repro_torch.kernels.autotune import autotune_paged_decode

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2.5-3b")
    path = str(tmp_path / "t.json")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune_paged_decode(cfg, n_slots=2, max_len=32, cache_file=path)
    assert not os.path.exists(path)          # nothing keyed or stored
    res = autotune_paged_decode(cfg, n_slots=2, max_len=32, cache_file=path,
                                measure=lambda c, n, m, ps, impl: ps)
    assert res.page_size == 8
    assert "|kernel|cpu" in open(path).read()


# ------------------------------------------------- on placeholder ranks
def test_tensor_parallel_products_on_2x2(mesh_run):
    """x (8,16) split over "data" times a column-parallel (16,32): each
    rank multiplies (4,16) by (16,16), no collective.  Then times a
    row-parallel (32,16): (4,16) by (16,16) again, a partial sum that one
    all-reduce of the (4,16) fp32 result replicates over "model"."""
    got = mesh_run()["tp"]
    flops, coll, place = got["col"]
    assert flops == 2 * 4 * 16 * 16
    assert sum(coll.values()) == 0
    assert place == "[Shard(dim=0), Shard(dim=1)]"
    flops, coll, counts, rows = got["row"]
    assert flops == 2 * 4 * 16 * 16
    assert coll == {"all-gather": 0.0, "all-reduce": 4 * 16 * 4.0,
                    "reduce-scatter": 0.0, "all-to-all": 0.0,
                    "collective-permute": 0.0}
    assert counts["all-reduce"] == 1 and rows == 4


def test_mini_multipod_dryrun(mesh_run):
    got = mesh_run()
    recs = [got[f"mini_{a}:{s}"] for a in MINI_ARCHS
            for s in ("train_4k", "decode_32k")]
    assert [(r["arch"], r["shape"]) for r in recs] == [
        (a, s) for a in MINI_ARCHS for s in ("train_4k", "decode_32k")]
    for r in recs:
        assert r["status"] == "ok", r.get("error")
        assert sorted(r) == JAX_RECORD_KEYS
        assert sorted(r["memory"]) == JAX_MEMORY_KEYS
        assert r["memory"]["temp_size_in_bytes"] > 0
        assert r["n_chips"] == 8 and r["hlo_flops"] > 0
        assert r["bottleneck"] in ("compute", "memory", "collective")
    # the train step updates the weights and the moments in place: its
    # outputs are its arguments' shards
    for r in recs[0::2]:
        m = r["memory"]
        assert m["output_size_in_bytes"] <= m["argument_size_in_bytes"]


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
def test_local_shapes_are_dtensors(mesh_run, mesh_name):
    """``sharding.local_shape`` is DTensor's own shard shape for every
    full-width leaf (qwen2.5-3b, and whisper's 51866 vocabulary)."""
    assert mesh_run()["local_" + mesh_name] == []


def test_ewl_trunk_flops_reckoning(mesh_run):
    """The port's stages compute their M microbatches; JAX's SPMD body
    computes on all M + N − 1 ticks, its stage replicated over "model".
    So the port's per-device trunk FLOPs are JAX's × M/(M+N−1) / TP, with
    one layer's FLOPs on a microbatch from ``HloCost``."""
    from repro.models import model as jmm

    rec = mesh_run()["ewl"]
    cfg = dataclasses.replace(jreduced(jget("llama2-7b"), d_model=64),
                              n_layers=8)
    M, N, TP, B, S = 2, 4, 2, 8, 32
    mb = B // M
    p = jax.eval_shape(lambda: jinit_params(cfg, jax.random.PRNGKey(0),
                                            jnp.bfloat16))
    lp = jax.tree.map(lambda t: jax.ShapeDtypeStruct(t.shape[1:], t.dtype),
                      p["trunk"][0])
    x = jax.ShapeDtypeStruct((mb, S, cfg.d_model), jnp.bfloat16)
    pos = jnp.broadcast_to(jnp.arange(S)[None], (mb, S))

    def layer(lp, x):
        return jmm._apply_layer_full(lp, x, cfg, cfg.layer_pattern[0], pos,
                                     moe_cf=None)[0]
    layer_flops = HloCost(jax.jit(layer).lower(lp, x).compile()
                          .as_text()).flops
    jax_trunk = (M + N - 1) * (cfg.n_layers // N) * layer_flops
    # the last stage's output arrives split over "model" on d, so the
    # head's product (run once in the schedule) splits with it
    head = 2 * B * S * cfg.d_model * cfg.vocab_size / TP / N
    trunk = rec["hlo_flops"] - head
    assert trunk == jax_trunk * M / (M + N - 1) / TP
    # every stage but the last hands M microbatches (bf16) on
    handoff = (N - 1) * M * mb * S * cfg.d_model * 2 / N
    assert rec["collective_bytes"]["collective-permute"] == handoff
    assert rec["status"] == "ok" and rec["bottleneck"] in (
        "compute", "memory", "collective")
