"""The port's training against the JAX package on the same weights.

JAX parameters and gradients go through ``repro_torch.bridge`` (numpy in
between); batches come from each package's ``data_iterator``, which must
yield equal arrays.  Reduced configs (``d_model`` 64, two layers, B=2 x
S=32) in fp32 hold the loss to 1e-5 relative and each gradient leaf to
1e-4 relative L2 for the dense, MoE, VLM and encoder-decoder families;
one AdamW update on JAX's gradients holds params, ``mu`` and ``nu`` to
1e-6 relative per leaf (JAX's decay rule over its stacked trunk included);
a 3-step ``Trainer`` trajectory holds the loss to 1e-3.  The recurrent
families (RG-LRU, xLSTM) are held to a central finite difference of the
port's own loss in fp64 (JAX's jit of their training step takes 9-20 s).
Checkpoints: ``blocks.npy`` byte-equal and the manifest equal to JAX's,
a JAX checkpoint loads in the port with bit-equal logits, an arch
mismatch raises.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import init_params as jax_init_params
from repro.training import AdamWConfig as JaxAdamW
from repro.training import adamw_update as jax_adamw_update
from repro.training import data_iterator as jax_data_iterator
from repro.training import init_opt_state as jax_init_opt_state
from repro.training import lm_loss as jax_lm_loss
from repro.training import lr_at as jax_lr_at
from repro.training import make_train_step as jax_make_train_step
from repro.training import save_checkpoint as jax_save_checkpoint
from repro_torch import configs as pconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import forward, init_params, train_forward
from repro_torch.models.model import _forward
from repro_torch.training import (AdamWConfig, Trainer, adamw_update,
                                  data_iterator, init_opt_state,
                                  load_checkpoint, lr_at, save_checkpoint)
from repro_torch.training.optimizer import decay_mask, tree_leaves, tree_map
from repro_torch.training.train_loop import (lm_loss, loss_terms,
                                              value_and_grad)

B, S = 2, 32
LOSS_TOL, GRAD_TOL, ADAM_TOL, TRAJ_TOL, LR_TOL = 1e-5, 1e-4, 1e-6, 1e-3, 1e-7
FAMILIES = ["qwen2.5-3b", "qwen2-moe-a2.7b", "pixtral-12b",
            "whisper-large-v3"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these are eager loops over small tensors, and
    with a thread a core several test workers on one machine
    oversubscribe it (the convergence loop ran ~40x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, n_layers=2):
    cfg = reduced(get_config(arch), d_model=64, n_layers=n_layers)
    pcfg = pconfigs.reduced(pconfigs.get_config(arch), d_model=64,
                            n_layers=n_layers)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(pcfg)
    return cfg, pcfg


def _to_port(pcfg, jax_tree):
    return params_from_jax(pcfg, jax.device_get(jax_tree), device="cpu")


def _batches(cfg, n, seed=0):
    """n batches of both packages' iterators, asserted equal; returns the
    numpy ones."""
    jit, pit = (jax_data_iterator(cfg, B, S, seed=seed),
                data_iterator(cfg, B, S, seed=seed))
    out = []
    for _ in range(n):
        jb, pb = next(jit), next(pit)
        assert sorted(jb) == sorted(pb)
        for k in jb:
            assert jb[k].dtype == pb[k].dtype and np.array_equal(jb[k],
                                                                pb[k]), k
        out.append(jb)
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _rel_l2(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@functools.lru_cache(maxsize=None)
def _jax_step(arch):
    """JAX's params, first batch, loss, aux terms and gradients (one jit
    of value_and_grad per family, shared by the tests)."""
    cfg, pcfg = _cfgs(arch)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    (batch,) = _batches(cfg, 1)
    vg = jax.jit(jax.value_and_grad(lambda p, b: jax_lm_loss(cfg, p, b),
                                    has_aux=True))
    (loss, met), grads = vg(params, batch)
    return cfg, pcfg, params, batch, float(loss), \
        {k: float(v) for k, v in met.items()}, grads


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "pixtral-12b",
                                  "whisper-large-v3"])
def test_data_iterator_equal_jax(arch):
    """Tokens (and the vlm patches, the encdec frames) equal for the same
    seed and config, batch after batch."""
    cfg, _ = _cfgs(arch)
    batches = _batches(cfg, 3, seed=5)
    assert batches[0]["tokens"].shape == (B, S - (cfg.n_patches or 0))
    assert ("patches" in batches[0]) == bool(cfg.n_patches)
    assert ("frames" in batches[0]) == (cfg.family == "encdec")


def test_lr_schedule_equal_jax():
    """Every step 0..total of three schedules within 1e-7 of the peak
    rate.  Both packages compute in fp32; XLA's fp32 cosine differs from
    the correctly rounded one (which the port takes) in the last bits,
    and 1 + cos loses digits late in the decay, so the two can differ by
    a few ulps of the (small) late rate: 2.5e-7 relative to it at most,
    6e-8 of the peak."""
    for kw in (dict(lr=1e-3, warmup_steps=10, total_steps=100),
               dict(lr=3e-4, warmup_steps=2, total_steps=8),
               dict(lr=6e-4, warmup_steps=0, total_steps=7)):
        jcfg, pcfg = JaxAdamW(**kw), AdamWConfig(**kw)
        for step in range(kw["total_steps"] + 1):
            want = float(jax_lr_at(jcfg, step))
            got = lr_at(pcfg, step)
            assert got.dtype == torch.float32
            assert abs(float(got) - want) <= LR_TOL * kw["lr"], (kw, step)


# ------------------------------------------------------------- optimizer
def _random_tree(cfg, seed):
    """Standard-normal fp32 leaves in the shapes of JAX's parameter tree
    (traced, not run: the JAX init of a 9-layer xLSTM takes ~12 s)."""
    shapes = jax.eval_shape(lambda k: jax_init_params(cfg, k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32)), shapes)


@pytest.mark.parametrize("case", ["qwen-fp32", "qwen-bf16", "xlstm-rem"])
def test_adamw_update_equal_jax(case):
    """Three AdamW steps (one in bf16) on the same gradients: params,
    ``mu`` and ``nu`` per leaf, their dtypes, lr and the gradient norm.
    qwen takes JAX's own gradients of its loss (clipped: their norm is
    above 1); xlstm at 9 layers (one 8-layer pattern repetition and an
    mLSTM remainder layer) takes random ones.  The decay rule shows in
    the values: a trunk layer's norm scale decays, the remainder layer's
    1-D biases do not."""
    if case.startswith("qwen"):
        cfg, pcfg, jp, _, _, _, jg = _jax_step("qwen2.5-3b")
        steps = 3
    else:
        cfg, pcfg = _cfgs("xlstm-1.3b", n_layers=9)
        jp, jg = _random_tree(cfg, 1), _random_tree(cfg, 9)
        steps = 3
    if case.endswith("bf16"):
        jp = jax.tree.map(lambda p: p.astype(jnp.bfloat16), jp)
        steps = 1
    tp, tg = _to_port(pcfg, jp), _to_port(pcfg, jg)
    mask = decay_mask(pcfg, tp)
    n_trunk = pcfg.n_pattern_reps * pcfg.pattern_len
    assert mask["layers"][0]["norm1"]["scale"] is True
    if case == "xlstm-rem":
        rem = mask["layers"][n_trunk]
        assert n_trunk == 8 and len(tp["layers"]) == 9
        assert rem["norm1"]["bias"] is False and rem["mlstm"]["b_i"] is False
        assert mask["layers"][0]["norm1"]["bias"] is True
        assert mask["final_norm"]["bias"] is False
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1)
    jcfg, pcfg_opt = JaxAdamW(**kw), AdamWConfig(**kw)
    jstate, tstate = jax_init_opt_state(jp), init_opt_state(tp)
    update = jax.jit(functools.partial(jax_adamw_update, jcfg))
    for _ in range(steps):
        jp, jstate, jmet = update(jp, jg, jstate)
        tp, tstate, tmet = adamw_update(pcfg_opt, tp, tg, tstate,
                                        decay=mask)
    assert tstate["step"] == int(jstate["step"]) == steps
    assert float(jmet["grad_norm"]) > 1.0
    assert _rel_l2(tmet["grad_norm"], jmet["grad_norm"]) <= ADAM_TOL
    assert _rel_l2(tmet["lr"], jmet["lr"]) <= ADAM_TOL
    for name, jt, tt in (("params", jp, tp), ("mu", jstate["mu"],
                                              tstate["mu"]),
                         ("nu", jstate["nu"], tstate["nu"])):
        jl, tl = tree_leaves(_to_port(pcfg, jt)), tree_leaves(tt)
        assert len(jl) == len(tl)
        for i, (a, b) in enumerate(zip(jl, tl)):
            assert a.dtype == b.dtype, (name, i, a.dtype, b.dtype)
            # one bf16 rounding of the same fp32 value (8e-3) in bf16
            tol = 8e-3 if b.dtype == torch.bfloat16 else ADAM_TOL
            assert _rel_l2(b, a.float().numpy()) <= tol, (name, i)


def test_adamw_clip_and_decay():
    """The JAX package's own optimizer test on the port's toy tree."""
    params = {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}
    grads = {"w": torch.full((4, 4), 100.0), "b": torch.full((4,), 100.0)}
    cfg = AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10,
                      grad_clip=1.0)
    state = init_opt_state(params)
    w0 = params["w"].clone()
    new, state, met = adamw_update(cfg, params, grads, state,
                                   decay={"w": True, "b": False})
    assert float(met["grad_norm"]) > 1.0
    assert not torch.isnan(new["w"]).any()
    assert float((new["w"] - w0).abs().max()) < 0.1
    assert state["step"] == 1
    assert state["mu"]["w"].dtype == torch.float32


# ------------------------------------------------------- loss and grads
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_equal_jax(arch):
    """One step's ``lm_loss`` (nll, aux) and every gradient leaf; for MoE
    the static dispatch at capacity factor 1.25 with its aux loss."""
    cfg, pcfg, jp, batch, jloss, jmet, jg = _jax_step(arch)
    tp = _to_port(pcfg, jp)
    (loss, met), grads = value_and_grad(pcfg, tp, _torch_batch(batch))
    assert abs(float(loss) - jloss) <= LOSS_TOL * abs(jloss)
    assert abs(float(met["nll"]) - jmet["nll"]) <= LOSS_TOL * jmet["nll"]
    assert abs(float(met["aux"]) - jmet["aux"]) <= LOSS_TOL * max(
        jmet["aux"], 1e-30)
    if cfg.n_experts:
        assert float(met["aux"]) > 0 and float(loss) > float(met["nll"])
    want = tree_leaves(_to_port(pcfg, jg))
    got = tree_leaves(grads)
    assert len(want) == len(got)
    total = float(np.sqrt(sum(float(w.double().square().sum())
                              for w in want)))
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.shape == g.shape
        wn = float(w.double().norm())
        # a leaf whose gradient is zero but for rounding (a key bias:
        # softmax ignores a shift of every score) is held to the fp32
        # rounding of the whole gradient instead
        assert float((g - w).double().norm()) <= max(GRAD_TOL * wn,
                                                     1e-7 * total), i


def test_train_forward_equals_forward_and_remat_is_exact():
    """``train_forward`` gives the no-grad plain forward's logits bit for
    bit, and rematerialising each layer changes no bit of the loss or of
    any gradient."""
    _, pcfg = _cfgs("qwen2.5-3b")
    tp = init_params(pcfg, seed=3, device="cpu")
    batch = _torch_batch(next(data_iterator(pcfg, B, S)))
    want = forward(pcfg, tp, batch, kernel_impl="plain")["logits"]
    assert torch.equal(train_forward(pcfg, tp, batch)["logits"], want)
    leaves = tree_leaves(tp)
    runs = []
    for remat in (True, False):
        for p in leaves:
            p.requires_grad_(True)
        out = _forward(pcfg, tp, batch, kernel_impl="plain", remat=remat)
        loss, _ = loss_terms(out, batch["tokens"])
        runs.append((loss.detach(), torch.autograd.grad(loss, leaves)))
        for p in leaves:
            p.requires_grad_(False)
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_trainer_trajectory_equal_jax():
    """Three steps of the port's ``Trainer`` from JAX's weights against
    JAX's train step (value_and_grad + adamw_update) on the same
    batches: loss, nll, lr and gradient norm."""
    cfg, pcfg = _cfgs("qwen2.5-3b")
    jp = jax_init_params(cfg, jax.random.PRNGKey(2))
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    step = jax.jit(jax_make_train_step(cfg, JaxAdamW(**kw)))
    tr = Trainer(pcfg, AdamWConfig(**kw), device="cpu",
                 params=_to_port(pcfg, jp))
    jstate = jax_init_opt_state(jp)
    for batch in _batches(cfg, 3, seed=4):
        jp, jstate, jmet = step(jp, jstate, batch)
        met = tr.step(batch)
        for k in ("loss", "nll", "lr", "grad_norm"):
            want = float(jmet[k])
            assert abs(met[k] - want) <= TRAJ_TOL * abs(want), k


@pytest.mark.parametrize("arch,n_layers", [("recurrentgemma-2b", 3),
                                           ("xlstm-1.3b", 8)])
def test_recurrent_grads_match_finite_difference(arch, n_layers):
    """fp64, the plain RG-LRU scan or the chunkwise mLSTM with the sLSTM
    loop: the gradient's projection on a random unit direction v equals
    (L(θ + εv) - L(θ - εv)) / 2ε within 1e-6 relative (ε = 1e-5)."""
    _, pcfg = _cfgs(arch, n_layers=n_layers)
    params = tree_map(lambda p: p.double(),
                      init_params(pcfg, seed=0, device="cpu"))
    batch = _torch_batch(next(data_iterator(pcfg, B, S)))
    (loss, _), grads = value_and_grad(pcfg, params, batch)
    assert loss.dtype == torch.float64
    gen = torch.Generator().manual_seed(0)
    v = tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                       dtype=torch.float64), params)
    norm = torch.sqrt(sum((x * x).sum() for x in tree_leaves(v)))
    v = tree_map(lambda x: x / norm, v)
    dd = float(sum((g * x).sum() for g, x in zip(tree_leaves(grads),
                                                 tree_leaves(v))))
    eps = 1e-5
    ends = [float(lm_loss(pcfg, tree_map(lambda p, x: p + s * eps * x,
                                         params, v), batch)[0])
            for s in (1, -1)]
    fd = (ends[0] - ends[1]) / (2 * eps)
    assert abs(fd - dd) <= 1e-6 * abs(dd), (fd, dd)
    assert all(float(g.abs().max()) > 0 for g in tree_leaves(grads)
               if g.numel() > 1 and g.dim() > 1)


def test_loss_decreases_markov():
    """``tests/test_training.py``'s convergence test on the port."""
    cfg = pconfigs.reduced(pconfigs.get_config("stablelm-1.6b"))
    tr = Trainer(cfg, AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=60),
                 device="cpu")
    hist = tr.fit(data_iterator(cfg, batch=8, seq_len=64), 40, log_fn=None)
    assert hist[-1]["nll"] < hist[0]["nll"] - 0.8


# ----------------------------------------------------------- checkpoints
def test_checkpoint_bytes_and_manifest_equal_jax(tmp_path):
    cfg, pcfg = _cfgs("qwen2.5-3b")
    jp = jax_init_params(cfg, jax.random.PRNGKey(0))
    jax_save_checkpoint(str(tmp_path / "jax"), cfg, jp, n_blocks=4, step=7)
    save_checkpoint(str(tmp_path / "port"), pcfg, _to_port(pcfg, jp),
                    n_blocks=4, step=7)
    assert (tmp_path / "jax" / "blocks.npy").read_bytes() == \
        (tmp_path / "port" / "blocks.npy").read_bytes()
    manifests = [json.loads((tmp_path / d / "manifest.json").read_text())
                 for d in ("jax", "port")]
    assert manifests[0] == manifests[1]


def test_jax_checkpoint_loads_in_port(tmp_path):
    """A checkpoint the JAX package wrote: the port's logits from it equal
    the port's logits from the bridged weights bit for bit; the step
    comes back; the port's own round trip is bit-exact too."""
    cfg, pcfg = _cfgs("qwen2.5-3b")
    jp = jax_init_params(cfg, jax.random.PRNGKey(0))
    jax_save_checkpoint(str(tmp_path), cfg, jp, n_blocks=4, step=3)
    loaded, step = load_checkpoint(str(tmp_path), pcfg, device="cpu")
    assert step == 3
    batch = _torch_batch(next(data_iterator(pcfg, B, S)))
    want = forward(pcfg, _to_port(pcfg, jp), batch)["logits"]
    assert torch.equal(forward(pcfg, loaded, batch)["logits"], want)
    save_checkpoint(str(tmp_path / "again"), pcfg, loaded, n_blocks=4)
    again, step = load_checkpoint(str(tmp_path / "again"), pcfg,
                                  device="cpu")
    assert step is None
    assert torch.equal(forward(pcfg, again, batch)["logits"], want)


def test_checkpoint_arch_mismatch(tmp_path):
    _, pcfg = _cfgs("qwen2.5-3b")
    save_checkpoint(str(tmp_path), pcfg,
                    init_params(pcfg, seed=0, device="cpu"))
    other = pconfigs.reduced(pconfigs.get_config("stablelm-1.6b"))
    with pytest.raises(AssertionError):
        load_checkpoint(str(tmp_path), other, device="cpu")


# --------------------------------------------------------- gradient guard
def test_refuse_grad_guard():
    """The kernel wrappers' guard: raises when grad mode is on and an
    input requires a grad, passes under ``no_grad`` and for plain
    tensors; the CPU branch of a wrapper stays differentiable (it takes
    the plain version before the guard)."""
    from repro_torch.kernels import flash_attention
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        _build.refuse_grad("k", None, torch.ones(3), x)
    with torch.no_grad():
        _build.refuse_grad("k", x)
    _build.refuse_grad("k", torch.ones(3), None)
    q = torch.randn(1, 2, 5, 8, requires_grad=True)
    k = torch.randn(1, 1, 5, 8)
    out = flash_attention(q, k, k)
    assert torch.equal(out, flash_attention_ref(q, k, k))
    (g,) = torch.autograd.grad(out.sum(), q)
    assert g.shape == q.shape
