"""The port's kernels against the JAX package, on the same numpy inputs.

On the CPU each wrapper runs its plain PyTorch version, held here to the
JAX package's oracles (``repro.kernels.ref``) and to its Pallas kernels in
interpret mode, as ``tests/test_kernel_fuzz.py`` and
``tests/test_kernels.py`` run them, over their shape buckets (ragged lens,
shuffled tables, wrapped rings, windows, bf16).  Tolerances are theirs:
2e-5 in fp32 and 2e-2 in bf16 for attention, with the pools byte-equal
outside the trash page; 1e-4 and 5e-2 for the RG-LRU scan (its oracle
sums in another order: a log-depth scan against a sequential loop);
2e-4 and 5e-2 for the chunkwise mLSTM (chunked at 64 tokens in the port,
at the sweep's chunk in JAX: the same arithmetic in another grouping).
``tests/test_torch_gpu.py`` holds the CUDA kernels to these plain
versions on the card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_chunk import mlstm_chunkwise as pallas_mlstm
from repro.kernels.ops import decode_attention as pallas_decode
from repro.kernels.ops import flash_attention as pallas_flash
from repro.kernels.ops import paged_decode_attention as pallas_paged
from repro.kernels.ops import paged_decode_step as pallas_step
from repro.kernels.ops import rglru_scan as pallas_scan
from repro.kernels.ref import decode_attention_ref as _jax_decode_ref
from repro.kernels.ref import flash_attention_ref as _jax_flash_ref
from repro.kernels.ref import paged_decode_attention_ref as _jax_paged_ref
from repro.kernels.ref import paged_decode_step_ref as _jax_step_ref
from repro.kernels.ref import mlstm_chunkwise_ref as jax_mlstm_ref
from repro.kernels.ref import rglru_scan_ref as jax_scan_ref
from repro.models.xlstm import _mlstm_chunk as jax_mlstm_chunk
from repro_torch.kernels import (decode_attention, flash_attention,
                                 mlstm_chunkwise, paged_decode_attention,
                                 paged_decode_step, rglru_scan)
from repro_torch.kernels.ref import (MLSTM_CHUNK, mlstm_chunkwise_ref,
                                     mlstm_parallel_f64)

# jitted as the fuzz harness jits them: one trace per bucket, not per case
jax_step_ref = functools.partial(jax.jit, static_argnames=("window",))(
    _jax_step_ref)
jax_flash_ref = functools.partial(
    jax.jit, static_argnames=("causal", "window"))(_jax_flash_ref)
jax_paged_ref = functools.partial(jax.jit, static_argnames=("window",))(
    _jax_paged_ref)
jax_decode_ref = functools.partial(jax.jit, static_argnames=("window",))(
    _jax_decode_ref)

SEED = 20261016
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}

# the fuzz harness's buckets: (B, H, KVH, dh, ps, MP, window, dtype)
PAGED_BUCKETS = [
    (3, 4, 2, 32, 8, 4, None, "f32"),
    (2, 4, 4, 16, 16, 3, 12, "f32"),
    (1, 2, 1, 32, 8, 5, None, "bf16"),
    (4, 8, 2, 16, 4, 6, 7, "f32"),
    (2, 4, 2, 16, 16, 2, None, "bf16"),
    (3, 2, 2, 8, 8, 3, 5, "bf16"),
    (2, 6, 3, 16, 8, 4, None, "f32"),
]
PAGED_BLOCK_KS = [None, 4, 2, None, 8, None, 4]
# (B, H, KVH, S, dh, causal, window, bq, bk, dtype)
FLASH_BUCKETS = [
    (2, 4, 2, 64, 32, True, None, 32, 32, "f32"),
    (1, 4, 4, 128, 16, True, 48, 64, 64, "f32"),
    (2, 2, 1, 64, 16, False, None, 32, 32, "bf16"),
    (1, 8, 2, 64, 32, True, 16, 16, 16, "bf16"),
    (1, 2, 2, 128, 32, True, None, 64, 32, "f32"),
    (2, 4, 2, 64, 16, True, 64, 32, 64, "f32"),
]
CASES_PER_BUCKET = 3


def _tol(name):
    return 2e-2 if name == "bf16" else 2e-5


def _ragged_len(rng, ps, MP):
    """Edge-heavy length draw: 0/1, page boundaries ±1, full, uniform."""
    hi = MP * ps
    kp = int(rng.integers(1, MP + 1)) * ps
    picks = [0, 1, ps - 1, ps, ps + 1, kp - 1, kp, kp + 1, hi,
             int(rng.integers(0, hi + 1))]
    return int(np.clip(picks[int(rng.integers(len(picks)))], 0, hi))


def _page_table(rng, B, P, MP, ps, lens):
    """Per-slot page lists from a SHUFFLED permutation; -1 unallocated;
    page P-1 is the trash page."""
    table = np.full((B, MP), -1, np.int32)
    free = list(rng.permutation(P - 1))
    for b, n in enumerate(lens):
        for i in range(-(-n // ps)):
            table[b, i] = free.pop()
    return table


def _step_case(bucket, i):
    B, H, KVH, dh, ps, MP, window, dt = bucket
    rng = np.random.default_rng([SEED, 2, i])
    P = B * MP + 2
    lens = np.asarray([_ragged_len(rng, ps, MP) for _ in range(B)], np.int32)
    arrs = dict(q=rng.standard_normal((B, H, dh)),
                kn=rng.standard_normal((B, KVH, dh)),
                vn=rng.standard_normal((B, KVH, dh)),
                k=rng.standard_normal((P, ps, KVH, dh)),
                v=rng.standard_normal((P, ps, KVH, dh)))
    table = _page_table(rng, B, P, MP, ps, lens)
    return arrs, table, lens, window, dt


def _jax(arrs, dt):
    return {n: jnp.asarray(a, DTYPES[dt][0]) for n, a in arrs.items()}


def _torch(arrs, dt):
    return {n: torch.tensor(a, dtype=torch.float32).to(DTYPES[dt][1])
            for n, a in arrs.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _port_step(t, table, lens, window):
    return paged_decode_step(t["q"], t["kn"], t["vn"], t["k"].clone(),
                             t["v"].clone(), torch.from_numpy(table),
                             torch.from_numpy(lens), window=window)


@pytest.mark.parametrize("bidx", range(len(PAGED_BUCKETS)))
def test_paged_decode_step_plain_matches_jax(bidx):
    """Port plain step vs the JAX oracle AND the Pallas kernel (interpret
    mode, with the bucket's block_k): outputs within tolerance, pools
    byte-equal outside the trash page."""
    bucket = PAGED_BUCKETS[bidx]
    for i in range(bidx * CASES_PER_BUCKET, (bidx + 1) * CASES_PER_BUCKET):
        arrs, table, lens, window, dt = _step_case(bucket, i)
        P = arrs["k"].shape[0]
        out, ko, vo = _port_step(_torch(arrs, dt), table, lens, window)
        j = _jax(arrs, dt)
        jt, jl = jnp.asarray(table), jnp.asarray(lens)
        ref = jax_step_ref(j["q"], j["kn"], j["vn"], j["k"], j["v"], jt, jl,
                           window=window)
        pal = pallas_step(j["q"], j["kn"], j["vn"], j["k"], j["v"], jt, jl,
                          window=window, block_k=PAGED_BLOCK_KS[bidx])
        msg = f"bucket={bucket} case={i} lens={lens.tolist()}"
        for name, (ro, rk, rv) in (("ref", ref), ("pallas", pal)):
            np.testing.assert_allclose(_np(out), _np(ro), atol=_tol(dt),
                                       rtol=_tol(dt), err_msg=f"{name} {msg}")
            np.testing.assert_array_equal(_np(ko)[:P - 1], _np(rk)[:P - 1],
                                          err_msg=f"{name} {msg}")
            np.testing.assert_array_equal(_np(vo)[:P - 1], _np(rv)[:P - 1],
                                          err_msg=f"{name} {msg}")


def test_paged_decode_step_free_slot_writes_only_trash():
    """A FREE slot (row all -1) writes only the trash page and its output
    is softmax over the new token alone: v_new itself."""
    arrs, _, _, _, _ = _step_case(PAGED_BUCKETS[0], 999)
    t = _torch(arrs, "f32")
    B, MP = 3, 4
    table = np.full((B, MP), -1, np.int32)
    lens = np.asarray([0, 5, 17], np.int32)
    k0 = t["k"].clone()
    out, ko, _ = paged_decode_step(t["q"], t["kn"], t["vn"], t["k"],
                                   t["v"], torch.from_numpy(table),
                                   torch.from_numpy(lens))
    assert torch.equal(ko[:-1], k0[:-1])
    g = out.shape[1] // t["vn"].shape[1]
    want = t["vn"].repeat_interleave(g, dim=1)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)


def _flash_inputs(B, H, KVH, S, dh, seed):
    rng = np.random.default_rng([SEED, 4, seed])
    return dict(q=rng.standard_normal((B, H, S, dh)),
                k=rng.standard_normal((B, KVH, S, dh)),
                v=rng.standard_normal((B, KVH, S, dh)))


@pytest.mark.parametrize("bidx", range(len(FLASH_BUCKETS)))
def test_flash_attention_plain_matches_jax(bidx):
    B, H, KVH, S, dh, causal, window, bq, bk, dt = FLASH_BUCKETS[bidx]
    for i in range(2):
        arrs = _flash_inputs(B, H, KVH, S, dh, bidx * 10 + i)
        t, j = _torch(arrs, dt), _jax(arrs, dt)
        out = flash_attention(t["q"], t["k"], t["v"], causal=causal,
                              window=window)
        ref = jax_flash_ref(j["q"], j["k"], j["v"], causal=causal,
                            window=window)
        pal = pallas_flash(j["q"], j["k"], j["v"], causal=causal,
                           window=window, bq=bq, bk=bk)
        for name, r in (("ref", ref), ("pallas", pal)):
            np.testing.assert_allclose(
                _np(out), _np(r), atol=_tol(dt), rtol=_tol(dt),
                err_msg=f"{name} bucket={FLASH_BUCKETS[bidx]} case={i}")


@pytest.mark.parametrize("S,window", [(1, None), (17, None), (33, 8),
                                      (100, None), (100, 24)])
def test_flash_attention_plain_ragged_lengths(S, window):
    """Prefill runs any prompt length: the port takes S that no tile
    divides (the Pallas kernel asserts S % bq == 0), held to the oracle."""
    arrs = _flash_inputs(1, 4, 2, S, 16, S)
    t, j = _torch(arrs, "f32"), _jax(arrs, "f32")
    out = flash_attention(t["q"], t["k"], t["v"], causal=True, window=window)
    ref = jax_flash_ref(j["q"], j["k"], j["v"], causal=True, window=window)
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5, rtol=2e-5)


def test_wrappers_reject_other_devices():
    t = torch.zeros((1, 2, 4, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_attention(t, t, t)
    with pytest.raises(ValueError, match="cpu or cuda"):
        rglru_scan(t[0], t[0], t[0, :, 0])
    q = torch.zeros((1, 2, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        decode_attention(q, t, t, t[0, 0], t[0, 0, 0])
    with pytest.raises(ValueError, match="cpu or cuda"):
        paged_decode_attention(q, t, t, t[0, 0], t[0, 0, 0])


@pytest.mark.parametrize("bidx", range(len(PAGED_BUCKETS)))
def test_paged_decode_attention_plain_matches_jax(bidx):
    """Read-only paged attention over the fuzz buckets, with one row per
    case forced to lens == 0 (the uniform-average edge): port plain vs the
    JAX oracle AND the Pallas kernel (interpret mode)."""
    bucket = PAGED_BUCKETS[bidx]
    window = bucket[6]
    for i in range(bidx * 2, bidx * 2 + 2):
        arrs, table, lens, _, dt = _step_case(bucket, 100 + i)
        lens[i % len(lens)] = 0
        t, j = _torch(arrs, dt), _jax(arrs, dt)
        out = paged_decode_attention(t["q"], t["k"], t["v"],
                                     torch.from_numpy(table),
                                     torch.from_numpy(lens), window=window)
        jt, jl = jnp.asarray(table), jnp.asarray(lens)
        ref = jax_paged_ref(j["q"], j["k"], j["v"], jt, jl, window=window)
        pal = pallas_paged(j["q"], j["k"], j["v"], jt, jl, window=window,
                           block_k=PAGED_BLOCK_KS[bidx])
        for name, r in (("ref", ref), ("pallas", pal)):
            np.testing.assert_allclose(
                _np(out), _np(r), atol=_tol(dt), rtol=_tol(dt),
                err_msg=f"{name} bucket={bucket} case={i} lens={lens}")


# the fuzz harness's ring buckets: (B, H, KVH, W, dh, window, dtype)
DECODE_BUCKETS = [
    (2, 4, 2, 32, 32, None, "f32"),
    (2, 4, 1, 64, 16, 24, "f32"),
    (1, 8, 8, 32, 16, None, "bf16"),
    (3, 2, 2, 64, 32, 16, "bf16"),
    (2, 4, 2, 64, 16, None, "f32"),
    (1, 2, 1, 32, 64, 8, "f32"),
]


def _ring_case(bucket, i):
    """Per-row fills 1..2W (wrapped rings), as the fuzz harness draws."""
    B, H, KVH, W, dh, window, dt = bucket
    rng = np.random.default_rng([SEED, 3, i])
    arrs = dict(q=rng.standard_normal((B, H, dh)),
                k=rng.standard_normal((B, W, KVH, dh)),
                v=rng.standard_normal((B, W, KVH, dh)))
    spos = np.full((B, W), -1, np.int32)
    pos = np.zeros((B,), np.int32)
    for b in range(B):
        fill = int(np.clip(_ragged_len(rng, W, 2), 1, 2 * W))
        for t in range(fill):
            spos[b, t % W] = t
        pos[b] = fill - 1
    return arrs, spos, pos


@pytest.mark.parametrize("bidx", range(len(DECODE_BUCKETS)))
def test_decode_attention_plain_matches_jax(bidx):
    bucket = DECODE_BUCKETS[bidx]
    window, dt = bucket[5], bucket[6]
    for i in range(bidx * 3, bidx * 3 + 3):
        arrs, spos, pos = _ring_case(bucket, i)
        t, j = _torch(arrs, dt), _jax(arrs, dt)
        out = decode_attention(t["q"], t["k"], t["v"],
                               torch.from_numpy(spos), torch.from_numpy(pos),
                               window=window)
        js, jpos = jnp.asarray(spos), jnp.asarray(pos)
        ref = jax_decode_ref(j["q"], j["k"], j["v"], js, jpos, window=window)
        pal = pallas_decode(j["q"], j["k"], j["v"], js, jpos, window=window)
        for name, r in (("ref", ref), ("pallas", pal)):
            np.testing.assert_allclose(
                _np(out), _np(r), atol=_tol(dt), rtol=_tol(dt),
                err_msg=f"{name} bucket={bucket} case={i} pos={pos}")


def test_decode_attention_row_without_valid_slot_is_uniform_mean():
    """A row whose every slot is masked (empty ring, or every stored
    position past pos) gives the uniform mean of V over the W slots, in
    the port's plain version and the JAX oracle alike; the CUDA kernel is
    held to it in tests/test_torch_gpu.py."""
    arrs, spos, pos = _ring_case(DECODE_BUCKETS[0], 7)
    spos[0] = -1
    spos[1] = pos[1] + 1 + np.arange(spos.shape[1])
    t, j = _torch(arrs, "f32"), _jax(arrs, "f32")
    out = decode_attention(t["q"], t["k"], t["v"], torch.from_numpy(spos),
                           torch.from_numpy(pos))
    ref = jax_decode_ref(j["q"], j["k"], j["v"], jnp.asarray(spos),
                         jnp.asarray(pos))
    g = t["q"].shape[1] // t["k"].shape[2]
    want = t["k"].new_zeros(t["q"].shape)
    want[:] = t["v"].mean(dim=1).repeat_interleave(g, dim=1)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5, rtol=2e-5)


# tests/test_kernels.py's sweep: (B, S, d, bt)
SCAN_SWEEP = [(2, 512, 256, 256), (1, 1024, 128, 128), (3, 256, 384, 64),
              (1, 64, 128, 64)]


def _scan_inputs(B, S, d, seed):
    rng = np.random.default_rng([SEED, 5, seed])
    return (rng.uniform(0.7, 0.999, (B, S, d)),
            rng.standard_normal((B, S, d)) * 0.1,
            rng.standard_normal((B, d)))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("sidx", range(len(SCAN_SWEEP)))
def test_rglru_scan_plain_matches_jax(sidx, dt):
    """Plain scan vs the JAX oracle and the Pallas kernel (interpret mode,
    the sweep's time block): h in a's dtype, carry fp32."""
    B, S, d, bt = SCAN_SWEEP[sidx]
    a, b, h0 = _scan_inputs(B, S, d, sidx)
    jdt, tdt = DTYPES[dt]
    ta = torch.tensor(a, dtype=torch.float32).to(tdt)
    tb = torch.tensor(b, dtype=torch.float32).to(tdt)
    out = rglru_scan(ta, tb, torch.tensor(h0, dtype=torch.float32))
    assert out.dtype == tdt and out.shape == (B, S, d)
    ja, jb = jnp.asarray(a, jdt), jnp.asarray(b, jdt)
    jh0 = jnp.asarray(h0, jnp.float32)
    ref = jax_scan_ref(ja.astype(jnp.float32), jb.astype(jnp.float32), jh0)
    pal = pallas_scan(ja, jb, jh0, bt=bt)
    tol = 5e-2 if dt == "bf16" else 1e-4
    for name, r in (("ref", ref), ("pallas", pal)):
        np.testing.assert_allclose(_np(out), _np(r), atol=tol, rtol=tol,
                                   err_msg=f"{name} {SCAN_SWEEP[sidx]} {dt}")


@pytest.mark.parametrize("S", [1, 17, 100, 257])
def test_rglru_scan_plain_ragged_lengths(S):
    """Prefill runs any prompt length: the port takes S that no time block
    divides (the Pallas kernel asserts S % bt == 0)."""
    a, b, h0 = _scan_inputs(2, S, 96, S)
    out = rglru_scan(torch.tensor(a, dtype=torch.float32),
                     torch.tensor(b, dtype=torch.float32),
                     torch.tensor(h0, dtype=torch.float32))
    ref = jax_scan_ref(jnp.asarray(a, jnp.float32),
                       jnp.asarray(b, jnp.float32),
                       jnp.asarray(h0, jnp.float32))
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("S", [1, 2, 17, 202, 256, 2048, 2600])
def test_rglru_scan_effective_chunks_cover_every_step(S):
    """Any requested chunk count becomes one the kernel runs: chunks of
    L = ceil(S / n) steps, the last one 1 to L steps, covering S exactly
    (the kernel refuses a count that leaves a chunk empty)."""
    from repro_torch.kernels.rglru_scan import effective_chunks
    for want in (1, 2, 3, 7, 16, 19, 32, S - 1, S, S + 5, 10**6):
        n = effective_chunks(S, want)
        L = -(-S // min(max(want, 1), S))
        assert 1 <= n <= S and n <= max(want, 1)
        assert (n - 1) * L < S <= n * L, (S, want, n, L)
        assert effective_chunks(S, n) == n


# the CUDA scan's look-back: predecessors one round reads (kWindow in
# csrc/rglru_scan.cu)
SCAN_WINDOW = 32


def _scan_chunk_emulation(a, b, h0, L, published_every):
    """The chunked CUDA scan's arithmetic in torch, fp32 carries, h rounded
    to a's dtype: each chunk of L steps as its map (A, Bc) from a zero
    carry; chunk k's carry-in by the look-back, composing predecessors'
    maps back (32 a round) to the nearest chunk whose carry-out is
    published (chunk 0 always, every ``published_every``-th too, or none
    else when None); the published carry-out A·carry_in + Bc; and the
    rescan from the carry-in.  Returns (h, every chunk's A)."""
    B, S, d = a.shape
    af, bf = a.float(), b.float()
    spans = [(lo, min(S, lo + L)) for lo in range(0, S, L)]
    maps = []
    for lo, hi in spans:
        A, Bc = torch.ones(B, d), torch.zeros(B, d)
        for t in range(lo, hi):
            A = A * af[:, t]
            Bc = af[:, t] * Bc + bf[:, t]
        maps.append((A, Bc))

    def published(j):
        return j == 0 or bool(published_every) and j % published_every == 0
    h = torch.empty((B, S, d), dtype=a.dtype)
    carry_out = {}
    for k, (lo, hi) in enumerate(spans):
        carry = h0.float()
        P, Q = torch.ones(B, d), torch.zeros(B, d)
        top = k
        while top > 0:
            window = [j for j in range(top - 1, top - 1 - SCAN_WINDOW, -1)
                      if j >= 0]
            hit = next((i for i, j in enumerate(window) if published(j)),
                       len(window))
            for j in window[:hit]:
                A, Bc = maps[j]
                P, Q = P * A, P * Bc + Q
            if hit < len(window):
                carry = P * carry_out[window[hit]] + Q
                break
            top -= SCAN_WINDOW
        carry_in = carry
        for t in range(lo, hi):
            carry = af[:, t] * carry + bf[:, t]
            h[:, t] = carry.to(a.dtype)
        A, Bc = maps[k]
        carry_out[k] = carry if k == 0 else A * carry_in + Bc
    return h, [A for A, _ in maps]


@pytest.mark.parametrize("published", [3, None], ids=["every3", "first"])
@pytest.mark.parametrize("gates", ["normal", "small"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("L", [1, 7, 64, "S"])
def test_rglru_scan_chunk_algebra_matches_plain_and_jax(L, dt, gates,
                                                        published):
    """The chunked kernel's design, checked on the CPU: chunk maps, the
    look-back's composition across several predecessors (across windows
    when only chunk 0 is published) and the rescan give the plain
    sequential scan and the JAX oracle, at chunk lengths 1, 7, 64 and S
    over a ragged S.  "small" gates (a in 0.05-0.12, the model's
    smallest) make a 64-step chunk's A underflow to exactly 0: the carry
    is forgotten, and nothing divides by A."""
    B, S, d = 2, 202, 40
    rng = np.random.default_rng([SEED, 23, S])
    lo, hi = (0.05, 0.12) if gates == "small" else (0.7, 0.999)
    a = rng.uniform(lo, hi, (B, S, d))
    b = rng.standard_normal((B, S, d)) * 0.1
    h0 = rng.standard_normal((B, d))
    tdt = DTYPES[dt][1]
    ta = torch.tensor(a, dtype=torch.float32).to(tdt)
    tb = torch.tensor(b, dtype=torch.float32).to(tdt)
    th0 = torch.tensor(h0, dtype=torch.float32)
    h, As = _scan_chunk_emulation(ta, tb, th0, S if L == "S" else L,
                                  published)
    assert h.dtype == tdt and torch.isfinite(h.float()).all()
    if gates == "small" and L in (64, "S"):
        assert any(bool((A == 0).all()) for A in As)
    tol = 5e-2 if dt == "bf16" else 1e-4
    plain = rglru_scan(ta, tb, th0)
    oracle = jax_scan_ref(jnp.asarray(ta.float().numpy()),
                          jnp.asarray(tb.float().numpy()),
                          jnp.asarray(h0, jnp.float32))
    for name, r in (("plain", plain), ("jax", oracle)):
        np.testing.assert_allclose(_np(h), _np(r), atol=tol, rtol=tol,
                                   err_msg=f"{name} L={L} {dt} {gates}")


@pytest.mark.parametrize("window", [None, 24])
def test_flash_attention_plain_head_dim_256(window):
    """RecurrentGemma's prefill shape family: MQA at dh 256, ragged S."""
    arrs = _flash_inputs(1, 4, 1, 70, 256, 256)
    t, j = _torch(arrs, "f32"), _jax(arrs, "f32")
    out = flash_attention(t["q"], t["k"], t["v"], causal=True, window=window)
    ref = jax_flash_ref(j["q"], j["k"], j["v"], causal=True, window=window)
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5, rtol=2e-5)



# head dims the bf16 tensor-core kernel zero-pads to its 64 and 256
# buckets, and S below one 16-row mma tile: (S, dh, window)
FLASH_PADDED = [(1, 8, None), (5, 8, 3), (15, 8, None), (1, 24, None),
                (7, 24, 4), (15, 24, None), (1, 192, None), (9, 192, None),
                (15, 192, 6), (40, 24, 16), (40, 192, None)]


@pytest.mark.parametrize("S,dh,window", FLASH_PADDED)
def test_flash_attention_plain_bf16_padded_head_dims(S, dh, window):
    """The plain version, which the card holds the bf16 kernel to, against
    the JAX oracle and the Pallas kernel in interpret mode, in bf16, at
    the head dims and lengths where the kernel pads."""
    arrs = _flash_inputs(1, 4, 2, S, dh, 1000 + S * 7 + dh)
    t, j = _torch(arrs, "bf16"), _jax(arrs, "bf16")
    out = flash_attention(t["q"], t["k"], t["v"], causal=True, window=window)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 4, S, dh)
    ref = jax_flash_ref(j["q"], j["k"], j["v"], causal=True, window=window)
    bq = 8 if S % 8 == 0 else S
    pal = pallas_flash(j["q"], j["k"], j["v"], causal=True, window=window,
                       bq=bq, bk=bq)
    for name, r in (("ref", ref), ("pallas", pal)):
        np.testing.assert_allclose(_np(out), _np(r), atol=2e-2, rtol=2e-2,
                                   err_msg=f"{name} S={S} dh={dh}")

# tests/test_kernels.py's mLSTM sweep with S cut for the interpret run:
# (B, H, S, dh, JAX chunk)
MLSTM_SWEEP = [(2, 3, 256, 64, 128), (1, 2, 128, 128, 64), (1, 4, 128, 256, 128)]


def _mlstm_inputs(B, H, S, dh, seed):
    rng = np.random.default_rng([SEED, 6, seed])
    return dict(q=rng.standard_normal((B, H, S, dh)),
                k=rng.standard_normal((B, H, S, dh)) / np.sqrt(dh),
                v=rng.standard_normal((B, H, S, dh)),
                i=rng.standard_normal((B, H, S)),
                f=rng.standard_normal((B, H, S)) + 3.0)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("sidx", range(len(MLSTM_SWEEP)))
def test_mlstm_chunkwise_plain_matches_jax(sidx, dt):
    """The port's plain chunk loop (64-token chunks) against the JAX
    oracle and the Pallas kernel in interpret mode (the sweep's chunk):
    q, k, v in the sweep's dtype, gates fp32, h in q's dtype."""
    B, H, S, dh, chunk = MLSTM_SWEEP[sidx]
    x = _mlstm_inputs(B, H, S, dh, sidx)
    jdt, tdt = DTYPES[dt]
    tq, tk, tv = (torch.tensor(x[n], dtype=torch.float32).to(tdt)
                  for n in "qkv")
    ti, tf = (torch.tensor(x[n], dtype=torch.float32) for n in "if")
    out, (C, n, m) = mlstm_chunkwise(tq, tk, tv, ti, tf)
    assert out.dtype == tdt and out.shape == (B, H, S, dh)
    assert C.shape == (B, H, dh, dh) and C.dtype == torch.float32
    jq, jk, jv = (jnp.asarray(x[n], jdt) for n in "qkv")
    ji, jf = (jnp.asarray(x[n], jnp.float32) for n in "if")
    ref = jax_mlstm_ref(jq.astype(jnp.float32), jk.astype(jnp.float32),
                        jv.astype(jnp.float32), ji, jf, chunk=chunk)
    pal = pallas_mlstm(jq, jk, jv, ji, jf, chunk=chunk)
    tol = 5e-2 if dt == "bf16" else 2e-4
    for name, r in (("ref", ref), ("pallas", pal)):
        np.testing.assert_allclose(_np(out), _np(r), atol=tol, rtol=tol,
                                   err_msg=f"{name} {MLSTM_SWEEP[sidx]} {dt}")


@pytest.mark.parametrize("S", [1, 37, MLSTM_CHUNK, 150])
def test_mlstm_chunkwise_plain_ragged_s_and_state_match_jax(S):
    """Any S: below, at and past the port's chunk with a short last chunk
    (the JAX oracle drops such a tail), held to JAX ``_mlstm_chunk`` run as
    ONE chunk over all S, h and the final (C, n, m) alike; then a second
    call resumes from that state (as a second JAX chunk does)."""
    x = _mlstm_inputs(2, 3, 2 * S, 32, S)
    t = {n: torch.tensor(a, dtype=torch.float32) for n, a in x.items()}
    j = {n: jnp.asarray(a, jnp.float32) for n, a in x.items()}
    st = (jnp.zeros((2, 3, 32, 32)), jnp.zeros((2, 3, 32)),
          jnp.full((2, 3), -1e30))
    got_state = None
    for half in (slice(0, S), slice(S, 2 * S)):
        jh, st = jax_mlstm_chunk(*(j[n][:, :, half] for n in "qkvif"), st)
        th, got_state = mlstm_chunkwise(*(t[n][:, :, half] for n in "qkvif"),
                                        got_state)
        np.testing.assert_allclose(_np(th), _np(jh), atol=2e-4, rtol=2e-4)
        for name, a, b in zip("Cnm", got_state, st):
            np.testing.assert_allclose(_np(a), _np(b), atol=2e-4, rtol=2e-4,
                                       err_msg=f"S={S} {name}")
    # the plain version at another chunk length gives the same result
    h1, s1 = mlstm_chunkwise_ref(*(t[n] for n in "qkvif"), chunk=7)
    h2, s2 = mlstm_chunkwise_ref(*(t[n] for n in "qkvif"))
    np.testing.assert_allclose(_np(h1), _np(h2), atol=2e-4, rtol=2e-4)
    for a, b in zip(s1, s2):
        np.testing.assert_allclose(_np(a), _np(b), atol=2e-4, rtol=2e-4)


def test_mlstm_chunkwise_plain_extreme_gates_match_jax():
    """A large input gate (the stabiliser m at work) and a forget gate
    near -30 (the state forgets every token): finite, equal to JAX."""
    x = _mlstm_inputs(1, 2, 90, 32, 99)
    x["i"] = x["i"] * 10.0 + 20.0
    x["f"][:, :, 40:] -= 33.0
    t = {n: torch.tensor(a, dtype=torch.float32) for n, a in x.items()}
    j = {n: jnp.asarray(a, jnp.float32) for n, a in x.items()}
    st = (jnp.zeros((1, 2, 32, 32)), jnp.zeros((1, 2, 32)),
          jnp.full((1, 2), -1e30))
    jh, st = jax_mlstm_chunk(*(j[n] for n in "qkvif"), st)
    th, got = mlstm_chunkwise(*(t[n] for n in "qkvif"))
    assert torch.isfinite(th).all()
    np.testing.assert_allclose(_np(th), _np(jh), atol=2e-4, rtol=2e-4)
    for a, b in zip(got, st):
        np.testing.assert_allclose(_np(a), _np(b), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("gates", ["normal", "big_i"])
def test_mlstm_parallel_f64_bounds_plain_and_jax(gates):
    """The fp64 parallel form that ``chip_smoke.py`` holds the kernel's h
    to where the normaliser is ill-conditioned: its final (C, n, m) equal
    JAX ``_mlstm_chunk``'s within 2e-4, and both fp32 chunk loops (the
    port's at 64 tokens, JAX's as one chunk) lie within 2e-4 (1 + scale)
    of its h, scale being each output's conditioning."""
    x = _mlstm_inputs(1, 2, 200, 32, 7)
    if gates == "big_i":
        x["i"] = x["i"] * 10.0 + 20.0
    t = {n: torch.tensor(a, dtype=torch.float32) for n, a in x.items()}
    j = {n: jnp.asarray(a, jnp.float32) for n, a in x.items()}
    st = (jnp.zeros((1, 2, 32, 32)), jnp.zeros((1, 2, 32)),
          jnp.full((1, 2), -1e30))
    jh, st = jax_mlstm_chunk(*(j[n] for n in "qkvif"), st)
    th, _ = mlstm_chunkwise_ref(*(t[n] for n in "qkvif"))
    h64, scale, state = mlstm_parallel_f64(*(t[n] for n in "qkvif"))
    assert h64.dtype == scale.dtype == torch.float64
    assert (scale >= h64.abs()).all()
    for a, b in zip(state, st):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=2e-4, rtol=2e-4)
    bound = 2e-4 * (1.0 + scale.numpy())
    for name, h in (("port", _np(th)), ("jax", _np(jh))):
        over = np.abs(h.astype(np.float64) - h64.numpy()) > bound
        assert not over.any(), f"{name}: {over.sum()} beyond the bound"


def _split_bf16(x):
    """x (fp32) as bf16 hi + lo, each returned as fp32: hi = bf16(x),
    lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _mlstm_split_emulation(q, k, v, i_pre, f_pre):
    """The bf16 CUDA kernel's products in plain torch, chunk by chunk: q,
    k, v hold bf16 values (exact operands); the fp32 operand of each state
    product, C for q C and a_s v_s for the update, is split into bf16 hi +
    lo and both halves are multiplied into one fp32 sum.  The gates, the m
    trajectory and q k^T, w v and n stay fp32, as in the kernel."""
    B, H, S, dh = q.shape
    C = torch.zeros((B, H, dh, dh))
    n = torch.zeros((B, H, dh))
    m = torch.full((B, H), -1e30)
    hs = []
    for t0 in range(0, S, MLSTM_CHUNK):
        sl = slice(t0, t0 + MLSTM_CHUNK)
        qc, kc, vc = q[:, :, sl], k[:, :, sl], v[:, :, sl]
        ic = i_pre[:, :, sl]
        L = qc.shape[2]
        b = torch.cumsum(torch.nn.functional.logsigmoid(f_pre[:, :, sl]), -1)
        g = b[..., -1]
        D = b[..., :, None] - b[..., None, :] + ic[..., None, :]
        D = torch.where(torch.ones((L, L), dtype=torch.bool).tril(), D,
                        torch.full_like(D, -1e30))
        m_inter = b + m[..., None]
        m_j = torch.maximum(D.amax(-1), m_inter)
        w = (qc @ kc.transpose(-1, -2)) * torch.exp(D - m_j[..., None])
        inter = torch.exp(m_inter - m_j)
        C_hi, C_lo = _split_bf16(C)
        hq = qc @ C_hi + qc @ C_lo
        den = inter * (qc @ n[..., None])[..., 0] + w.sum(-1)
        hs.append((inter[..., None] * hq + w @ vc)
                  / torch.maximum(den.abs(), torch.exp(-m_j))[..., None])
        s_gate = g[..., None] - b + ic
        m_new = torch.maximum(g + m, s_gate.amax(-1))
        carry = torch.exp(g + m - m_new)
        a = torch.exp(s_gate - m_new[..., None])[..., None]
        av_hi, av_lo = _split_bf16(a * vc)
        C = (carry[..., None, None] * C + kc.transpose(-1, -2) @ av_hi
             + kc.transpose(-1, -2) @ av_lo)
        n = carry[..., None] * n + (a * kc).sum(-2)
        m = m_new
    return torch.cat(hs, 2), (C, n, m)


@pytest.mark.parametrize("gates", ["normal", "big_i"])
def test_mlstm_bf16_split_precision_meets_state_tolerance(gates):
    """The design of the bf16 kernel's numerics, checked on the CPU: with
    the fp32 operand split into bf16 hi + lo, the final (C, n, m) after 8
    chunks at dh 256 stay within 2e-4 of the plain fp32 chunk loop on the
    same bf16-valued inputs, and h within 5e-2."""
    x = _mlstm_inputs(1, 2, 512, 256, 41)
    if gates == "big_i":
        x["i"] = x["i"] * 10.0 + 20.0
    t = {nm: torch.tensor(a, dtype=torch.float32) for nm, a in x.items()}
    for nm in "qkv":
        t[nm] = t[nm].to(torch.bfloat16).float()
    h, state = _mlstm_split_emulation(*(t[nm] for nm in "qkvif"))
    hr, state_r = mlstm_chunkwise_ref(*(t[nm] for nm in "qkvif"))
    assert torch.isfinite(h).all()
    torch.testing.assert_close(h, hr, atol=5e-2, rtol=5e-2)
    for nm, a, b in zip("Cnm", state, state_r):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4,
                                   msg=lambda e: f"{gates} {nm}: {e}")
