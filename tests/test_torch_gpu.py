"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports no JAX (the GPU machine has none), so on the card it runs
without the suite's JAX fixture:

  PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Shapes are the fuzz harness's buckets (``tests/test_kernel_fuzz.py``) and
the RG-LRU sweep of ``tests/test_kernels.py``, which reach widths the
serving path never uses (dh=8, 4-token pages), plus the paths of the bf16
(wgmma) and fp32 (3xTF32) tensor-core flash kernels (padded head dims, S
around their tiles; bf16 also on the transposed views the model passes,
its SASS held to wgmma on tensor-map loads; the fp32 one also held to an
fp64 run, at most 4x the fp32 plain version's error) and of
the fused step's split walk (few slots with long lens, empty shares, FREE
rows, 100 steps on one pool) and the heads of every family's config
(qwen2-moe 16/16, pixtral 32/8, llama4 40/8, whisper 20/20 at dh 64,
its encoder non-causal over 1500 frames); ``chip_smoke.py`` covers the
serving path's shapes.  Tolerances are theirs: 2e-5 in fp32 (TF32
off) and 2e-2 in bf16 for attention, with the pools byte-equal outside
the trash page; 1e-4 and 5e-2 for the scan; 2e-4 and 5e-2 for the mLSTM
(``tests/test_kernels.py``) on h, and 2e-4 on the final (C, n, m) in
either dtype.  The compiled decode tick (the end of the file) is held
on reduced models of each family (MoE and VLM too), paged and striped,
the MoE step also under the sync debug mode: the engine's
graph replay against the eager ``decode_step`` on a cloned cache (fp32
within 1e-6 of the largest logit, bitwise expected; bf16 argmax equal),
launch counts equal to the eager path's, two engines of different sizes
on one card, the autotuned page size and the ``--coldstart`` demo.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (KERNELS, decode_attention, flash_attention,
                                 mlstm_chunkwise, paged_decode_attention,
                                 paged_decode_step, rglru_scan)
from repro_torch.kernels.ref import (decode_attention_ref,
                                     flash_attention_ref,
                                     mlstm_chunkwise_ref,
                                     mlstm_parallel_f64,
                                     paged_decode_attention_ref,
                                     paged_decode_step_ref, rglru_scan_ref)

SEED = 20261016
TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# (B, H, KVH, dh, ps, MP, window, dtype)
PAGED_BUCKETS = [
    (3, 4, 2, 32, 8, 4, None, "f32"),
    (2, 4, 4, 16, 16, 3, 12, "f32"),
    (1, 2, 1, 32, 8, 5, None, "bf16"),
    (4, 8, 2, 16, 4, 6, 7, "f32"),
    (2, 4, 2, 16, 16, 2, None, "bf16"),
    (3, 2, 2, 8, 8, 3, 5, "bf16"),
    (2, 6, 3, 16, 8, 4, None, "f32"),
    # recurrentgemma-2b's heads: g = 10 query heads per KV head (more than
    # the kernels' 8 warps), dh 256 (the fp32 tile at the register budget)
    (2, 10, 1, 256, 16, 6, 40, "f32"),
    (3, 10, 1, 256, 16, 5, None, "bf16"),
    # qwen2-moe (16/16), pixtral (32/8) and llama4 (40/8, windowed) heads
    (8, 16, 16, 128, 16, 8, None, "bf16"),
    (4, 32, 8, 128, 16, 6, None, "f32"),
    (3, 40, 8, 128, 16, 10, 100, "bf16"),
]
# (B, H, KVH, S, dh, causal, window, dtype); S not a tile multiple too
FLASH_BUCKETS = [
    (2, 4, 2, 64, 32, True, None, "f32"),
    (1, 4, 4, 128, 16, True, 48, "f32"),
    (2, 2, 1, 64, 16, False, None, "bf16"),
    (1, 8, 2, 64, 32, True, 16, "bf16"),
    (1, 2, 2, 128, 32, True, None, "f32"),
    (2, 4, 2, 64, 16, True, 64, "f32"),
    (1, 4, 2, 77, 64, True, None, "f32"),
    (1, 4, 2, 200, 128, True, 33, "bf16"),
    (1, 10, 1, 130, 256, True, 64, "f32"),
    (2, 4, 1, 71, 256, True, None, "bf16"),
    (1, 2, 1, 40, 192, True, None, "f32"),
    # qwen2-moe, pixtral and llama4 heads; whisper's encoder over 1500
    # frames (non-causal) and its decoder
    (1, 16, 16, 100, 128, True, None, "bf16"),
    (1, 32, 8, 90, 128, True, None, "f32"),
    (1, 40, 8, 150, 128, True, 64, "bf16"),
    (2, 20, 20, 1500, 64, False, None, "bf16"),
    (1, 20, 20, 300, 64, False, None, "f32"),
    (1, 20, 20, 448, 64, True, None, "f32"),
]
# (B, H, KVH, W, dh, window, dtype)
DECODE_BUCKETS = [
    (2, 4, 2, 32, 32, None, "f32"),
    (2, 4, 1, 64, 16, 24, "f32"),
    (1, 8, 8, 32, 16, None, "bf16"),
    (3, 2, 2, 64, 32, 16, "bf16"),
    (2, 4, 2, 64, 16, None, "f32"),
    (1, 2, 1, 32, 64, 8, "f32"),
    (2, 10, 1, 100, 256, 64, "bf16"),
    (2, 10, 1, 100, 256, None, "f32"),
    # whisper's decoder self-attention (20/20 heads, dh 64)
    (4, 20, 20, 128, 64, None, "bf16"),
    (2, 20, 20, 448, 64, None, "f32"),
]
# (B, S, d); d 130 is no multiple of a 16-byte vector (the kernel's
# element-wise loads); the last three have many chunks a chain at
# recurrentgemma-2b's width (a long prompt, the longest, a few rows)
SCAN_SHAPES = [(2, 512, 256), (1, 1024, 128), (3, 256, 384), (1, 64, 128),
               (2, 1, 96), (1, 17, 2560), (2, 100, 200), (2, 300, 130),
               (1, 2600, 2560), (1, 4096, 2560), (3, 1000, 2560)]
# (B, H, S, dh, gates, dtype): tests/test_kernels.py's sweep, then S = 1,
# S below / at / past the 64-token chunk, ragged S, xlstm-1.3b's dh 1024,
# and extreme gates ("big_i": i_pre up to 40, the stabiliser at work;
# "forget": f_pre near -30, the state forgets every step)
MLSTM_BUCKETS = [
    (2, 3, 512, 64, "normal", "f32"), (1, 2, 256, 128, "normal", "bf16"),
    (1, 4, 128, 256, "normal", "f32"), (1, 4, 128, 256, "normal", "bf16"),
    (2, 2, 1, 64, "normal", "f32"), (1, 3, 37, 64, "big_i", "bf16"),
    (2, 2, 64, 256, "forget", "f32"), (1, 2, 200, 1024, "normal", "f32"),
    (1, 4, 71, 1024, "big_i", "bf16"), (1, 1, 130, 1024, "forget", "bf16"),
    (3, 1, 333, 192, "big_i", "f32"),
    # the engines' prefill shapes at xlstm-1.3b's width
    (1, 4, 1024, 1024, "normal", "bf16"), (4, 4, 1024, 1024, "normal", "f32"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(dt):
    return 2e-2 if dt == "bf16" else 2e-5


def _t(a, dt, dev):
    return torch.tensor(a, dtype=torch.float32).to(dev, TORCH_DTYPES[dt])


def _ragged_len(rng, ps, MP):
    hi = MP * ps
    kp = int(rng.integers(1, MP + 1)) * ps
    picks = [0, 1, ps - 1, ps, ps + 1, kp - 1, kp, kp + 1, hi,
             int(rng.integers(0, hi + 1))]
    return int(np.clip(picks[int(rng.integers(len(picks)))], 0, hi))


@pytest.mark.gpu
@pytest.mark.parametrize("bidx", range(len(PAGED_BUCKETS)))
def test_paged_decode_step_kernel_matches_plain(cuda, bidx):
    B, H, KVH, dh, ps, MP, window, dt = PAGED_BUCKETS[bidx]
    for i in range(20):
        rng = np.random.default_rng([SEED, 2, bidx, i])
        P = B * MP + 2
        lens = [_ragged_len(rng, ps, MP) for _ in range(B)]
        table = np.full((B, MP), -1, np.int32)
        free = list(rng.permutation(P - 1))
        for b, n in enumerate(lens):
            for c in range(-(-n // ps)):
                table[b, c] = free.pop()
        q = _t(rng.standard_normal((B, H, dh)), dt, cuda)
        kn = _t(rng.standard_normal((B, KVH, dh)), dt, cuda)
        vn = _t(rng.standard_normal((B, KVH, dh)), dt, cuda)
        k = _t(rng.standard_normal((P, ps, KVH, dh)), dt, cuda)
        v = _t(rng.standard_normal((P, ps, KVH, dh)), dt, cuda)
        tb = torch.from_numpy(table).to(cuda)
        ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
        out, ko, vo = paged_decode_step(q, kn, vn, k.clone(), v.clone(), tb,
                                        ln, window=window)
        ref, kr, vr = paged_decode_step_ref(q, kn, vn, k.clone(), v.clone(),
                                            tb, ln, window=window)
        torch.cuda.synchronize()
        msg = f"bucket={PAGED_BUCKETS[bidx]} case={i} lens={lens}"
        torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dt),
                                   rtol=_tol(dt), msg=lambda m: f"{msg}\n{m}")
        assert torch.equal(ko[:P - 1], kr[:P - 1]), msg
        assert torch.equal(vo[:P - 1], vr[:P - 1]), msg


@pytest.mark.gpu
def test_paged_decode_step_nan_trash_stays_harmless(cuda):
    """FREE rows write the trash page; NaN there must not reach any
    output (masked tokens are skipped, not multiplied by zero)."""
    rng = np.random.default_rng([SEED, 9])
    B, H, KVH, dh, ps, MP = 4, 8, 2, 64, 16, 8
    P = B * MP + 1
    lens = [0, 40, 7, 128]
    table = np.full((B, MP), -1, np.int32)
    table[1, :3] = [5, 2, 9]
    table[3, :] = [1, 3, 4, 6, 7, 8, 10, 11]
    x = [_t(rng.standard_normal(s), "f32", cuda) for s in
         [(B, H, dh), (B, KVH, dh), (B, KVH, dh), (P, ps, KVH, dh),
          (P, ps, KVH, dh)]]
    tb = torch.from_numpy(table).to(cuda)
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
    ref, _, _ = paged_decode_step_ref(*x[:3], x[3].clone(), x[4].clone(), tb,
                                      ln)
    k, v = x[3].clone(), x[4].clone()
    k[P - 1] = float("nan")
    v[P - 1] = float("inf")
    out, _, _ = paged_decode_step(*x[:3], k, v, tb, ln)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("bidx", range(len(FLASH_BUCKETS)))
def test_flash_attention_kernel_matches_plain(cuda, bidx):
    B, H, KVH, S, dh, causal, window, dt = FLASH_BUCKETS[bidx]
    for i in range(5):
        rng = np.random.default_rng([SEED, 4, bidx, i])
        q = _t(rng.standard_normal((B, H, S, dh)), dt, cuda)
        k = _t(rng.standard_normal((B, KVH, S, dh)), dt, cuda)
        v = _t(rng.standard_normal((B, KVH, S, dh)), dt, cuda)
        out = flash_attention(q, k, v, causal=causal, window=window)
        ref = flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dt),
                                   rtol=_tol(dt))



# the bf16 wgmma kernel's paths: head dims padded to the 64, 128 and 256
# buckets (8, 24, 192) and exact (64, 128, 256); S below one 64-row query
# tile, at it and around it, around one 128-key block (the key tile of
# the 64 and 128 buckets; two of the 256 bucket's 64-key blocks), many
# tiles (a causal pair then spans many blocks, and its longer walk is
# shared between the two warpgroups)
FLASH_MMA_DH = [8, 24, 64, 128, 192, 256]
FLASH_MMA_S = [1, 5, 15, 16, 17, 63, 64, 65, 127, 128, 129, 200, 1000,
               2600]


@pytest.mark.gpu
@pytest.mark.parametrize("S", FLASH_MMA_S)
@pytest.mark.parametrize("dh", FLASH_MMA_DH)
def test_flash_attention_bf16_mma_buckets(cuda, dh, S):
    """B = 2, g = 10 query heads per KV head; causal, causal with a window
    smaller than one 64-row tile, and non-causal."""
    B, H, KVH = 2, 10, 1
    for i, (causal, window) in enumerate([(True, None), (True, 40),
                                          (False, None)]):
        rng = np.random.default_rng([SEED, 11, dh, S, i])
        q = _t(rng.standard_normal((B, H, S, dh)), "bf16", cuda)
        k = _t(rng.standard_normal((B, KVH, S, dh)), "bf16", cuda)
        v = _t(rng.standard_normal((B, KVH, S, dh)), "bf16", cuda)
        out = flash_attention(q, k, v, causal=causal, window=window)
        ref = flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert out.dtype == torch.bfloat16
        torch.testing.assert_close(
            out.float(), ref.float(), atol=2e-2, rtol=2e-2,
            msg=lambda m: f"causal={causal} window={window}\n{m}")


# (g, dh, S): query heads per KV head (2 KV heads), head dim, length
FLASH_VIEWS = [(g, dh, S) for g in (1, 2, 8, 10) for dh in (64, 128, 256)
               for S in (1, 129, 1000)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(FLASH_VIEWS)))
def test_flash_attention_bf16_reads_strided_views(cuda, case):
    """The transposed views ``layers.full_attention`` passes (heads of a
    (B, S, heads, dh) projection), B = 2: read in place through the tensor
    maps, written to an output with q's strides; causal, a window smaller
    than one tile, non-causal."""
    g, dh, S = FLASH_VIEWS[case]
    B, KVH = 2, 2
    H = g * KVH
    for i, (causal, window) in enumerate([(True, None), (True, 40),
                                          (False, None)]):
        rng = np.random.default_rng([SEED, 13, case, i])
        q, k, v = (_t(rng.standard_normal((B, S, h, dh)), "bf16",
                      cuda).transpose(1, 2) for h in (H, KVH, KVH))
        out = flash_attention(q, k, v, causal=causal, window=window)
        ref = flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        if S > 1:        # a length of one makes the view contiguous
            assert out.stride() == q.stride() and not q.is_contiguous()
        torch.testing.assert_close(
            out.float(), ref.float(), atol=2e-2, rtol=2e-2,
            msg=lambda m: f"causal={causal} window={window}\n{m}")


@pytest.mark.gpu
def test_flash_attention_bf16_sass_is_wgmma_on_tma(cuda):
    """``cuobjdump -sass`` of the built library: every instance of the
    bf16 kernel holds warpgroup products (HGMMA) and tensor-map loads
    (UTMALDG) and no mma.sync (HMMA); the fp32 kernel beside it is left to
    its own checks."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.kernels import _build
    _build.build_all(["flash_attention"])
    fns = {fn: ops for fn, ops in
           chip_smoke.sass_counts("flash_attention").items()
           if "flash_wgmma_kernel" in fn}
    assert len(fns) == 3, sorted(fns)           # buckets 64, 128, 256
    for fn, ops in fns.items():
        assert ops["HGMMA"] > 0 and ops["UTMALDG"] > 0, (fn, ops)
        assert ops["HMMA"] == 0, (fn, ops)


# the fp32 tensor-core kernel's (3xTF32) paths: head dims padded to the
# 64, 128 and 256 buckets (8, 24, 192) and exact (64, 128, 256); S below
# one 16-row mma tile, at it, past it, past one 64-row tile (and one
# 128-row tile: dh 256 runs 8 warps a CTA), several tiles
FLASH_F32_DH = [8, 24, 64, 128, 192, 256]
FLASH_F32_S = [1, 5, 15, 16, 17, 65, 200, 1000]


@pytest.mark.gpu
@pytest.mark.parametrize("S", FLASH_F32_S)
@pytest.mark.parametrize("dh", FLASH_F32_DH)
def test_flash_attention_fp32_mma_buckets(cuda, dh, S):
    """B = 2, g = 10 query heads per KV head; causal, causal with a window
    smaller than one 64-row tile, and non-causal; at the fp32 tolerance
    against the plain version (TF32 off)."""
    B, H, KVH = 2, 10, 1
    for i, (causal, window) in enumerate([(True, None), (True, 40),
                                          (False, None)]):
        rng = np.random.default_rng([SEED, 12, dh, S, i])
        q = _t(rng.standard_normal((B, H, S, dh)), "f32", cuda)
        k = _t(rng.standard_normal((B, KVH, S, dh)), "f32", cuda)
        v = _t(rng.standard_normal((B, KVH, S, dh)), "f32", cuda)
        out = flash_attention(q, k, v, causal=causal, window=window)
        ref = flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert out.dtype == torch.float32
        torch.testing.assert_close(
            out, ref, atol=2e-5, rtol=2e-5,
            msg=lambda m: f"causal={causal} window={window}\n{m}")


# (H, KVH, S, dh, causal, window): the fp32 serving shapes (qwen2.5-3b,
# recurrentgemma-2b, stablelm-1.6b, whisper's encoder), long non-causal
# rows at the largest and smallest head dims, a padded one
FLASH_F32_F64 = [(16, 2, 1024, 128, True, None),
                 (10, 1, 2048, 256, True, 2048),
                 (32, 32, 512, 64, True, None),
                 (20, 20, 1500, 64, False, None),
                 (10, 1, 1000, 256, False, None),
                 (10, 1, 1000, 8, False, None),
                 (10, 1, 1000, 192, False, None),
                 (10, 1, 200, 24, True, 40)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(FLASH_F32_F64)))
def test_flash_attention_fp32_error_vs_fp64(cuda, case):
    """The kernel's largest error against the plain version run in fp64 is
    at most 4x the fp32 plain version's: 3xTF32 keeps fp32 accuracy,
    where one TF32 product a piece errs ~1e-3."""
    H, KVH, S, dh, causal, window = FLASH_F32_F64[case]
    rng = np.random.default_rng([SEED, 13, case])
    q, k, v = (_t(rng.standard_normal((1, h, S, dh)), "f32", cuda)
               for h in (H, KVH, KVH))
    out = flash_attention(q, k, v, causal=causal, window=window)
    plain = flash_attention_ref(q, k, v, causal=causal, window=window)
    exact = flash_attention_ref(q.double(), k.double(), v.double(),
                                causal=causal, window=window)
    torch.cuda.synchronize()
    e_kernel = (out.double() - exact).abs().max().item()
    e_plain = (plain.double() - exact).abs().max().item()
    assert e_kernel <= 4 * e_plain, (
        f"kernel error {e_kernel:.3g} against fp64 above 4x the fp32 plain "
        f"version's {e_plain:.3g}")


def _split_step_case(rng, B, H, KVH, dh, ps, MP, lens, dt, dev, free=()):
    """Inputs of one fused step over a pool of B·MP pages plus the trash
    page; FREE rows (``free``) have no pages."""
    P = B * MP + 1
    table = np.full((B, MP), -1, np.int32)
    pages = list(rng.permutation(P - 1))
    for b, n in enumerate(lens):
        if b not in free:
            for c in range(min(MP, -(-max(n, 1) // ps))):
                table[b, c] = pages.pop()
    x = [_t(rng.standard_normal(shape), dt, dev) for shape in
         [(B, H, dh), (B, KVH, dh), (B, KVH, dh), (P, ps, KVH, dh),
          (P, ps, KVH, dh)]]
    return x, torch.from_numpy(table).to(dev), torch.tensor(
        lens, dtype=torch.int32, device=dev)


def _step_vs_plain(x, table, lens, window, dt, what, k=None, v=None):
    """One kernel step and one plain step from the same pools: outputs
    within the tolerance, pools byte-equal outside the trash page."""
    k = x[3] if k is None else k
    v = x[4] if v is None else v
    P = k.shape[0]
    out, ko, vo = paged_decode_step(*x[:3], k.clone(), v.clone(), table,
                                    lens, window=window)
    ref, kr, vr = paged_decode_step_ref(*x[:3], x[3].clone(), x[4].clone(),
                                        table, lens, window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all(), what
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dt),
                               rtol=_tol(dt), msg=lambda m: f"{what}\n{m}")
    assert torch.equal(ko[:P - 1], kr[:P - 1]), what
    assert torch.equal(vo[:P - 1], vr[:P - 1]), what


# (label, B, H, KVH, dh, ps, MP, lens, window, FREE rows): one slot and
# one KV head over ~3,000 tokens (the most splits); short lens in a long
# pool (most shares empty); FREE rows among long slots; a window; a stale
# lens
SPLIT_STEP_CASES = [
    ("one slot, 3000 tokens", 1, 10, 1, 256, 16, 192, [3000], None, ()),
    ("one slot, 2999 tokens, window 2048", 1, 10, 1, 256, 16, 192, [2999],
     2048, ()),
    ("one slot, 3072 tokens, qwen heads", 1, 16, 2, 128, 16, 192, [3072],
     None, ()),
    ("short lens, empty shares", 4, 8, 2, 64, 16, 256, [0, 1, 2, 33], None,
     ()),
    ("short lens, window", 3, 8, 2, 64, 16, 256, [5, 40, 97], 16, ()),
    ("FREE rows among long slots", 4, 16, 2, 128, 16, 128, [2048, 3, 1500,
                                                            0], None,
     (1, 3)),
    ("FREE rows, window", 3, 10, 1, 256, 16, 128, [1700, 900, 2], 512,
     (1,)),
    # a stale lens past the table's MP·ps positions: the append clamps into
    # the last column, a row the walk reads (the plain version reads it
    # back after writing it)
    ("stale lens past the table", 2, 8, 2, 64, 16, 8, [133, 40], None, ()),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("cidx", range(len(SPLIT_STEP_CASES)))
def test_paged_decode_step_split_walk(cuda, cidx, dt):
    what, B, H, KVH, dh, ps, MP, lens, window, free = SPLIT_STEP_CASES[cidx]
    rng = np.random.default_rng([SEED, 12, cidx])
    x, table, ln = _split_step_case(rng, B, H, KVH, dh, ps, MP, lens, dt,
                                    cuda, free)
    _step_vs_plain(x, table, ln, window, dt, what)
    if free:
        # NaN / Inf in the trash page, which FREE rows append to, must not
        # reach any output under the split either
        k, v = x[3].clone(), x[4].clone()
        k[-1] = float("nan")
        v[-1] = float("inf")
        _step_vs_plain(x, table, ln, window, dt, f"{what}, NaN trash", k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_paged_decode_step_split_many_steps(cuda, dt):
    """One pool stepped 100 times in a row by the kernel and by the plain
    version, each step's output held to the plain one and the pools kept
    byte-equal: an arrival counter left dirty by one launch would show in
    the next."""
    rng = np.random.default_rng([SEED, 13])
    B, H, KVH, dh, ps, MP = 3, 8, 2, 64, 16, 32
    lens = [200, 37, 0]                  # row 2 FREE throughout
    x, table, _ = _split_step_case(rng, B, H, KVH, dh, ps, MP,
                                   [MP * ps, MP * ps, 0], dt, cuda, (2,))
    k, v = x[3].clone(), x[4].clone()
    kr, vr = x[3].clone(), x[4].clone()
    for step in range(100):
        lens = [n + 1 if b != 2 else n for b, n in enumerate(lens)]
        ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
        q, kn, vn = (_t(rng.standard_normal(s), dt, cuda) for s in
                     [(B, H, dh), (B, KVH, dh), (B, KVH, dh)])
        window = 64 if step % 3 == 0 else None
        out, _, _ = paged_decode_step(q, kn, vn, k, v, table, ln,
                                      window=window)
        ref, _, _ = paged_decode_step_ref(q, kn, vn, kr, vr, table, ln,
                                          window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dt),
                                   rtol=_tol(dt),
                                   msg=lambda m: f"step {step}\n{m}")
        assert torch.equal(k[:-1], kr[:-1]) and torch.equal(v[:-1], vr[:-1])

def _paged_case(rng, B, H, KVH, dh, ps, MP, dt, dev, zero_row=None):
    P = B * MP + 2
    lens = [_ragged_len(rng, ps, MP) for _ in range(B)]
    if zero_row is not None:
        lens[zero_row] = 0
    table = np.full((B, MP), -1, np.int32)
    free = list(rng.permutation(P - 1))
    for b, n in enumerate(lens):
        for c in range(-(-n // ps)):
            table[b, c] = free.pop()
    q = _t(rng.standard_normal((B, H, dh)), dt, dev)
    k = _t(rng.standard_normal((P, ps, KVH, dh)), dt, dev)
    v = _t(rng.standard_normal((P, ps, KVH, dh)), dt, dev)
    return (q, k, v, torch.from_numpy(table).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev)), lens


@pytest.mark.gpu
@pytest.mark.parametrize("bidx", range(len(PAGED_BUCKETS)))
def test_paged_decode_attention_kernel_matches_plain(cuda, bidx):
    """Read-only paged attention; every other case has a lens == 0 row
    (the uniform mean over all MP·ps entries)."""
    B, H, KVH, dh, ps, MP, window, dt = PAGED_BUCKETS[bidx]
    for i in range(20):
        rng = np.random.default_rng([SEED, 6, bidx, i])
        args, lens = _paged_case(rng, B, H, KVH, dh, ps, MP, dt, cuda,
                                 zero_row=(i % B) if i % 2 else None)
        out = paged_decode_attention(*args, window=window)
        ref = paged_decode_attention_ref(*args, window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            out.float(), ref.float(), atol=_tol(dt), rtol=_tol(dt),
            msg=lambda m: f"bucket={PAGED_BUCKETS[bidx]} lens={lens}\n{m}")


def _ring(rng, B, H, KVH, W, dh, dt, dev):
    """Rings filled 1..2W per row (wrapped past W), garbage in empty
    slots."""
    spos = np.full((B, W), -1, np.int32)
    pos = np.zeros((B,), np.int32)
    for b in range(B):
        fill = int(np.clip(_ragged_len(rng, W, 2), 1, 2 * W))
        for t in range(fill):
            spos[b, t % W] = t
        pos[b] = fill - 1
    q = _t(rng.standard_normal((B, H, dh)), dt, dev)
    k = _t(rng.standard_normal((B, W, KVH, dh)), dt, dev)
    v = _t(rng.standard_normal((B, W, KVH, dh)), dt, dev)
    return (q, k, v, torch.from_numpy(spos).to(dev),
            torch.from_numpy(pos).to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("bidx", range(len(DECODE_BUCKETS)))
def test_decode_attention_kernel_matches_plain(cuda, bidx):
    B, H, KVH, W, dh, window, dt = DECODE_BUCKETS[bidx]
    for i in range(20):
        rng = np.random.default_rng([SEED, 3, bidx, i])
        args = _ring(rng, B, H, KVH, W, dh, dt, cuda)
        out = decode_attention(*args, window=window)
        ref = decode_attention_ref(*args, window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dt),
                                   rtol=_tol(dt))


@pytest.mark.gpu
def test_decode_attention_masked_slots_skipped_and_empty_row(cuda):
    """NaN in masked ring slots never reaches a row that has a valid slot;
    a row with none is the uniform mean of V, as the plain version."""
    rng = np.random.default_rng([SEED, 10])
    q, k, v, spos, pos = _ring(rng, 3, 8, 2, 96, 64, "f32", cuda)
    spos[0, 50:] = -1                    # row 0: slots 50.. empty (NaN)
    pos[0] = 49
    spos[0, :50] = torch.arange(50, device=cuda, dtype=torch.int32)
    spos[1] = -1                         # row 1: no valid slot
    ref = decode_attention_ref(q, k, v, spos, pos)
    k2, v2 = k.clone(), v.clone()
    k2[0, 50:] = float("nan")
    v2[0, 50:] = float("inf")
    out = decode_attention(q, k2, v2, spos, pos)
    torch.cuda.synchronize()
    assert torch.isfinite(out[0]).all()
    torch.testing.assert_close(out[0], ref[0], atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(out[1:], ref[1:], atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=str)
def test_rglru_scan_kernel_matches_plain(cuda, shape, dt):
    B, S, d = shape
    rng = np.random.default_rng([SEED, 5, B, S, d])
    a = _t(rng.uniform(0.7, 0.999, (B, S, d)), dt, cuda)
    b = _t(rng.standard_normal((B, S, d)) * 0.1, dt, cuda)
    h0 = torch.tensor(rng.standard_normal((B, d)), dtype=torch.float32,
                      device=cuda)
    out = rglru_scan(a, b, h0)
    ref = rglru_scan_ref(a, b, h0)
    torch.cuda.synchronize()
    tol = 5e-2 if dt == "bf16" else 1e-4
    assert out.dtype == a.dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def _scan_inputs(B, S, d, dt, dev, seed, gates="normal"):
    """a, b in ``dt`` and h0 fp32, drawn on the card; "small" gates are
    the model's smallest (a down to 0.05: the chunk product A underflows
    to 0 within a chunk of 64)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lo, hi = (0.05, 0.12) if gates == "small" else (0.7, 0.999)
    a = lo + (hi - lo) * torch.rand((B, S, d), generator=gen, device=dev)
    b = 0.1 * torch.randn((B, S, d), generator=gen, device=dev)
    h0 = torch.randn((B, d), generator=gen, device=dev)
    return a.to(TORCH_DTYPES[dt]), b.to(TORCH_DTYPES[dt]), h0


def _scan_close(out, ref, dt, what):
    tol = 5e-2 if dt == "bf16" else 1e-4
    assert out.dtype == ref.dtype, what
    assert torch.isfinite(out.float()).all(), what
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol,
                               msg=lambda m: f"{what}\n{m}")


@pytest.mark.gpu
@pytest.mark.parametrize("count", ["one", "two", "picked", "most"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=str)
def test_rglru_scan_forced_chunk_counts(cuda, shape, dt, count):
    """Each shape at chunk count 1 (the plain walk), 2 (chunks longer than
    the shared-memory tile at long S), the count the wrapper picks, and
    the most (S chunks of one step)."""
    from repro_torch.kernels.rglru_scan import chunk_count, effective_chunks
    B, S, d = shape
    a, b, h0 = _scan_inputs(B, S, d, dt, cuda, S * 7 + d)
    picked = chunk_count(B, S, d, int(dt == "bf16"), a.device)
    n = {"one": 1, "two": 2, "picked": picked, "most": S}[count]
    rglru_scan.force_chunks = n
    try:
        out = rglru_scan(a, b, h0)
    finally:
        rglru_scan.force_chunks = None
    ref = rglru_scan_ref(a, b, h0)
    torch.cuda.synchronize()
    _scan_close(out, ref, dt, f"{shape} {dt} {effective_chunks(S, n)} "
                              f"chunks (picked {picked})")
    if B * -(-d // 128) < torch.cuda.get_device_properties(
            a.device).multi_processor_count and S >= 1000:
        assert picked > 1, (shape, picked)


@pytest.mark.gpu
def test_rglru_scan_fifty_calls_and_a_graph_replay_leave_status_zero(cuda):
    """50 calls in a row at changing shapes, dtypes, gates and chunk counts
    on the one per-device status scratch, then one CUDA-graph replay of a
    many-chunk call: each output held to the plain version, and every
    ticket, arrival counter and flag 0 at the end."""
    from repro_torch.kernels.rglru_scan import _STATUS
    shapes = [(1, 2048, 2560), (2, 300, 200), (1, 77, 37), (3, 1000, 384),
              (1, 1, 128)]
    counts = [None, 1, 2, 7, 64, 10**6]
    for i in range(50):
        B, S, d = shapes[i % len(shapes)]
        dt = "bf16" if i % 3 == 2 else "f32"
        gates = "small" if i % 4 == 1 else "normal"
        a, b, h0 = _scan_inputs(B, S, d, dt, cuda, 100 + i, gates)
        rglru_scan.force_chunks = counts[i % len(counts)]
        try:
            out = rglru_scan(a, b, h0)
        finally:
            rglru_scan.force_chunks = None
        _scan_close(out, rglru_scan_ref(a, b, h0), dt, f"call {i}")
    a, b, h0 = _scan_inputs(1, 2048, 2560, "f32", cuda, 99)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rglru_scan(a, b, h0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rglru_scan(a, b, h0)
    ref = rglru_scan_ref(a, b, h0)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        _scan_close(out, ref, "f32", "graph replay")
    assert _STATUS
    for ints, _ in _STATUS.values():
        assert int(ints.abs().sum()) == 0, ints.nonzero()


@pytest.mark.gpu
def test_rglru_scan_counts_one_launch_per_many_chunk_call(cuda):
    from repro_torch.kernels.rglru_scan import chunk_count
    a, b, h0 = _scan_inputs(1, 2048, 2560, "f32", cuda, 5)
    assert chunk_count(1, 2048, 2560, 0, a.device) > 1
    before = rglru_scan.launches
    rglru_scan(a, b, h0)
    assert rglru_scan.launches == before + 1


def _mlstm_inputs(B, H, S, dh, gates, dt, dev, seed):
    """q, k (scaled by 1/sqrt(dh)), v in ``dt``; fp32 gates."""
    rng = np.random.default_rng([SEED, 6, seed])
    x = lambda: rng.standard_normal((B, H, S, dh))        # noqa: E731
    i_pre = rng.standard_normal((B, H, S))
    f_pre = rng.standard_normal((B, H, S)) + 3.0
    if gates == "big_i":
        i_pre = i_pre * 10.0 + 20.0
    elif gates == "forget":
        f_pre = f_pre - 33.0
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa
    return (_t(x(), dt, dev), _t(x() / np.sqrt(dh), dt, dev),
            _t(x(), dt, dev), f32(i_pre), f32(f_pre))


def _mlstm_close(got, want, tol, what):
    """h within ``tol``; C, n and m within the fp32 tolerance in either
    dtype (both sides compute them in fp32 from the same inputs)."""
    (h, (C, n, m)), (hr, (Cr, nr, mr)) = got, want
    assert h.dtype == hr.dtype and torch.isfinite(h.float()).all()
    for name, a, b, t in (("h", h, hr, tol), ("C", C, Cr, 2e-4),
                          ("n", n, nr, 2e-4), ("m", m, mr, 2e-4)):
        torch.testing.assert_close(a.float(), b.float(), atol=t, rtol=t,
                                   msg=lambda e: f"{what} {name}: {e}")


@pytest.mark.gpu
@pytest.mark.parametrize("bidx", range(len(MLSTM_BUCKETS)))
def test_mlstm_chunkwise_kernel_matches_plain(cuda, bidx):
    B, H, S, dh, gates, dt = MLSTM_BUCKETS[bidx]
    args = _mlstm_inputs(B, H, S, dh, gates, dt, cuda, bidx)
    got = mlstm_chunkwise(*args)
    want = mlstm_chunkwise_ref(*args)
    torch.cuda.synchronize()
    _mlstm_close(got, want, 5e-2 if dt == "bf16" else 2e-4,
                 str(MLSTM_BUCKETS[bidx]))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mlstm_chunkwise_kernel_ill_conditioned(cuda, dt):
    """A large input gate over 1024 tokens: rows whose normaliser cancels
    far below its terms.  C, n and m within 2e-4 of the plain loop; h
    within tol (1 + scale) of the fp64 parallel form, scale being each
    output's conditioning (``mlstm_parallel_f64``)."""
    args = _mlstm_inputs(1, 8, 1024, 256, "big_i", dt, cuda, 77)
    h, state = mlstm_chunkwise(*args)
    _, state_r = mlstm_chunkwise_ref(*args)
    h64, scale, _ = mlstm_parallel_f64(*args)
    torch.cuda.synchronize()
    for name, a, b in zip("Cnm", state, state_r):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4,
                                   msg=lambda e: f"{name}: {e}")
    tol = 5e-2 if dt == "bf16" else 2e-4
    assert torch.isfinite(h.float()).all()
    assert ((h.double() - h64).abs() <= tol * (1.0 + scale)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("split", [1, 64, 100])
def test_mlstm_chunkwise_kernel_resumes_from_state(cuda, split):
    """Two launches, the second starting from the first's final state,
    give the one-launch result: the carry crosses launches intact."""
    q, k, v, i, f = _mlstm_inputs(2, 2, 230, 128, "normal", "f32", cuda,
                                 split)
    whole = mlstm_chunkwise(q, k, v, i, f)
    cut = lambda t, a, b: t[:, :, a:b]                   # noqa: E731
    h1, st = mlstm_chunkwise(*(cut(t, 0, split) for t in (q, k, v, i, f)))
    h2, st = mlstm_chunkwise(*(cut(t, split, 230) for t in (q, k, v, i, f)),
                             state=st)
    want = mlstm_chunkwise_ref(*(cut(t, split, 230) for t in (q, k, v, i, f)),
                               state=mlstm_chunkwise_ref(
                                   *(cut(t, 0, split)
                                     for t in (q, k, v, i, f)))[1])
    torch.cuda.synchronize()
    _mlstm_close((torch.cat([h1, h2], 2), st), whole, 2e-4, "split")
    _mlstm_close((h2, st), want, 2e-4, "split vs plain")


@pytest.mark.gpu
def test_wrappers_count_launches(cuda):
    before = {fn.__name__: fn.launches for fn in KERNELS}
    q = torch.zeros((1, 2, 3, 16), device=cuda)
    flash_attention(q, q[:, :1], q[:, :1])
    a = torch.zeros((1, 3, 8), device=cuda)
    rglru_scan(a, a, a[:, 0])
    x = torch.zeros((1, 1, 5, 64), device=cuda)
    mlstm_chunkwise(x, x, x, x[..., 0], x[..., 0])
    after = {fn.__name__: fn.launches for fn in KERNELS}
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["rglru_scan"] == before["rglru_scan"] + 1
    assert after["mlstm_chunkwise"] == before["mlstm_chunkwise"] + 1
    for name in ("paged_decode_step", "paged_decode_attention",
                 "decode_attention"):
        assert after[name] == before[name]


# ---- the bf16 decode walk on the tensor cores (csrc/decode_attend.cuh):
# query heads per KV head g up to two 16-row mma tiles, head dims the walk
# zero-pads (8, 24) or takes whole (128, 256)
WALK_G = [1, 3, 8, 10, 16, 17]
WALK_DH = [8, 24, 128, 256]


def _walk_case(rng, entry, B, g, dh, window, dev, empty_row, dt="bf16"):
    """(kernel, plain) outputs of one call of ``entry`` ("ring", "paged"
    read-only or "step") in ``dt``, KVH = 2, over walks of up to 208 tokens.
    With ``empty_row``, row 0 of the read-only forms has no valid token
    (the uniform mean over every entry, so no garbage is planted);
    otherwise masked ring slots and the trash page hold NaN."""
    KVH, ps, MP = 2, 16, 13
    H = g * KVH
    q = _t(rng.standard_normal((B, H, dh)), dt, dev)
    if entry == "ring":
        _, k, v, spos, pos = _ring(rng, B, H, KVH, 200, dh, dt, dev)
        kk, vv = k.clone(), v.clone()
        if empty_row:
            spos[0] = -1
        else:
            kk[spos < 0] = float("nan")
            vv[spos < 0] = float("nan")
        out = decode_attention(q, kk, vv, spos, pos, window=window)
        ref = decode_attention_ref(q, k, v, spos, pos, window=window)
        return out, ref
    lens = [int(rng.integers(1, MP * ps + 1)) for _ in range(B)]
    if empty_row and entry == "paged":
        lens[0] = 0
    x, table, ln = _split_step_case(rng, B, H, KVH, dh, ps, MP, lens, dt,
                                    dev)
    k, v = x[3].clone(), x[4].clone()
    if not empty_row:
        k[-1] = float("nan")                          # the trash page
        v[-1] = float("nan")
    if entry == "paged":
        out = paged_decode_attention(q, k, v, table, ln, window=window)
        ref = paged_decode_attention_ref(q, x[3], x[4], table, ln,
                                         window=window)
        return out, ref
    out, _, _ = paged_decode_step(q, x[1], x[2], k, v, table, ln,
                                  window=window)
    ref, _, _ = paged_decode_step_ref(q, x[1], x[2], x[3].clone(),
                                      x[4].clone(), table, ln, window=window)
    return out, ref


@pytest.mark.gpu
@pytest.mark.parametrize("dh", WALK_DH)
@pytest.mark.parametrize("g", WALK_G)
@pytest.mark.parametrize("entry", ["ring", "paged", "step"])
def test_decode_walk_bf16_heads_and_head_dims(cuda, entry, g, dh):
    """Each entry point in bf16 at g query heads per KV head and head dim
    dh, with and without a 64-token window and a row with no valid token,
    or with NaN in the masked entries: within 2e-2 of the plain version,
    and finite."""
    for i, (window, empty_row) in enumerate([(None, True), (64, False),
                                             (None, False), (64, True)]):
        rng = np.random.default_rng([SEED, 20, WALK_G.index(g), dh, i])
        out, ref = _walk_case(rng, entry, 3, g, dh, window, cuda, empty_row)
        torch.cuda.synchronize()
        what = f"{entry} g={g} dh={dh} window={window} empty={empty_row}"
        assert torch.isfinite(out.float()).all(), what
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2, msg=lambda m: f"{what}\n{m}")


@pytest.mark.gpu
@pytest.mark.parametrize("dh", WALK_DH)
@pytest.mark.parametrize("g", WALK_G)
@pytest.mark.parametrize("entry", ["ring", "paged", "step"])
def test_decode_walk_fp32_heads_and_head_dims(cuda, entry, g, dh):
    """The fp32 walk (3xTF32, 8-key warp tiles; row tiles of 16 query
    heads as the bf16 walk's) over the same cases: within 2e-5 of the
    plain version, and finite."""
    for i, (window, empty_row) in enumerate([(None, True), (64, False),
                                             (None, False), (64, True)]):
        rng = np.random.default_rng([SEED, 23, WALK_G.index(g), dh, i])
        out, ref = _walk_case(rng, entry, 3, g, dh, window, cuda, empty_row,
                              "f32")
        torch.cuda.synchronize()
        what = f"{entry} g={g} dh={dh} window={window} empty={empty_row}"
        assert torch.isfinite(out).all(), what
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5,
                                   msg=lambda m: f"{what}\n{m}")


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["ring", "paged", "step"])
def test_decode_walk_bf16_one_split_and_the_most(cuda, entry):
    """n_split = 1 (a walk of one 32-token tile, and 128 slots x 8 KV heads
    that fill the card alone) and the largest split the wrappers pick (one
    slot, one KV head, 3,000 tokens)."""
    from repro_torch.kernels import _build
    shapes = [(2, 10, 1, 256, 32, 16), (128, 16, 8, 64, 300, 64),
              (1, 10, 1, 256, 3072, 3000)]
    for B, H, KVH, dh, W, n in shapes:
        rng = np.random.default_rng([SEED, 21, B, W])
        q = _t(rng.standard_normal((B, H, dh)), "bf16", cuda)
        if entry == "ring":
            k = _t(rng.standard_normal((B, W, KVH, dh)), "bf16", cuda)
            v = _t(rng.standard_normal((B, W, KVH, dh)), "bf16", cuda)
            spos = torch.full((B, W), -1, dtype=torch.int32, device=cuda)
            spos[:, :n] = torch.arange(n, dtype=torch.int32, device=cuda)
            pos = torch.full((B,), n - 1, dtype=torch.int32, device=cuda)
            out = decode_attention(q, k, v, spos, pos)
            ref = decode_attention_ref(q, k, v, spos, pos)
            splits = _build.n_split("decode_attention", B * KVH, W, H // KVH,
                                    dh, 1, q.device)
        else:
            ps = 16
            MP = -(-W // ps)
            x, table, ln = _split_step_case(rng, B, H, KVH, dh, ps, MP,
                                            [n] * B, "bf16", cuda)
            if entry == "paged":
                out = paged_decode_attention(q, x[3], x[4], table, ln)
                ref = paged_decode_attention_ref(q, x[3], x[4], table, ln)
            else:
                out, _, _ = paged_decode_step(q, x[1], x[2], x[3].clone(),
                                              x[4].clone(), table, ln)
                ref, _, _ = paged_decode_step_ref(q, x[1], x[2],
                                                  x[3].clone(),
                                                  x[4].clone(), table, ln)
            splits = _build.n_split("paged_decode_step", B * KVH, MP * ps,
                                    H // KVH, dh, 1, q.device)
        torch.cuda.synchronize()
        if W <= 32 or B * KVH >= 1024:
            assert splits == 1, (B, KVH, W, splits)
        else:
            assert splits >= 32, (B, KVH, W, splits)
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2,
                                   msg=lambda m: f"{entry} {B} {W}\n{m}")


@pytest.mark.gpu
def test_decode_walk_fifty_calls_leave_counters_zero(cuda):
    """50 bf16 calls in a row, the three entry points in turn at changing
    shapes, on the one per-device counter buffer: each output held to the
    plain version, and every counter 0 at the end."""
    from repro_torch.kernels import paged_attention
    entries = ["ring", "paged", "step"]
    for i in range(50):
        rng = np.random.default_rng([SEED, 22, i])
        g = WALK_G[i % len(WALK_G)]
        out, ref = _walk_case(rng, entries[i % 3], 2 + i % 3, g,
                              WALK_DH[i % len(WALK_DH)],
                              64 if i % 4 == 0 else None, cuda, i % 2 == 0)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2, msg=lambda m: f"call {i}\n{m}")
    for counters in paged_attention._ARRIVALS.values():
        assert int(counters.abs().sum()) == 0, counters


# bf16 mLSTM on the tensor cores: (B, H, S, dh, gates); S below, at and past
# one 64-token chunk and 32 chunks of carried state; every case holds C, n
# and m to 2e-4 and h to 5e-2
MLSTM_BF16 = [(1, 2, S, dh, "normal") for dh in (64, 256, 1024)
              for S in (1, 63, 64, 65, 2048)]
MLSTM_BF16 += [(1, 2, 200, 256, "big_i"), (1, 2, 200, 256, "forget"),
               (1, 1, 300, 1024, "big_i"), (4, 4, 130, 256, "normal"),
               (2, 8, 64, 64, "forget")]


@pytest.mark.gpu
@pytest.mark.parametrize("case", MLSTM_BF16, ids=str)
def test_mlstm_chunkwise_bf16_mma(cuda, case):
    B, H, S, dh, gates = case
    args = _mlstm_inputs(B, H, S, dh, gates, "bf16", cuda,
                         1000 + MLSTM_BF16.index(case))
    got = mlstm_chunkwise(*args)
    want = mlstm_chunkwise_ref(*args)
    torch.cuda.synchronize()
    _mlstm_close(got, want, 5e-2, str(case))


@pytest.mark.gpu
@pytest.mark.parametrize("split", [1, 64, 100])
def test_mlstm_chunkwise_bf16_resumes_from_state(cuda, split):
    """The bf16 kernel from a given state: a second launch starting from
    the first's final state, against the plain loop over the same two
    halves (C, n, m at 2e-4, h at 5e-2)."""
    q, k, v, i, f = _mlstm_inputs(2, 2, 230, 256, "normal", "bf16", cuda,
                                 2000 + split)
    cut = lambda t, a, b: t[:, :, a:b]                   # noqa: E731
    first = [cut(t, 0, split) for t in (q, k, v, i, f)]
    second = [cut(t, split, 230) for t in (q, k, v, i, f)]
    h1, st = mlstm_chunkwise(*first)
    h2, st = mlstm_chunkwise(*second, state=st)
    hr1, st_r = mlstm_chunkwise_ref(*first)
    hr2, st_r = mlstm_chunkwise_ref(*second, state=st_r)
    torch.cuda.synchronize()
    _mlstm_close((torch.cat([h1, h2], 2), st),
                 (torch.cat([hr1, hr2], 2), st_r), 5e-2, f"split {split}")


# ------------------------------------------------ the execute-while-load path
@pytest.mark.gpu
def test_paged_pack_adopt_roundtrip_on_card(cuda):
    """``paged_pack`` of a slot's pages out of a random bf16 paged cache on
    the card, ``paged_adopt_scatter`` into other pages of a second cache,
    and a pack of those pages again: the same bytes, pools and position."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import (init_paged_cache, paged_adopt_scatter,
                                    paged_pack)
    cfg = reduced(get_config("qwen2.5-3b"), d_model=64)
    gen = torch.Generator(device=cuda).manual_seed(SEED)
    caches = []
    for _ in range(2):
        c = init_paged_cache(cfg, 3, page_size=16, n_pages=8, max_pages=8,
                             dtype=torch.bfloat16, device=cuda)
        for entry in c["layers"]:
            for t in entry.values():
                t.normal_(generator=gen)
        caches.append(c)
    src, dst = caches
    packed = paged_pack(cfg, src, 1, [6, 1, 3], 37, 16)
    buf, spec = packed.wire()
    assert buf.device == packed.kv[0]["k"].device
    assert buf.numel() == packed.nbytes
    paged_adopt_scatter(cfg, dst, packed.from_wire(buf, spec), 2, [0, 7, 4])
    back = paged_pack(cfg, dst, 2, [0, 7, 4], 37, 16)
    assert int(dst["pos"][2]) == 37
    for a, b in zip(packed.kv, back.kv):
        for name in ("k", "v"):
            assert torch.equal(a[name].view(torch.int16),
                               b[name].view(torch.int16))


@pytest.mark.gpu
def test_multicast_on_card_equals_reference(cuda):
    """Single-process multicast over per-node uint8 buffers on the card,
    1 -> 8 binomial and 2 -> 8 k-way, against the numpy oracle."""
    from repro_torch.core.multicast import binomial_schedule, kway_schedule
    from repro_torch.distributed import multicast, multicast_reference
    rng = np.random.default_rng(SEED)
    for k, sched in ((1, binomial_schedule(8, 6)),
                     (2, kway_schedule(8, 6, 2))):
        blocks = np.zeros((8, 6, 4096), np.uint8)
        blocks[:k] = rng.integers(0, 255, (6, 4096), dtype=np.uint8)
        bufs = [torch.from_numpy(b.copy()).to(cuda) for b in blocks]
        multicast(bufs, sched)
        want = multicast_reference(blocks, sched)
        for n in range(8):
            np.testing.assert_array_equal(bufs[n].cpu().numpy(), want[n])
            np.testing.assert_array_equal(want[n], blocks[0])


@pytest.mark.gpu
def test_preempt_export_readopt_on_card_equals_uninterrupted(cuda):
    """A reduced fp32 qwen2.5-3b engine on the card: preempting a decoding
    request over the PackedKV wire and adopting it back later gives the
    same tokens as an uninterrupted run (the kernels on both)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousBatchingEngine
    cfg = reduced(get_config("qwen2.5-3b"), d_model=64)
    params = init_params(cfg, seed=1, device=cuda)
    rng = np.random.default_rng(SEED)
    prompts = [list(map(int, rng.integers(0, 512, n))) for n in (6, 21)]

    def engine():
        eng = ContinuousBatchingEngine(cfg, params, n_slots=2, max_len=48,
                                       page_size=16)
        for i, p in enumerate(prompts):
            eng.submit(p, 12, req_id=i)
        return eng

    want = engine().run()
    eng = engine()
    for _ in range(4):
        eng.step()
    slot = next(i for i in eng.sched.live_slots()
                if eng.sched.slots[i] is not None
                and eng.sched.slots[i].generated)
    eng.preempt_export([slot])
    parked = eng.take_preempted()
    for _ in range(3):
        eng.step()
    eng.adopt([(seq, payload) for seq, payload, _ in parked])
    got = eng.run()
    assert got == want and eng.stats["preempted"] == 1


@pytest.mark.gpu
def test_multicast_group_nccl_world_size_one(cuda):
    """``multicast_group`` under an NCCL process group of one rank: the
    backend initialises, a 1-node schedule (no transfer) leaves the
    buffer as it was, and a barrier goes through NCCL.  Transfers across
    cards need more than one card and are not checked here."""
    import datetime
    import socket

    import torch.distributed as dist

    from repro_torch.core.multicast import binomial_schedule
    from repro_torch.distributed import multicast_group
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        buf = torch.arange(4 * 256, device=cuda).to(torch.uint8)
        before = buf.clone().reshape(4, 256)
        out = multicast_group(buf.reshape(4, 256), binomial_schedule(1, 4),
                              0)
        dist.barrier(device_ids=[cuda.index or 0])
        assert torch.equal(out, before)
    finally:
        dist.destroy_process_group()


def _cards(n_min):
    n = torch.cuda.device_count()
    if n < n_min:
        pytest.skip(f"needs {n_min} or more CUDA devices, found {n}")
    return min(n, 4)


NCCL_RANK = r"""
import datetime, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.core.multicast import binomial_schedule, kway_schedule
from repro_torch.distributed import multicast_group, multicast_reference

rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.cuda.set_device(rank)
dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
for k in (1, 2):
    sched = binomial_schedule(world, 6) if k == 1 \
        else kway_schedule(world, 6, k)
    src = np.random.default_rng(k).integers(0, 255, (6, 1 << 20),
                                            dtype=np.uint8)
    blocks = np.zeros((world, 6, 1 << 20), np.uint8)
    blocks[:k] = src
    buf = torch.from_numpy(blocks[rank].copy()).cuda()
    multicast_group(buf, sched, rank)
    want = multicast_reference(blocks, sched)[rank]
    assert (buf.cpu().numpy() == want).all() and (want == src).all(), k
dist.barrier()
dist.destroy_process_group()
print("RANK-OK", rank)
"""


@pytest.mark.gpu
def test_multicast_group_nccl_across_cards(cuda):
    """``multicast_group`` on NCCL, one rank a card (up to four), 1 -> N
    binomial and 2 -> N k-way schedules of 1 MiB blocks, against the
    numpy oracle; every rank a process with a bounded wait."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path
    world = _cards(2)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ,
               PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", NCCL_RANK, str(r),
                               str(world), port], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK-OK {r}" in out, err[-3000:]


@pytest.mark.gpu
def test_pipelined_forward_across_cards(cuda):
    """A reduced fp32 qwen2.5-3b with one pipeline stage a card (up to
    four), two microbatches: the logits agree with the one-card forward
    within 1e-4, and the flash kernel ran on every card."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import pipelined_forward, stage_params
    from repro_torch.kernels import flash_attention
    from repro_torch.models import forward, init_params
    n = _cards(2)
    cfg = reduced(get_config("qwen2.5-3b"), d_model=64, n_layers=8)
    params = init_params(cfg, seed=2, device=cuda)
    stages = stage_params(cfg, params, n, [f"cuda:{i}" for i in range(n)])
    assert [st.flat["@layer%04d/['attn']['wq']" % st.lo].device.index
            for st in stages] == list(range(n))
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 512, (4, 40))).to(cuda)
    before = flash_attention.launches
    out = pipelined_forward(cfg, stages, {"tokens": tokens}, 2)
    torch.cuda.synchronize()
    assert flash_attention.launches - before == 2 * cfg.n_layers
    ref = forward(cfg, params, {"tokens": tokens})["logits"]
    assert out.device.index == n - 1
    torch.testing.assert_close(out.to(cuda), ref, atol=1e-4, rtol=1e-4)



@pytest.mark.gpu
def test_pipelined_graphs_across_cards(cuda):
    """The same pipeline through ``PipelineGraphs`` (one stage's graphs a
    card, the hand-offs between them outside the graphs), two ticks: the
    second replays every stage and the head, and both equal the eager
    ``pipelined_forward`` bitwise, with equal flash launches."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import pipelined_forward, stage_params
    from repro_torch.distributed.pipeline import PipelineGraphs
    from repro_torch.kernels import flash_attention
    from repro_torch.models import init_params
    n = _cards(2)
    cfg = reduced(get_config("qwen2.5-3b"), d_model=64, n_layers=8)
    params = init_params(cfg, seed=2, device=cuda)
    stages = stage_params(cfg, params, n, [f"cuda:{i}" for i in range(n)])
    graphs = PipelineGraphs(cfg)
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 512, (4, 40))).to(cuda)
    last = torch.tensor([39, 0, 17, 25], device=cuda)
    want = pipelined_forward(cfg, stages, {"tokens": tokens}, 2, last=last)
    for _ in range(2):
        before = flash_attention.launches
        got = pipelined_forward(cfg, stages, {"tokens": tokens}, 2,
                                last=last, graphs=graphs)
        for i in range(n):
            torch.cuda.synchronize(i)
        assert flash_attention.launches - before == 2 * cfg.n_layers
        assert torch.equal(got, want)
    assert len(graphs) == n + 1 and len(graphs.graphs) == n
    # a stage: capture, then 3 replays (2 microbatches a tick); the head 1
    assert all(s.replays == (1 if k[0] == "head" else 3)
               for g in graphs.graphs.values() for k, s in g.steps.items())

# ------------------------------------------------------------ live cluster
def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


def _two_model_cluster(dev, models):
    """The reduced two-model live cluster of ``tests/test_torch_cluster.py``
    on ``dev``: model A hot on node 0 scales to three new nodes, model B
    from a host-warm copy to three more, while 12 requests are served
    through the pipelines and the local replicas."""
    from repro_torch.serving import LiveCluster
    lc = LiveCluster(n_nodes=8, n_slots=2, max_len=48, device=dev)
    lc.register("A", models["A"][0], _tree_to(models["A"][1], dev),
                n_blocks=4, hot_nodes=[0])
    lc.register("B", models["B"][0], _tree_to(models["B"][1], dev),
                n_blocks=4, warm_nodes=[7])
    lc.scale("A", 3)
    lc.scale("B", 3)
    rng = np.random.default_rng(SEED)
    for i in range(12):
        m = "AB"[i % 2]
        lc.submit(m, list(map(int, rng.integers(
            0, models[m][0].vocab_size, int(rng.choice([5, 8]))))), 6)
    while lc.step():
        lc.tick()
    lc.drain_serving()
    return lc


def _reduced_models():
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import init_params
    out = {}
    for m, arch, seed in (("A", "qwen2.5-3b", 0), ("B", "stablelm-1.6b", 1)):
        cfg = reduced(get_config(arch), d_model=64, n_layers=4)
        out[m] = (cfg, init_params(cfg, seed=seed, device="cpu"))
    return out


@pytest.mark.gpu
def test_live_cluster_on_card_equals_cpu(cuda):
    """The reduced two-model live cluster in fp32 on the card (the
    kernels) and on the CPU (their plain versions): the same registry
    bytes, every node's wire buffers equal to them, the same tokens."""
    models = _reduced_models()
    gpu, cpu = _two_model_cluster(cuda, models), _two_model_cluster(
        "cpu", models)
    for m in "AB":
        dep = gpu.models[m]
        np.testing.assert_array_equal(dep.registry, cpu.models[m].registry)
        for nd in gpu.complete_nodes(m):
            shard = gpu.nodes[nd].gpu_shard(m)
            for b, buf in shard.buffers.items():
                np.testing.assert_array_equal(buf, dep.registry[b])
            assert all(t.device.type == cuda.type
                       for t in shard.flat.values())
        assert gpu.results(m) == cpu.results(m)
    assert gpu.handoff_log == cpu.handoff_log
    assert sum(e.stats["adopted"] for m in "AB"
               for e in gpu.serving[m].locals_.values()) >= 1


@pytest.mark.gpu
def test_live_cluster_defaults_to_the_card(cuda):
    """No ``device``: the cluster runs on the GPU, every node's tensors
    and every engine's cache there."""
    from repro_torch.serving import LiveCluster
    cfg, params = _reduced_models()["A"]
    lc = LiveCluster(n_nodes=3, n_slots=2, max_len=48)
    lc.register("m", cfg, params, n_blocks=2, hot_nodes=[0])
    lc.scale("m", 2)
    lc.run_to_completion()
    for nd in lc.complete_nodes("m"):
        assert all(t.is_cuda for t in lc.nodes[nd].gpu_shard("m").flat
                   .values())
    assert lc.complete_nodes("m") == [0, 1, 2]
    assert all(e.device.type == "cuda"
               for e in lc.serving["m"].locals_.values())


@pytest.mark.gpu
def test_live_cluster_scale_down_frees_device_memory(cuda):
    """``scale_down`` releases a replica's device bytes: its unpacked rows
    and its engine's pool are freed, no reference survives."""
    from repro_torch.serving import LiveCluster
    cfg, params = _reduced_models()["B"]
    lc = LiveCluster(n_nodes=2, n_slots=2, max_len=48, device=cuda)
    lc.register("m", cfg, params, n_blocks=2, hot_nodes=[0])
    lc.scale("m", 1)
    lc.run_to_completion()
    lc.submit("m", [1, 2, 3, 4, 5], 4)
    lc.drain_serving()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    lc.scale_down("m", [1])
    torch.cuda.synchronize()
    assert before - torch.cuda.memory_allocated() >= lc.models["m"].nbytes
    assert lc.complete_nodes("m") == [0]


# ------------------------------------------------- the compiled decode tick
GRAPH_ARCHS = {"qwen2.5-3b": None, "recurrentgemma-2b": 5, "xlstm-1.3b": None,
               "qwen2-moe-a2.7b": None, "pixtral-12b": None}


def _graph_engine(arch, dtype, paged, dev, n_slots=3, seed=0):
    """A reduced ``arch`` engine on the card with ``n_slots`` requests
    prefilled and one decode tick run, so its decode graph is captured."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousBatchingEngine
    cfg = reduced(get_config(arch), d_model=128,
                  n_layers=GRAPH_ARCHS[arch])
    params = init_params(cfg, seed=seed, dtype=TORCH_DTYPES[dtype],
                         device=dev)
    kw = {"page_size": 16} if paged else {}
    eng = ContinuousBatchingEngine(cfg, params, n_slots=n_slots, max_len=256,
                                   paged=paged, max_prefill_per_tick=n_slots,
                                   **kw)
    rng = np.random.default_rng(seed + 1)
    for i in range(n_slots):
        eng.submit(list(map(int, rng.integers(0, cfg.vocab_size,
                                              30 + 17 * i))), 64, req_id=i)
    eng.step()                       # prefills
    assert eng.decode_graph is None
    eng.step()                       # the first decode tick, then capture
    assert eng.decode_graph is not None
    if paged:                        # pages for the replays below
        for slot in eng.sched.live_slots():
            eng.pages.ensure(slot, eng.sched.slots[slot].pos + 8)
        eng._sync_table()
    return cfg, params, eng


def _cache_clone(tree):
    if isinstance(tree, dict):
        return {k: _cache_clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cache_clone(v) for v in tree]
    return tree.clone()


def _replay_vs_eager(cfg, params, eng, dtype, ticks=3):
    """Replay the engine's graph ``ticks`` times, each against the eager
    ``decode_step`` on a clone of the same state: fp32 logits within 1e-6
    of the largest logit, bf16 argmax equal, the same next state."""
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import decode_step
    n_attn = sum(1 for e in eng.cache["layers"] if "k" in e)
    for _ in range(ticks):
        ref_cache = _cache_clone(eng.cache)
        want, ref_cache = decode_step(cfg, params, ref_cache,
                                      eng._tok.clone(), ref_cache["pos"])
        reset_launch_counts()
        eng.decode_graph.replay(eng._graph_inputs())
        torch.cuda.synchronize()
        got = eng.decode_graph.out
        step = paged_decode_step if eng.paged else decode_attention
        assert step.launches == n_attn
        assert sum(k.launches for k in KERNELS) == n_attn
        if dtype == "f32":
            scale = want.abs().max().item()
            assert (got - want).abs().max().item() <= 1e-6 * scale
        assert torch.equal(got.argmax(-1), want.argmax(-1))
        assert torch.equal(eng._tok, want.argmax(-1))
        assert torch.equal(eng.cache["pos"], ref_cache["pos"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "striped"])
@pytest.mark.parametrize("arch", sorted(GRAPH_ARCHS))
def test_decode_graph_replay_matches_eager_decode_step(cuda, arch, paged,
                                                       dtype):
    cfg, params, eng = _graph_engine(arch, dtype, paged, cuda)
    _replay_vs_eager(cfg, params, eng, dtype)
    assert eng.decode_graph.capture_s > 0


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "striped"])
@pytest.mark.parametrize("arch", sorted(GRAPH_ARCHS))
def test_decode_graph_launch_counts_equal_eager(cuda, arch, paged):
    """A whole run with graph replays counts what the eager path
    launches: one decode kernel per attention layer per decode tick, the
    prefill kernels per prefill."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousBatchingEngine
    cfg = reduced(get_config(arch), d_model=128, n_layers=GRAPH_ARCHS[arch])
    params = init_params(cfg, seed=2, device=cuda)
    kw = {"page_size": 16} if paged else {}
    eng = ContinuousBatchingEngine(cfg, params, n_slots=3, max_len=128,
                                   paged=paged, **kw)
    rng = np.random.default_rng(3)
    for i in range(5):
        prompt = rng.integers(0, cfg.vocab_size, 20 + 9 * i)
        eng.submit(list(map(int, prompt)), 6 + i, req_id=i)
    reset_launch_counts()
    out = eng.run()
    torch.cuda.synchronize()
    s = eng.stats
    mixers = [e.split(":")[0] for e in
              (cfg.layer_pattern[i % cfg.pattern_len]
               for i in range(cfg.n_layers))]
    n_attn = sum(m.startswith("attn") for m in mixers)
    want = {"paged_decode_step" if paged else "decode_attention":
            n_attn * s["decode_ticks"],
            "flash_attention": n_attn * s["prefills"],
            "rglru_scan": mixers.count("rec") * s["prefills"],
            "mlstm_chunkwise": mixers.count("mlstm") * s["prefills"]}
    got = {k.__name__: k.launches for k in KERNELS}
    assert got == {k: want.get(k, 0) for k in got}
    assert eng.decode_graph.replays == s["decode_ticks"] - 1
    assert len(out) == 5


@pytest.mark.gpu
def test_moe_decode_step_never_syncs_the_host(cuda):
    """The MoE decode step (the static dispatch: counts by scatter-add, no
    host read) runs under ``set_sync_debug_mode("error")``, and the
    engine captured it as a graph whose replays equal the eager step;
    the grouped prefill form, which reads the expert counts once a layer,
    is refused by the same mode."""
    from repro_torch.models import decode_step_inplace
    from repro_torch.models import moe
    cfg, params, eng = _graph_engine("qwen2-moe-a2.7b", "f32", True, cuda)
    cache, tok = _cache_clone(eng.cache), eng._tok.clone()
    x = torch.randn((1, 40, cfg.d_model), device=cuda)
    p = next(lp["moe"] for lp in params["layers"] if "moe" in lp)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        decode_step_inplace(cfg, params, cache, tok)
        moe.apply_moe(p, x, cfg, capacity_factor=None, need_aux=False)
        with pytest.raises(RuntimeError):
            moe.apply_moe(p, x, cfg, capacity_factor=None, grouped=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _replay_vs_eager(cfg, params, eng, "f32")


@pytest.mark.gpu
def test_decode_graphs_of_two_engine_sizes_on_one_card(cuda):
    """The smaller engine captures first; the larger one, built after,
    grows the decode kernels' shared arrival counters.  The first graph
    keeps launching on the counters it captured (kept alive), and both
    engines' replays still equal the eager step."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import _ARRIVALS
    dev = torch.device("cuda", torch.cuda.current_device())   # their key
    old = _ARRIVALS.pop(dev, None)
    if old is not None:
        _build._retired.append(old)      # graphs of earlier tests hold it
    small = _graph_engine("qwen2.5-3b", "f32", True, cuda, n_slots=2)
    first = _ARRIVALS[dev]
    large = _graph_engine("qwen2.5-3b", "f32", True, cuda, n_slots=8,
                          seed=5)
    assert _ARRIVALS[dev] is not first
    assert _ARRIVALS[dev].numel() > first.numel()
    assert any(t is first for t in _build._retired)
    for cfg, params, eng in (small, large, small):
        _replay_vs_eager(cfg, params, eng, "f32", ticks=2)


@pytest.mark.gpu
def test_decode_graph_capture_runs_with_the_collector_off(cuda):
    """No garbage collection inside a capture (collecting an old graph
    there frees device memory and invalidates the capture, as an earlier
    test's engine did mid-suite): the body sees the collector off while
    it is captured, on while it runs eagerly, and it is on again after."""
    import gc
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousBatchingEngine
    cfg = reduced(get_config("qwen2.5-3b"), d_model=128)
    eng = ContinuousBatchingEngine(cfg, init_params(cfg, seed=0, device=cuda),
                                   n_slots=2, max_len=64)
    seen = []
    body = eng._decode_body

    def watched():
        seen.append((torch.cuda.is_current_stream_capturing(),
                     gc.isenabled()))
        return body()
    eng._decode_body = watched
    eng.submit([1, 2, 3, 4], 4, req_id=0)
    assert gc.isenabled()
    eng.run()
    assert seen[:2] == [(False, True), (True, False)] and gc.isenabled()
    assert eng.decode_graph.replays == len(eng.sched.finished[0].generated) - 2


@pytest.mark.gpu
def test_autotuned_page_size_on_card(cuda, monkeypatch, tmp_path):
    """``page_size="auto"`` on the card: every candidate timed by CUDA
    events around a graph replay of the fused step, the fastest kept."""
    import json
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.autotune import autotune_key
    from repro_torch.models import paged_geometry
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    cfg = reduced(get_config("qwen2.5-3b"), d_model=128)
    ps, bk = paged_geometry(cfg, 8, 512, page_size="auto", device=cuda)
    key = autotune_key(cfg, 8, 512, "kernel", device=cuda)
    assert "|cuda-sm" in key
    entry = json.loads((tmp_path / "t.json").read_text())["entries"][key]
    assert bk is None and ps == entry["page_size"]
    assert [r[0] for r in entry["table"]] == [8, 16, 32]
    assert all(0 < r[2] < 0.01 for r in entry["table"])


@pytest.mark.gpu
def test_autotune_times_a_bf16_engine_on_the_bf16_kernel(cuda, monkeypatch,
                                                         tmp_path):
    """A bf16 engine with ``page_size="auto"`` tunes on the bf16 walk
    (``attend_mma``), not on the fp32 CUDA-core one: every step the sweep
    times runs bf16 pools, launches the kernel, and the winner is stored
    under the bf16 key."""
    import json
    import repro_torch.kernels as kernels
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.autotune import autotune_key
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousBatchingEngine
    seen = []
    step = kernels.paged_decode_step

    def recorded(q, kn, vn, k, v, *a, **kw):
        seen.append((q.dtype, k.dtype, k.device.type))
        return step(q, kn, vn, k, v, *a, **kw)

    monkeypatch.setattr(kernels, "paged_decode_step", recorded)
    cache = tmp_path / "t.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(cache))
    cfg = reduced(get_config("qwen2.5-3b"), d_model=128)
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=cuda)
    base = step.launches
    eng = ContinuousBatchingEngine(cfg, params, n_slots=8, max_len=512,
                                   page_size="auto", prefix_sharing=False)
    bf16 = torch.bfloat16
    assert seen and set(seen) == {(bf16, bf16, "cuda")}
    assert step.launches - base == 3 * (1 + 3)   # warm-up + 3 replays each
    key = autotune_key(cfg, 8, 512, "kernel", device=cuda, dtype=bf16)
    entries = json.loads(cache.read_text())["entries"]
    assert set(entries) == {key} and key.endswith("|bfloat16")
    assert eng.page_size == entries[key]["page_size"]


@pytest.mark.gpu
def test_coldstart_demo_on_card(cuda, capsys):
    """``launch/serve.py --coldstart`` with no ``--device``: the card;
    greedy tokens equal across the pipelined + compile-cache path and
    the naive path (the demo asserts it)."""
    import argparse
    from repro_torch.launch.serve import run_coldstart
    run_coldstart(argparse.Namespace(arch="qwen2.5-3b", d_model=None,
                                     device=None, dtype="bfloat16",
                                     requests=4, seed=0))
    out = capsys.readouterr().out
    assert "bit-equal" in out and "on NVIDIA" in out


@pytest.mark.gpu
def test_kernel_wrapper_refuses_grad_inputs(cuda):
    """A CUDA kernel has no backward: its wrapper raises on an input that
    requires a grad while grad mode is on, instead of returning an output
    detached from it; under ``no_grad`` it launches as usual."""
    q = torch.randn(1, 4, 16, 64, device=cuda, requires_grad=True)
    k = torch.randn(1, 2, 16, 64, device=cuda)
    before = flash_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, k)
    assert flash_attention.launches == before
    with torch.no_grad():
        out = flash_attention(q, k, k)
    assert flash_attention.launches == before + 1
    assert not out.requires_grad


# ------------------------------------------------ the compiled prefills
PREFILL_ARCHS = {"qwen2.5-3b": None, "recurrentgemma-2b": 5, "xlstm-1.3b": None}


def _prefill_twins(arch, paged, dev, n_layers=None):
    """Two reduced ``arch`` engines on the same fp32 weights: the first
    captures its prefill steps per length bucket, the second runs the
    same padded steps eagerly."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import graph
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousBatchingEngine
    cfg = reduced(get_config(arch), d_model=128,
                  n_layers=n_layers or PREFILL_ARCHS.get(arch))
    params = init_params(cfg, seed=4, device=dev)
    kw = {"page_size": 16} if paged else {}
    twins = [ContinuousBatchingEngine(cfg, params, n_slots=4, max_len=256,
                                      paged=paged, max_prefill_per_tick=2,
                                      **kw) for _ in range(2)]
    twins[1].prefill_graphs = graph.StepGraphs(dev, capturing=False)
    return cfg, twins


def _same_state(a, b):
    """Every cache leaf bitwise equal (the pools without their trash
    page, which padded rows write in no fixed order), and ``_tok``."""
    assert torch.equal(a._tok, b._tok)
    assert torch.equal(a.cache["pos"], b.cache["pos"])
    for i, (x, y) in enumerate(zip(a.cache["layers"], b.cache["layers"])):
        for name in x:
            if "k" in x and a.paged:
                assert torch.equal(x[name][:-1], y[name][:-1]), (i, name)
            else:
                assert torch.equal(x[name], y[name]), (i, name)


def _prefill_trace(vocab, arch):
    """Prompts whose buckets repeat (replays), two lengths a bucket, and
    for the dense arch prompts sharing 37 tokens of a 40-token prefix
    (suffixes after a mid-page fork: a suffix graph and its replay)."""
    rng = np.random.default_rng(8)
    tok = lambda n: list(map(int, rng.integers(0, vocab, n)))  # noqa: E731
    base = tok(40)
    prompts = [base + tok(5), tok(50), tok(33), tok(100), tok(120)]
    if arch == "qwen2.5-3b":
        prompts += [base[:37] + tok(13), base[:37] + tok(9),
                    base[:37] + tok(11)]
    return [(p, 4 + i % 3) for i, p in enumerate(prompts)]


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "striped"])
@pytest.mark.parametrize("arch", sorted(PREFILL_ARCHS))
def test_prefill_graph_replays_equal_eager_steps(cuda, arch, paged,
                                                monkeypatch):
    """One trace through both twins, tick by tick: after every tick the
    caches are bitwise equal and so are the launch counts of the tick
    (a replay adds what its capture recorded); fresh (and, dense paged,
    suffix) prefills were replayed, in one memory pool.  The RG-LRU scan
    runs one chunk a chain: its look-back adds carries in arrival order,
    so two runs of the chunked scan may differ in the last bits."""
    from repro_torch.kernels import reset_launch_counts
    monkeypatch.setattr(rglru_scan, "force_chunks", 1)
    cfg, (g, e) = _prefill_twins(arch, paged, cuda)
    for eng in (g, e):
        for i, (p, n) in enumerate(_prefill_trace(cfg.vocab_size, arch)):
            eng.submit(p, n, req_id=i)
    while True:
        counts = []
        for eng in (g, e):
            reset_launch_counts()
            ran = eng.step()
            torch.cuda.synchronize()
            counts.append({k.__name__: k.launches for k in KERNELS})
        assert counts[0] == counts[1]
        _same_state(g, e)
        if not ran:
            break
    g.flush(), e.flush()
    assert {r: s.generated for r, s in g.sched.finished.items()} == \
        {r: s.generated for r, s in e.sched.finished.items()}
    steps = g.prefill_graphs.steps
    assert len(e.prefill_graphs) == 0 and ("fresh", 64) in steps
    assert steps[("fresh", 64)].replays >= 1
    if arch == "qwen2.5-3b" and paged:
        assert g.stats["shared_tokens"] > 0
        assert steps[("suffix", 16)].replays >= 1
    assert {s.graph.pool() for s in steps.values()} == \
        {g.prefill_graphs.pool}
    assert g.decode_graph.graph.pool() != g.prefill_graphs.pool
    assert all(s.capture_s > 0 for s in steps.values())


@pytest.mark.gpu
def test_prefill_graph_stale_address_raises(cuda):
    """A cache leaf replaced after a bucket's capture: the next prefill of
    that bucket raises instead of replaying on the old address."""
    _, (g, _) = _prefill_twins("qwen2.5-3b", True, cuda)
    g.pages.ensure(0, 20)
    g._sync_table()
    g._prefill_step("fresh", 0, list(range(1, 21)))
    assert ("fresh", 32) in g.prefill_graphs.steps
    g.cache["pos"] = g.cache["pos"].clone()
    with pytest.raises(RuntimeError, match="stale CUDA graph"):
        g._prefill_step("fresh", 1, list(range(1, 25)))


@pytest.mark.gpu
def test_prefill_scratch_grows_only_outside_a_capture(cuda, monkeypatch):
    """The RG-LRU scan's status scratch, dropped first, grows at the eager
    warm-up of each larger bucket and never inside a capture, and the
    captured graphs of the smaller buckets still replay equal to eager."""
    import importlib
    from repro_torch.kernels import _build
    scan = importlib.import_module("repro_torch.kernels.rglru_scan")
    dev = torch.device("cuda", torch.cuda.current_device())
    old = scan._STATUS.pop(dev, None)
    if old is not None:
        _build._retired.extend(old)     # graphs of earlier tests hold it
    grown = []
    orig = _build.grow_scratch

    def watched(old, make, what):
        grown.append(torch.cuda.is_current_stream_capturing())
        return orig(old, make, what)
    monkeypatch.setattr(_build, "grow_scratch", watched)
    monkeypatch.setattr(rglru_scan, "force_chunks", 1)   # one sum order
    cfg, (g, e) = _prefill_twins("recurrentgemma-2b", True, cuda)
    rng = np.random.default_rng(9)
    for slot, n in enumerate((20, 30, 200, 25)):     # buckets 32, 256, 32
        toks = list(map(int, rng.integers(0, cfg.vocab_size, n)))
        firsts = []
        for eng in (g, e):
            eng.pages.ensure(slot, n)
            eng._sync_table()
            firsts.append(eng._prefill_step("fresh", slot, toks))
        torch.cuda.synchronize()
        assert torch.equal(*firsts)
        _same_state(g, e)
    assert grown and not any(grown)
    assert g.prefill_graphs.steps[("fresh", 32)].replays == 2


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "pixtral-12b",
                                  "whisper-large-v3"])
def test_static_engine_graphs_equal_eager(cuda, arch):
    """``InferenceEngine`` with its prefill and decode captured against
    the same engine with both eager, two ``generate`` calls each (the
    second all replays): the same tokens, the same engine cache bitwise
    and the same launch counts; a pixtral batch carries patches, a
    whisper batch its frames."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import graph, reset_launch_counts
    from repro_torch.models import init_params, make_batch
    from repro_torch.serving import InferenceEngine
    cfg = reduced(get_config(arch), d_model=128)
    params = init_params(cfg, seed=6, device=cuda)
    g, e = InferenceEngine(cfg, params), InferenceEngine(cfg, params)
    e.prefill_graphs = graph.StepGraphs(cuda, capturing=False)
    e.decode_graphs = graph.StepGraphs(cuda, capturing=False)
    for seed in (7, 8):
        batch = make_batch(cfg, 2, 27 + (cfg.n_patches or 0), seed=seed,
                           device=cuda)
        out, counts = [], []
        for eng in (g, e):
            reset_launch_counts()
            out.append(eng.generate(batch, 8))
            torch.cuda.synchronize()
            counts.append({k.__name__: k.launches for k in KERNELS})
        assert torch.equal(*out) and counts[0] == counts[1]
        for x, y in zip(g._shapes.values(), e._shapes.values()):
            for a, b in zip(_leaves_of(x["cache"]), _leaves_of(y["cache"])):
                assert torch.equal(a, b)
    assert len(g.prefill_graphs) == 1 and len(g.decode_graphs) == 1
    assert next(iter(g.decode_graphs.steps.values())).replays == 7 + 6


def _leaves_of(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves_of(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves_of(v)
    else:
        yield tree


@pytest.mark.gpu
def test_pipelined_tick_graphs_equal_eager(cuda):
    """The λPipe tick (four stages and the head on one card, two
    microbatches) through ``PipelineGraphs`` twice, the second all
    replays, against the eager ``pipelined_forward``: bitwise equal
    logits and equal launch counts."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import (PipelinedEngine, pipelined_forward,
                                         stage_params)
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import init_params
    cfg = reduced(get_config("qwen2.5-3b"), d_model=128, n_layers=4)
    params = init_params(cfg, seed=7, device=cuda)
    stages = stage_params(cfg, params, 4, [cuda] * 4)
    pipe = PipelinedEngine.from_stages(cfg, stages, n_microbatches=2,
                                       n_slots=4, max_len=128, pad_to=16)
    rng = np.random.default_rng(10)
    for _ in range(2):
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                               (4, 48))).to(cuda)
        last = torch.tensor([47, 3, 20, 31], device=cuda)
        reset_launch_counts()
        got = pipe.forward_fn(tokens, last)
        torch.cuda.synchronize()
        n_got = flash_attention.launches
        reset_launch_counts()
        want = pipelined_forward(cfg, stages, {"tokens": tokens}, 2,
                                 last=last)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert n_got == flash_attention.launches == 4 * 2
    assert len(pipe.graphs) == 5            # four stages and the head
