"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports no JAX (the GPU machine has none), so on the card it runs
without the suite's JAX fixture:

  PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Shapes are the fuzz harness's buckets (``tests/test_kernel_fuzz.py``),
which reach widths the serving path never uses (dh=8, 4-token pages);
``chip_smoke.py`` covers the serving path's shapes.  Tolerances are the
harness's: 2e-5 in fp32 (TF32 off) and 2e-2 in bf16, with the pools
byte-equal outside the trash page.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention, paged_decode_step
from repro_torch.kernels.ref import flash_attention_ref, paged_decode_step_ref

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


@pytest.mark.gpu
def test_wrappers_count_launches(cuda):
    before = (paged_decode_step.launches, flash_attention.launches)
    q = torch.zeros((1, 2, 3, 16), device=cuda)
    flash_attention(q, q[:, :1], q[:, :1])
    assert flash_attention.launches == before[1] + 1
    assert paged_decode_step.launches == before[0]
