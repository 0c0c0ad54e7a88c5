"""The numerics of the fp32 flash kernel, emulated on the CPU.

On the card fp32 ``flash_attention`` runs on the tensor cores as 3xTF32
(``csrc/flash_attention.cu``, ``flash_tf32x3_kernel``): every fp32
operand x is split into big = x rounded to tf32 (11 significant bits, to
nearest, ties away from zero) and small = x - big, which the mma reads as
tf32 by dropping its low 13 bits; a product a·b is taken as small·big +
big·small + big·big, accumulated in fp32.  This file emulates that
arithmetic with the kernel's tiling (32-key tiles, 16 at head dim 256;
head dims zero-padded to 64, 128 or 256; 8-deep k-steps; the score's
big·big and small terms in separate accumulators; each tile's P·V from
zero, joined to O by one fma; the online softmax in fp32 with
scale·log2(e) folded into exp2) and holds it to an fp64 attention:

- within 2e-5 (atol = rtol), the fp32 tolerance of ``chip_smoke.py`` and
  ``tests/test_torch_gpu.py``;
- within 4x the fp32 plain version's own error against fp64;
- while one TF32 product a piece (big·big alone) misses the tolerance:
  the split is what makes the tensor cores usable in fp32.

The emulation is only here; no path of the port runs it.  The card
tests hold the kernel itself to the same two bounds.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import NEG_INF, flash_attention_ref

SEED = 20261018
TOL = 2e-5
LOG2E = 1.4426950408889634
MASKS = {"causal": (True, None), "window40": (True, 40),
         "non-causal": (False, None)}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: small eager loops, several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32_rna(x):
    """x rounded to tf32 to nearest, ties away from zero: the magnitude's
    bits plus half a tf32 ulp, the low 13 bits cleared (finite x)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    bits = (bits + 0x1000) & ~0x1FFF
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def tf32_trunc(x):
    """x as an mma reads a .tf32 operand: its low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x):
    big = tf32_rna(x)
    return big, tf32_trunc(x - big)


def products(a, b, terms, shared=False):
    """(a @ b) in fp32 over 8-deep k-steps: 3xTF32 (small·big, big·small,
    big·big, in that order each k-step) or one TF32 product; one
    accumulator a term, or one for all (``shared``)."""
    (ab, asm), (bb, bsm) = split(a), split(b)
    pairs = [(asm, bb), (ab, bsm), (ab, bb)] if terms == 3 else [(ab, bb)]
    accs = [torch.zeros(a.shape[:-1] + (b.shape[-1],))
            for _ in (pairs[:1] if shared else pairs)]
    for k in range(0, a.shape[-1], 8):
        for i, (x, y) in enumerate(pairs):
            j = 0 if shared else i
            accs[j] = accs[j] + x[..., k:k + 8] @ y[..., k:k + 8, :]
    return accs


def fma(a, b, c):
    """fp32 a·b + c with one rounding (exact in fp64, then rounded)."""
    return (a.double() * b.double() + c.double()).float()


def emulate(q, k, v, causal, window, terms=3):
    """The kernel's arithmetic on fp32 q (B,H,S,dh), k/v (B,KVH,S,dh)."""
    B, H, S, dh = q.shape
    KVH = k.shape[1]
    g = H // KVH
    DH = 64 if dh <= 64 else 128 if dh <= 128 else 256
    BK = 16 if DH == 256 else 32
    pad = lambda x: torch.nn.functional.pad(x, (0, DH - dh))
    qg = pad(q).reshape(B, KVH, g * S, DH)
    kp, vp = pad(k), pad(v)
    c = torch.tensor(1.0 / math.sqrt(dh) * LOG2E, dtype=torch.float32)
    qpos = torch.arange(S).repeat(g)[:, None]
    m = torch.full((B, KVH, g * S, 1), NEG_INF)
    l = torch.zeros((B, KVH, g * S, 1))
    o = torch.zeros((B, KVH, g * S, DH))
    for k0 in range(0, S, BK):
        kt, vt = kp[:, :, k0:k0 + BK], vp[:, :, k0:k0 + BK]
        accs = products(qg, kt.transpose(-1, -2), terms)
        s = accs[-1] + (accs[0] + accs[1]) if terms == 3 else accs[0]
        kpos = torch.arange(k0, min(k0 + BK, S))[None, :]
        ok = torch.ones((g * S, kpos.shape[1]), dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window is not None:
            ok &= qpos - kpos < window
        s = torch.where(ok, s, torch.tensor(NEG_INF))
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2((m - mx) * c)
        p = torch.exp2(fma(s, c, -(mx * c)))
        p = torch.where(ok, p, torch.tensor(0.0))
        l = l * corr + p.sum(-1, keepdim=True)
        o = fma(o, corr, products(p, vt, terms, shared=True)[0])
        m = mx
    out = o * (1.0 / l.clamp(min=1e-30))
    return out.reshape(B, H, S, DH)[..., :dh]


def _inputs(dh, S, seed, H=4, KVH=2):
    rng = np.random.default_rng([SEED, dh, S, seed])
    return [torch.from_numpy(rng.standard_normal((1, h, S, dh))
                             .astype(np.float32)) for h in (H, KVH, KVH)]


def _errors(dh, mask, terms, S=250):
    causal, window = MASKS[mask]
    q, k, v = _inputs(dh, S, list(MASKS).index(mask))
    exact = flash_attention_ref(q.double(), k.double(), v.double(),
                                causal=causal, window=window)
    plain = flash_attention_ref(q, k, v, causal=causal, window=window)
    emu = emulate(q, k, v, causal, window, terms)
    return emu.double() - exact, plain.double() - exact, exact


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("dh", [24, 64, 128, 256])
def test_3xtf32_meets_fp32_tolerance(dh, mask):
    """S = 250: a ragged last tile for 32- and 16-key tiles."""
    d_emu, d_plain, exact = _errors(dh, mask, terms=3)
    bound = TOL + TOL * exact.abs()
    assert (d_emu.abs() <= bound).all(), (
        f"3xTF32 beyond {TOL}: largest share "
        f"{(d_emu.abs() / bound).max().item():.3g}")
    e_emu, e_plain = d_emu.abs().max().item(), d_plain.abs().max().item()
    assert e_emu <= 4 * e_plain, (
        f"3xTF32 error {e_emu:.3g} against fp64 above 4x the fp32 plain "
        f"version's {e_plain:.3g}")


@pytest.mark.parametrize("dh", [64, 128, 256])
def test_one_tf32_product_misses_fp32_tolerance(dh):
    d_one, d_plain, exact = _errors(dh, "causal", terms=1)
    assert (d_one.abs() > TOL + TOL * exact.abs()).any()
    assert d_one.abs().max().item() > 4 * d_plain.abs().max().item()


def test_split_bits():
    """big is tf32 rounded to nearest (ties away), and big + small as the
    mma reads it is within 2^-21 of x."""
    rng = np.random.default_rng([SEED, 1])
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096),
        [0.0, 1.0, -1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12, -2 ** -20]])
        .astype(np.float32))
    big, small = split(x)
    assert (big.view(torch.int32) & 0x1FFF == 0).all()
    assert (small.view(torch.int32) & 0x1FFF == 0).all()
    # ties go away from zero; otherwise to the nearer tf32 neighbour
    assert tf32_rna(torch.tensor([1.0 + 2 ** -11])).item() == 1.0 + 2 ** -10
    assert tf32_rna(torch.tensor([-(1.0 + 2 ** -11)])).item() == -(
        1.0 + 2 ** -10)
    assert ((x - big).abs() <= 2 ** -11 * x.abs()).all()
    rest = (x.double() - big.double() - small.double()).abs()
    assert (rest <= 2 ** -21 * x.double().abs()).all()
