"""The numerics of the fp32 mLSTM and the fp32 decode walk, emulated on
the CPU.

On the card both run on the tensor cores as 3xTF32, as fp32 flash does
(``tests/test_torch_flash_fp32.py`` emulates that one and holds the
split's bits): every fp32 operand x is split into big = x rounded to tf32
and small = x - big, read by the mma with its low 13 bits dropped, and a
product is small·big + big·small + big·big, accumulated in fp32.  This
file emulates each kernel's arithmetic with its tiling and accumulation
order and holds it to fp64:

- the mLSTM (``csrc/mlstm_chunkwise.cu``): the per-chunk pre-pass
  (``mlstm_local_f32``: the gates, q k^T as one fp32 fma chain a score,
  the local weights, nk in four quarter sums), the carries
  (``mlstm_scan_f32``: the m and n recurrences; ``mlstm_carry_f32``:
  q . n, the denominators, w', ci, a), and the column kernel
  (``mlstm_chunkwise_tf32``: q C per 16-column head-dim chunk summed into
  the pair partials, h = ci h_inter + w' v, the update from zero joined
  to C by one fma); against ``mlstm_parallel_f64`` from a fresh state and
  the plain loop run in fp64 from a given state, h, C, n and m within 2e-4
  (atol = rtol), on a ragged last chunk; and with large input gates,
  where the plain fp32 version is itself far from fp64, within 2e-4 of
  the plain version, which 3xTF32 scores miss;
- the decode walk (``csrc/decode_attend.cuh``, ``attend_tf32``): 8-key
  tiles, warp w of 4 taking tiles w, w+4, ... of its CTA's share, the
  score's big·big and small terms in accumulators of the k-steps mod 4,
  each tile's P·V from zero joined to O by one fma, the warps'
  partials merged (``merge_warps``) and the CTAs' (``merge_pair``);
  against an fp64 attention within 2e-5 on a split walk of a few hundred
  tokens with a masked tile, at g = 8 and g = 1;

each held to fp64 within 4x the plain fp32 version's own error (the
large-gates case to the plain version), while the
variant with one TF32 product a piece (big·big alone) misses the
tolerance.  The emulation is only here; no path of the port runs it.
``chip_smoke.py`` phase 2 holds the kernels themselves to the plain
versions and to fp64 on the card.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import (MLSTM_CHUNK, NEG_INF,
                                     mlstm_chunkwise_ref, mlstm_parallel_f64)
from test_torch_flash_fp32 import LOG2E, fma, split

SEED = 20261018
MLSTM_TOL = 2e-4
WALK_TOL = 2e-5
L = MLSTM_CHUNK


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: small eager loops, several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mma_terms(a, b, terms):
    """The (a, b) operand pairs of one product: 3xTF32's small·big,
    big·small, big·big, or big·big alone."""
    (ab, asm), (bb, bsm) = split(a), split(b)
    return [(asm, bb), (ab, bsm), (ab, bb)] if terms == 3 else [(ab, bb)]


def kstep_sum(acc, a, b, terms, k0=0, k1=None, small=None):
    """acc + a @ b over the 8-deep k-steps of [k0, k1), each step's
    products added in order; with ``small``, the small terms go to that
    accumulator instead.  Returns (acc, small)."""
    pairs = mma_terms(a, b, terms)
    for k in range(k0, a.shape[-1] if k1 is None else k1, 8):
        for i, (x, y) in enumerate(pairs):
            part = x[..., k:k + 8] @ y[..., k:k + 8, :]
            if small is not None and i < len(pairs) - 1:
                small = small + part
            else:
                acc = acc + part
    return acc, small


def fma_sum(w, x):
    """w @ x as a chain of fp32 fmas over the inner index, from zero."""
    acc = torch.zeros(w.shape[:-1] + x.shape[-1:])
    for s in range(w.shape[-1]):
        acc = fma(w[..., s:s + 1], x[..., s:s + 1, :], acc)
    return acc


def log_sigmoid(x):
    return torch.minimum(x, torch.zeros(())) - torch.log1p(torch.exp(-x.abs()))


# ------------------------------------------------------------ the mLSTM
def emulate_mlstm(q, k, v, i_pre, f_pre, state=None, terms=3,
                  scores="fma"):
    """The fp32 kernels' arithmetic on q, k, v (B,H,S,dh), i_pre, f_pre
    (B,H,S), from ``state`` (C, n, m) or a fresh one; ``scores="tf32x3"``
    takes q k^T as 3xTF32 k-steps instead of the kernel's fp32 chains."""
    B, H, S, dh = q.shape
    q, k, v = (t.reshape(B * H, S, dh) for t in (q, k, v))
    i_pre, f_pre = i_pre.reshape(B * H, S), f_pre.reshape(B * H, S)
    BH, nc = B * H, -(-S // L)
    if state is None:
        C = torch.zeros((BH, dh, dh))
        n = torch.zeros((BH, dh))
        m = torch.full((BH,), NEG_INF)
    else:
        C, n, m = (t.reshape(BH, *t.shape[2:]).float() for t in state)
    CT = C.transpose(-1, -2).contiguous()        # the kernel holds C^T

    def rows(x, t0):            # tokens t0 .. t0 + L, zeros past S
        x = x[:, t0:t0 + L]
        return torch.nn.functional.pad(
            x, (0, 0) * (x.dim() - 2) + (0, L - x.shape[1]))
    h = torch.zeros((BH, S, dh))
    tri = torch.ones((L, L), dtype=torch.bool).tril()
    for c in range(nc):
        t0 = c * L
        Lc = min(L, S - t0)
        qc, kc, vc = (rows(t, t0) for t in (q, k, v))
        valid = torch.arange(L) < Lc
        # ---- mlstm_local_f32: gates, q k^T, local weights, nk
        lf = torch.where(valid, log_sigmoid(rows(f_pre, t0)),
                         torch.zeros(()))
        ii = torch.where(valid, rows(i_pre, t0), torch.zeros(()))
        b = torch.cumsum(lf.double(), -1).float()     # in fp64, in order
        g = b[:, Lc - 1]
        D = (b[:, :, None] - b[:, None, :]) + ii[:, None, :]
        mi = torch.where(tri, D, torch.tensor(NEG_INF)).amax(-1)
        mi = torch.where(valid, mi, torch.zeros(()))
        sg = torch.where(valid, (g[:, None] - b) + ii, torch.tensor(NEG_INF))
        mloc = sg.amax(-1)
        u_s = torch.where(valid, torch.exp(sg - mloc[:, None]),
                          torch.zeros(()))
        if scores == "fma":                      # one chain a score
            sc = fma_sum(qc, kc.transpose(-1, -2))
        else:
            sc, _ = kstep_sum(torch.zeros((BH, L, L)), qc,
                              kc.transpose(-1, -2), 3)
        keep = tri & valid[:, None]
        wl = torch.where(keep, sc * torch.exp(D - mi[:, :, None]),
                         torch.zeros(()))
        quarters = [fma_sum(u_s[:, None, 16 * p:16 * p + 16],
                            kc[:, 16 * p:16 * p + 16])[:, 0]
                    for p in range(4)]
        nk = ((quarters[0] + quarters[1]) + quarters[2]) + quarters[3]
        # ---- mlstm_scan_f32 (m, n) and mlstm_carry_f32: q . n, the
        # denominators, w', ci, a, carry
        qn = (qc @ n[:, :, None])[..., 0]
        rsl = wl.sum(-1)
        mj = torch.maximum(b + m[:, None], mi)
        inter = torch.exp(b + m[:, None] - mj)
        scale = torch.exp(mi - mj)
        den = fma(inter, qn, scale * rsl)
        dn = torch.maximum(den.abs(), torch.exp(-mj))
        w2 = wl * torch.where(valid, scale / dn, torch.zeros(()))[:, :, None]
        ci = torch.where(valid, inter / dn, torch.zeros(()))
        mn = torch.maximum(g + m, mloc)
        carry = torch.exp(g + m - mn)
        ak = torch.exp(mloc - mn)
        a = torch.where(valid, u_s * ak[:, None], torch.zeros(()))
        n = fma(carry[:, None], n, ak[:, None] * nk)
        m = mn
        # ---- mlstm_chunkwise_tf32: h_inter^T by pairs, h, the update
        pairs = [torch.zeros((BH, dh, L)) for _ in range(8)]
        qT = qc.transpose(-1, -2)
        for cj in range(dh // 16):
            part, _ = kstep_sum(torch.zeros((BH, dh, L)), CT, qT, terms,
                                16 * cj, 16 * cj + 16)
            pairs[cj % 8] = pairs[cj % 8] + part
        hq = torch.zeros((BH, dh, L))
        for p in pairs:
            hq = hq + p
        wv = fma_sum(w2, vc)                                  # (BH, L, dh)
        hc = fma(ci[:, :, None], hq.transpose(-1, -2), wv)
        h[:, t0:t0 + Lc] = hc[:, :Lc]
        avT = (a[:, :, None] * vc).transpose(-1, -2)          # (BH, e, s)
        ubb, usm = kstep_sum(torch.zeros((BH, dh, dh)), avT, kc, terms,
                             small=torch.zeros((BH, dh, dh)))
        CT = fma(carry[:, None, None], CT, ubb + usm)
    return (h.reshape(B, H, S, dh),
            (CT.transpose(-1, -2).reshape(B, H, dh, dh), n.reshape(B, H, dh),
             m.reshape(B, H)))


def _mlstm_inputs(B, H, S, dh, seed, gates="normal"):
    rng = np.random.default_rng([SEED, B, H, S, dh, seed])
    x = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    q, k, v = x(B, H, S, dh), x(B, H, S, dh) / math.sqrt(dh), x(B, H, S, dh)
    i_pre, f_pre = x(B, H, S), x(B, H, S) + 3.0
    if gates == "big_i":
        i_pre = i_pre * 10.0 + 20.0
    return q, k, v, i_pre, f_pre


def _mlstm_case(case, terms, scores="fma"):
    """(emulation, plain fp32, fp64) outputs as flat lists of h, C, n, m."""
    B, H, S, dh, from_state, gates = case
    args = _mlstm_inputs(B, H, S, dh, 0, gates)
    state = None
    if from_state:
        first = _mlstm_inputs(B, H, 100, dh, 1)
        state = mlstm_chunkwise_ref(*(t.double() for t in first))[1]
    f32 = None if state is None else tuple(t.float() for t in state)
    emu = emulate_mlstm(*args, state=f32, terms=terms, scores=scores)
    plain = mlstm_chunkwise_ref(*args, state=f32)
    if state is None:
        h64, _, st64 = mlstm_parallel_f64(*args)
    else:
        h64, st64 = mlstm_chunkwise_ref(*(t.double() for t in args),
                                        state=state)
    flat = lambda o: [o[0], *o[1]]  # noqa: E731
    return flat(emu), flat(plain), [h64, *st64]


MLSTM_CASES = [(1, 2, 130, 64, False, "normal"),
               (1, 2, 130, 64, True, "normal"),
               (1, 1, 130, 256, False, "normal")]


@pytest.mark.parametrize("case", MLSTM_CASES, ids=str)
def test_mlstm_3xtf32_meets_fp32_tolerance(case):
    emu, plain, exact = _mlstm_case(case, terms=3)
    for name, e, p, x in zip("hCnm", emu, plain, exact):
        d_emu, d_plain = e.double() - x, p.double() - x
        bound = MLSTM_TOL + MLSTM_TOL * x.abs()
        assert (d_emu.abs() <= bound).all(), (
            f"{name}: 3xTF32 beyond {MLSTM_TOL}: largest share "
            f"{(d_emu.abs() / bound).max().item():.3g}")
        e_emu, e_plain = d_emu.abs().max().item(), d_plain.abs().max().item()
        assert e_emu <= 4 * e_plain + 1e-12, (
            f"{name}: 3xTF32 error {e_emu:.3g} against fp64 above 4x the "
            f"fp32 plain version's {e_plain:.3g}")


def test_mlstm_scores_as_fp32_chains_hold_large_input_gates():
    """Large input gates: the denominators cancel far below their terms
    and h amplifies the scores' error, so much that the plain fp32
    version is itself far from fp64.  The kernel's scores, one fp32 fma
    chain each, keep h, C, n and m within 2e-4 of the plain version, as
    the card holds the kernel; 3xTF32 scores put h past it."""
    case = (1, 1, 130, 256, False, "big_i")
    emu, plain, _ = _mlstm_case(case, terms=3)
    tf32, _, _ = _mlstm_case(case, terms=3, scores="tf32x3")
    for name, e, p in zip("hCnm", emu, plain):
        bound = MLSTM_TOL + MLSTM_TOL * p.abs()
        assert ((e - p).abs() <= bound).all(), (
            f"{name}: fp32 chains beyond {MLSTM_TOL} of the plain version")
    assert ((tf32[0] - plain[0]).abs()
            > MLSTM_TOL + MLSTM_TOL * plain[0].abs()).any(), (
        "3xTF32 scores met the tolerance")


def test_mlstm_one_tf32_product_misses_fp32_tolerance():
    emu, _, exact = _mlstm_case(MLSTM_CASES[0], terms=1)
    missed = [name for name, e, x in zip("hC", emu, exact)
              if ((e.double() - x).abs()
                  > MLSTM_TOL + MLSTM_TOL * x.abs()).any()]
    assert missed, "big·big alone met the tolerance"


# ------------------------------------------------------------ the walk
KEYS, WARPS, TILE = 8, 4, 32


def emulate_walk(q, k, v, valid, n_split, terms=3):
    """The fp32 walk of one (slot, KV head): q (g, dh), k/v (N, dh), valid
    (N,) bool, split over n_split CTAs -> (g, dh)."""
    g, dh = q.shape
    N = k.shape[0]
    DH = 64 if dh <= 64 else 128 if dh <= 128 else 256
    pad = lambda x: torch.nn.functional.pad(x, (0, DH - dh))  # noqa: E731
    q, k, v = pad(q), pad(k), pad(v)
    sl2 = torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    tiles = -(-N // TILE)
    per = -(-tiles // n_split)
    entries = []                                  # the CTAs' (po, M, L)
    for z in range(n_split):
        lo, hi = z * per * TILE, min((z + 1) * per * TILE, N)
        warps = []
        for w in range(WARPS):
            o = torch.zeros((g, DH))
            m = torch.full((g, 1), NEG_INF)
            l = torch.zeros((g, 1))
            for t0 in range(lo + w * KEYS, hi, WARPS * KEYS):
                ok = valid[t0:min(t0 + KEYS, hi)]
                ok = torch.nn.functional.pad(ok, (0, KEYS - ok.numel()))
                if not ok.any():
                    continue
                kt = torch.zeros((KEYS, DH))
                vt = torch.zeros((KEYS, DH))
                kt[ok] = k[t0:t0 + KEYS][ok[:min(KEYS, N - t0)]]
                vt[ok] = v[t0:t0 + KEYS][ok[:min(KEYS, N - t0)]]
                accs = [torch.zeros((g, KEYS)) for _ in range(8)]
                for kk in range(DH // 8):
                    h = kk % 4
                    accs[h], accs[4 + h] = kstep_sum(
                        accs[h], q, kt.T, terms, 8 * kk, 8 * kk + 8,
                        small=accs[4 + h])
                sc = (((accs[0] + accs[1]) + (accs[2] + accs[3]))
                      + ((accs[4] + accs[5]) + (accs[6] + accs[7])))
                sc = torch.where(ok, sc, torch.tensor(NEG_INF))
                mx = torch.maximum(m, sc.amax(-1, keepdim=True))
                corr = torch.exp2((m - mx) * sl2)
                p = torch.exp2(fma(sc, sl2, -(mx * sl2)))
                p = torch.where(ok, p, torch.zeros(()))
                l = l * corr + p.sum(-1, keepdim=True)
                pv, _ = kstep_sum(torch.zeros((g, DH)), p, vt, terms)
                o = fma(o, corr, pv)
                m = mx
            warps.append((o, m, l))
        # merge_warps: the largest m of the warps that saw a token
        M = torch.full((g, 1), NEG_INF)
        for o, m, l in warps:
            M = torch.where(l > 0, torch.maximum(M, m), M)
        po, Lz = torch.zeros((g, DH)), torch.zeros((g, 1))
        for o, m, l in warps:
            x = torch.where(l > 0, torch.exp2((m - M) * sl2), torch.zeros(()))
            Lz = fma(x, l, Lz)
            po = fma(x, o, po)
        entries.append((po, M * sl2, Lz))
    # merge_pair: every entry's weight against the largest m
    Mz = torch.full((g, 1), NEG_INF)
    for _, m2, l in entries:
        Mz = torch.where(l > 0, torch.maximum(Mz, m2), Mz)
    acc, den = torch.zeros((g, DH)), torch.zeros((g, 1))
    for po, m2, l in entries:
        w = torch.where(l > 0, torch.exp2(m2 - Mz), torch.zeros(()))
        den = fma(w, l, den)
        acc = fma(w, po, acc)
    return (acc * (1.0 / den))[:, :dh]


def _attention(q, k, v, valid, dtype):
    s = (q.to(dtype) / math.sqrt(q.shape[-1])) @ k.to(dtype).T
    s = torch.where(valid, s, torch.tensor(NEG_INF, dtype=dtype))
    return torch.softmax(s, -1) @ v.to(dtype)


def _walk_case(g, dh, terms):
    """A walk of 300 tokens in 3 shares, with a whole 8-key tile and
    scattered tokens masked: (emulation, plain fp32, fp64)."""
    rng = np.random.default_rng([SEED, g, dh])
    x = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    N = 300
    q, k, v = x(g, dh), x(N, dh), x(N, dh)
    valid = torch.from_numpy(rng.random(N) > 0.1)
    valid[40:48] = False                           # a masked tile
    k[~valid] = float("nan")                       # never read
    v[~valid] = float("nan")
    emu = emulate_walk(q, k, v, valid, 3, terms)
    kz, vz = k.nan_to_num(), v.nan_to_num()
    return (emu, _attention(q, kz, vz, valid, torch.float32),
            _attention(q, kz, vz, valid, torch.float64))


@pytest.mark.parametrize("dh", [128, 256])
@pytest.mark.parametrize("g", [8, 1])
def test_walk_3xtf32_meets_fp32_tolerance(g, dh):
    emu, plain, exact = _walk_case(g, dh, terms=3)
    d_emu, d_plain = emu.double() - exact, plain.double() - exact
    bound = WALK_TOL + WALK_TOL * exact.abs()
    assert torch.isfinite(emu).all()
    assert (d_emu.abs() <= bound).all(), (
        f"3xTF32 beyond {WALK_TOL}: largest share "
        f"{(d_emu.abs() / bound).max().item():.3g}")
    e_emu, e_plain = d_emu.abs().max().item(), d_plain.abs().max().item()
    assert e_emu <= 4 * e_plain, (
        f"3xTF32 error {e_emu:.3g} against fp64 above 4x the fp32 plain "
        f"version's {e_plain:.3g}")


@pytest.mark.parametrize("g", [8, 1])
def test_walk_one_tf32_product_misses_fp32_tolerance(g):
    emu, plain, exact = _walk_case(g, 128, terms=1)
    d_one, d_plain = emu.double() - exact, plain.double() - exact
    assert (d_one.abs() > WALK_TOL + WALK_TOL * exact.abs()).any()
    assert d_one.abs().max().item() > 4 * d_plain.abs().max().item()
