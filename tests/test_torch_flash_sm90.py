"""The host side and the schedule of the bf16 flash kernel, on the CPU.

On the card bf16 ``flash_attention`` runs ``flash_wgmma_kernel``
(``csrc/flash_attention.cu``): the Tensor Memory Accelerator loads q, k and
v through tensor maps built from the views' own strides
(``tma_geometry``), and each CTA takes a pair of 64-row query tiles (of
one head, or one tile of two heads) whose KV blocks its two consumer
warpgroups share out, a pair's stream perhaps split over several CTAs
(``tile_pair``, ``block_slot``, ``split_plan``).  The kernel runs only on
the card; here the geometry helper is held to the TMA's rules, and the
schedule, which the wrapper mirrors line by line from the CUDA source, is
held to cover every (query, key) pair the mask admits exactly once, to
write every query tile once, and to mask every block it does not flag as
an edge block nowhere.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import (BOX_COLS, KEY_TILE,
                                                 QUERY_TILE,
                                                 head_dim_bucket, pair_count,
                                                 split_plan, tile_blocks,
                                                 tile_pair, tma_geometry,
                                                 walk_steps)


def test_geometry_of_a_contiguous_tensor():
    t = torch.zeros((2, 4, 100, 128), dtype=torch.bfloat16)
    dims, strides, box = tma_geometry(t, 64)
    assert dims == (128, 100, 4, 2)
    assert strides == (256, 100 * 256, 4 * 100 * 256)
    assert box == (BOX_COLS, 64, 1, 1)


def test_geometry_of_the_transposed_projection_view():
    """``layers.full_attention`` passes q.transpose(1, 2) of a (B, S, H,
    dh) projection: S steps over every head, the heads over one row."""
    B, S, H, dh = 2, 37, 10, 24
    x = torch.zeros((B, S, H, dh), dtype=torch.bfloat16)
    dims, strides, box = tma_geometry(x.transpose(1, 2), 128)
    assert dims == (dh, S, H, B)
    assert strides == (H * dh * 2, dh * 2, S * H * dh * 2)
    assert box == (BOX_COLS, 128, 1, 1)


def test_geometry_gives_size_one_dims_the_packed_stride():
    t = torch.zeros((1, 1, 1, 8), dtype=torch.bfloat16).as_strided(
        (1, 1, 1, 8), (3, 5, 7, 1))
    dims, strides, _ = tma_geometry(t, 64)
    assert dims == (8, 1, 1, 1)
    assert strides == (16, 16, 16)


@pytest.mark.parametrize("what", ["S", "heads", "B"])
def test_geometry_raises_on_a_stride_off_16_bytes(what):
    # a (2, 3, 5, 8) view whose named dim steps 12 elements (24 bytes)
    sizes = (2, 3, 5, 8)
    strides = {"S": (3 * 5 * 16, 5 * 16, 12, 1),
               "heads": (3 * 5 * 16, 12 * 5, 16, 1),
               "B": (3 * 5 * 16 + 4, 5 * 16, 16, 1)}[what]
    base = torch.zeros(4096, dtype=torch.bfloat16)
    t = base.as_strided(sizes, strides)
    with pytest.raises(ValueError, match=f"the {what} stride .* not a "
                                         f"multiple of 16"):
        tma_geometry(t, 64)


def test_geometry_raises_on_a_strided_head_dim_and_an_odd_address():
    x = torch.zeros((1, 2, 4, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not contiguous"):
        tma_geometry(x.transpose(2, 3), 64)
    flat = torch.zeros(1 * 2 * 4 * 16 + 4, dtype=torch.bfloat16)
    t = flat[4:].view(1, 2, 4, 16)        # 8 bytes past an aligned start
    assert t.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16-byte aligned"):
        tma_geometry(t, 64)


def test_buckets_and_key_tiles():
    assert [head_dim_bucket(d) for d in (8, 64, 72, 128, 136, 256)] == [
        64, 64, 128, 128, 256, 256]
    assert set(KEY_TILE) == {64, 128, 256} and QUERY_TILE == 64


# ---- the schedule (the wrapper's mirror of csrc/flash_attention.cu)
def edge(q0, k0, S, BK, causal, window):
    """csrc ``mask_block``: does block k0 need the mask for tile q0?"""
    q_last = min(q0 + QUERY_TILE - 1, S - 1)
    return (k0 + BK > S or (causal and k0 + BK - 1 > q0)
            or (window > 0 and q_last - k0 >= window))


def walk_block(r, walk, i):
    """csrc ``make_walk`` + ``walk_block``: the block of step i of walk 0
    (warpgroup 0, slot 0), 1 (warpgroup 0's share of slot 1) or 2
    (warpgroup 1, the rest of slot 1)."""
    a = r["first"][0] if walk == 0 else r["first"][1]
    pre = r["n"][0] if walk == 0 else 0 if walk == 1 else (
        r["bo0"] - r["first"][1])
    b = r["bo0"] if walk == 1 else r["bo0"] + 1
    alt = 0 if walk == 0 else r["moved"]
    c = r["bo0"] + 2 * r["moved"]
    if i < pre:
        return a + i
    if i < pre + alt:
        return b + 2 * (i - pre)
    return c + (i - pre - alt)


MASKS = ((True, 0), (True, 40), (True, 256), (True, 2048), (False, 0),
         (False, 100))
CASES = [(S, BK, causal, window, pieces, False)
         for S in (1, 63, 64, 65, 127, 128, 129, 1000, 1500)
         for BK in (64, 128) for causal, window in MASKS for pieces in (1, 3)]
CASES += [(S, BK, causal, window, pieces, True)
          for S in (1, 65, 129, 1000) for BK in (64, 128)
          for causal, window in MASKS for pieces in (1, 2)]


@pytest.mark.parametrize("S,BK,causal,window,pieces,head_pairs", CASES)
def test_schedule_covers_every_admitted_pair_once(S, BK, causal, window,
                                                  pieces, head_pairs):
    """Every pair whole, or split into pieces; tiles paired in one head or
    across a head pair: the warpgroups' walks cover each admitted (query,
    key) pair of each head exactly once, go through the stream in order
    inside each piece's share, skip at most one block at a time after
    their first (the kernel acknowledges a skipped block's V only once the
    previous block's V stage is free), leave no streamed block unused,
    and every block they do not flag as an edge block is admitted
    whole."""
    pos = torch.arange(S)
    admit = torch.ones((S, S), dtype=torch.bool)
    if causal:
        admit &= pos[:, None] >= pos[None, :]
    if window > 0:
        admit &= pos[:, None] - pos[None, :] < window
    # one head, or the two heads of a head pair (slot s is head s)
    seen = torch.zeros((2 if head_pairs else 1, S, S), dtype=torch.int32)
    tiles = [[] for _ in seen]
    nq = -(-S // QUERY_TILE)
    for p in range(pair_count(S, head_pairs)):
        for piece in range(pieces):
            r = tile_pair(p, nq, S, BK, causal, window, piece, pieces,
                          head_pairs)
            if piece == 0:
                for slot, t in enumerate(r["t"]):
                    if t >= 0:
                        tiles[slot if head_pairs else 0].append(t)
            walks = {0: [(0, 0), (1, 1)], 1: [(2, 1)]}
            used = set()
            for wg, plan in walks.items():
                blocks = []
                for walk, slot in plan:
                    n = r["n"][0] if walk == 0 else (
                        r["moved"] if walk == 1 else r["n"][1] - r["moved"])
                    for i in range(n):
                        j = walk_block(r, walk, i)
                        assert r["s0"] <= j <= r["s1"]
                        blocks.append((j, slot))
                assert len(blocks) == walk_steps(r, wg)
                js = [j for j, _ in blocks]
                assert js == sorted(set(js))
                assert all(b - a <= 2 for a, b in zip(js, js[1:]))
                used.update(js)
                for j, slot in blocks:
                    q0, k0 = r["t"][slot] * QUERY_TILE, j * BK
                    qs = slice(q0, min(q0 + QUERY_TILE, S))
                    ks = slice(k0, min(k0 + BK, S))
                    seen[slot if head_pairs else 0, qs, ks] += admit[
                        qs, ks].int()
                    if not edge(q0, k0, S, BK, causal, window):
                        assert admit[qs, ks].all() and k0 + BK <= S
            assert used == set(range(r["s0"], r["s1"] + 1))
    for ts in tiles:
        assert sorted(ts) == list(range(nq))
    for head in seen:
        assert torch.equal(head, admit.int())


def test_complementary_pairs_even_out_a_causal_prompt():
    """Causal pairs p, nq-1-p: at qwen2.5-3b's S 1024 (16 tiles, 128-key
    blocks) each warpgroup walks 4 or 5 blocks, where the longest tile
    alone reaches 8."""
    nq = 16
    for p in range(8):
        r = tile_pair(p, nq, 1024, 128, True, 0)
        assert {walk_steps(r, 0), walk_steps(r, 1)} <= {4, 5}
    assert tile_blocks(15, 1024, 128, True, 0) == (0, 7)


def test_split_plan():
    """Equal complementary pairs that fill at most one wave are never
    split (qwen2-moe's 128 CTAs, stablelm's, a short prompt); 160 equal
    pairs on 132 SMs (recurrentgemma-2b's dh 256 without head pairs)
    would end on a partial second wave, and head pairs' longest tiles
    outlast the rest (qwen2.5-3b, recurrentgemma-2b): some are split into
    pieces, in at most four waves of CTAs."""
    assert split_plan(16, 1024, 128, True, 0, False, 132) == (0, 1)
    assert split_plan(32, 512, 128, True, 0, False, 132) == (0, 1)
    assert split_plan(4, 100, 128, True, 0, False, 132) == (0, 1)
    for ctas, S, BK, window, heads in ((10, 2048, 64, 2048, False),
                                       (5, 2048, 64, 2048, True),
                                       (8, 1024, 128, 0, True)):
        split, pieces = split_plan(ctas, S, BK, True, window, heads, 132)
        assert split > 0 and pieces > 1
        assert (pair_count(S, heads) + split * (pieces - 1)) * ctas <= 4 * 132
