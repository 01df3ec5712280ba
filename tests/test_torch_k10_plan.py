"""K10's tier plan and the cluster tier's placement, on the CPU.

K10 (`csrc/segment_mean.cu`) sums α·δ of the envs at each (s, a) in env
order. `kernels.segment_mean.plan` picks, by shape, one launch of a
thread-block cluster or the four passes. The cluster tier places each env's
value by a stable counting sort of its own: each warp of a block counts a
contiguous range of the block's envs in a histogram of its own, 32 envs a
round, each env's rank its place among the warp's earlier envs of its key;
a scan over the warps gives each warp's offset and the block's histogram;
every block then scans all blocks' histograms in (segment, block) order.
`_placement` is a plain torch model of that placement; it must give what a
stable argsort of the keys gives.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from griduniverse_tpu_torch.kernels import segment_mean as sm

SMS = 132  # an H100 SXM's SMs
BUDGET = sm.BLOCK_SHARED_BYTES - sm.STATIC_SHARED_BYTES


def _keys(s, a, mask, num_actions, n_seg):
    """The kernel's `env_key`: s·A + a, or -1 where the mask is clear or the
    cell lies outside Q."""
    k = s.long() * num_actions + a.long()
    ok = (k >= 0) & (k < n_seg)
    if mask is not None:
        ok &= mask
    return torch.where(ok, k, -1)


def _placement(keys, n_seg: int, blocks: int):
    """The cluster tier's place of every env's value (-1 for an env with no
    key) and each segment's start in the sorted order, as the kernel builds
    them on `blocks` blocks."""
    b = keys.numel()
    per_block = -(-b // blocks)
    warps, lanes = sm.CLUSTER_WARPS, 32
    lane = torch.arange(lanes)
    w_of = torch.arange(warps)[:, None].expand(warps, lanes)
    hists = torch.zeros((blocks, n_seg), dtype=torch.int64)
    rank = torch.full((b,), -1, dtype=torch.int64)
    block_of = torch.full((b,), -1, dtype=torch.int64)
    for r in range(blocks):
        e0 = min(r * per_block, b)
        e1 = min(e0 + per_block, b)
        span = -(-(e1 - e0) // sm.CLUSTER_THREADS) * lanes  # envs a warp, a multiple of 32
        assert span // lanes <= sm.CLUSTER_ROUNDS
        hist = torch.zeros((warps, n_seg + 1), dtype=torch.int64)  # the last column takes the keyless lanes
        for j in range(span // lanes):
            env = e0 + torch.arange(warps)[:, None] * span + 32 * j + lane[None, :]
            inside = env < torch.clamp(e0 + (torch.arange(warps)[:, None] + 1) * span, max=e1)
            tile = torch.where(inside, keys[env.clamp(max=b - 1)], -1)
            col = torch.where(tile >= 0, tile, n_seg)
            peers = tile[:, :, None] == tile[:, None, :]  # __match_any_sync
            within = (peers & (lane[None, None, :] < lane[None, :, None])).sum(-1)  # popc(peers & below)
            leads = within == 0
            first = hist[w_of, col]  # the warp's count before the round, which the leader reads
            hist.index_put_((w_of[leads], col[leads]), peers.sum(-1)[leads], accumulate=True)
            rank[env[inside]] = (first + within)[inside]
            block_of[env[inside]] = r
        hist = hist[:, :n_seg]
        offset = hist.cumsum(0) - hist  # each warp's offset: its earlier warps' counts
        for w in range(warps):
            envs = torch.arange(min(e0 + w * span, e1), min(e0 + (w + 1) * span, e1))
            has = keys[envs] >= 0
            rank[envs[has]] += offset[w, keys[envs[has]]]
        hists[r] = hist.sum(0)
    # the scan every block makes: segment k's start, and block r's offset in it
    totals = hists.sum(0)
    start = torch.cat([torch.zeros(1, dtype=torch.int64), totals.cumsum(0)])
    off = start[None, :n_seg] + (hists.cumsum(0) - hists)
    has = keys >= 0
    place = torch.full((b,), -1, dtype=torch.int64)
    place[has] = off[block_of[has], keys[has]] + rank[has]
    return place, start


def _inputs(kind: str, b: int, num_states: int, num_actions: int, seed: int):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, num_states, b)
    a = rng.integers(0, num_actions, b)
    mask = None
    if kind == "skewed":  # most envs in a handful of cells
        s = np.where(rng.random(b) < 0.8, rng.integers(0, min(6, num_states), b), s)
    elif kind == "hot":
        hot = rng.random(b) < 0.9
        s, a = np.where(hot, num_states // 3, s), np.where(hot, 0, a)
    elif kind == "masked":
        mask = torch.from_numpy(rng.random(b) < 0.5)
    elif kind == "outside":  # cells beyond Q, and negative ones
        s = np.where(rng.random(b) < 0.2, num_states + rng.integers(0, 5, b), s)
        a = np.where(rng.random(b) < 0.05, -1, a)
    elif kind == "one segment":
        s, a = np.zeros(b, np.int64), np.zeros(b, np.int64)
    return torch.from_numpy(s).to(torch.int32), torch.from_numpy(a).to(torch.int32), mask


def _held(kind: str, b: int, num_states: int, num_actions: int, blocks: int, seed: int) -> None:
    s, a, mask = _inputs(kind, b, num_states, num_actions, seed)
    n_seg = num_states * num_actions
    keys = _keys(s, a, mask, num_actions, n_seg)
    place, start = _placement(keys, n_seg, blocks)
    has = keys >= 0
    # the places are 0..n-1, once each, and in a stable sort's order
    sorted_envs = torch.full((int(has.sum()),), -1, dtype=torch.int64)
    sorted_envs[place[has]] = torch.nonzero(has).view(-1)
    order = torch.argsort(torch.where(has, keys, n_seg), stable=True)[: int(has.sum())]
    assert torch.equal(sorted_envs, order)
    counts = torch.bincount(keys[has], minlength=n_seg)
    assert torch.equal(start, torch.cat([torch.zeros(1, dtype=torch.int64), counts.cumsum(0)]))


@pytest.mark.parametrize("blocks", range(1, 17))
@pytest.mark.parametrize("kind", ["random", "skewed", "hot", "masked", "outside", "one segment"])
def test_placement_is_a_stable_sort_at_every_cluster_size(kind, blocks):
    """Two tiles a block and a ragged last one, S·A = 324."""
    b = blocks * 1_500 + 7
    n_states, n_actions = (1, 1) if kind == "one segment" else (81, 4)
    _held(kind, b, n_states, n_actions, blocks, seed=blocks)


@pytest.mark.parametrize("blocks", [1, 3, 16])
@pytest.mark.parametrize("b", [1, 2, 33, 1024, 1025])
def test_placement_at_small_batches(b, blocks):
    """A single env, a warp and a tile's edge, with blocks left without envs."""
    _held("random", b, 81, 4, blocks, seed=b)
    _held("masked", b, 4, 1, blocks, seed=b + 1)


@pytest.mark.parametrize("blocks", [1, 4, 16])
def test_placement_with_more_segments_than_envs(blocks):
    """S·A = 2,048, the most a cluster block holds: most segments empty."""
    _held("random", 2_000, 512, 4, blocks, seed=blocks)


def test_placement_holds_eight_rounds_a_warp():
    """The cluster's most envs a block: 16 blocks of 8,192."""
    _held("skewed", 16 * sm.MAX_BLOCK_ENVS, 256, 4, 16, seed=5)


# ---------------------------------------------------------------------------
# The plan


def _every_shape():
    """The shapes the smoke, `td_run`, the MC learners and the sharded
    learners call K10 at: (batch, S·A)."""
    return [(b, 1024) for b in (1, 32, 4096, 65_536)] + [
        (25_600, 324), (25_600, 81), (102_400, 81), (51_200, 81), (12_800, 324),
        (32, 16_900), (4096, 16_900), (65_536, 16_900), (65_536, 81), (30_000, 40_000),
    ]


@pytest.mark.parametrize("batch,n_seg", _every_shape())
def test_plan_gives_every_path_shape_a_tier_within_the_card(batch, n_seg):
    p = sm.plan(batch, n_seg, SMS)
    assert p.tier in ("cluster", "passes")
    if p.tier == "cluster":
        assert 1 <= p.blocks <= sm.MAX_CLUSTER_BLOCKS and p.launches == 1
        assert sm.cluster_shared_bytes(n_seg) <= BUDGET and n_seg <= sm.MAX_CLUSTER_SEGMENTS
        assert -(-batch // p.blocks) <= sm.MAX_BLOCK_ENVS
    else:
        assert p == sm.PASSES == sm.Plan("passes", 0, 4)


def test_plan_at_the_paths_shapes():
    """One block for `td_run` up to 4,096 envs, 16 at 65,536 and at
    `mc_prediction`'s 102,400 samples, 7 at a round of `mc_control`."""
    assert sm.plan(4096, 1024, SMS) == sm.Plan("cluster", 1, 1)
    assert sm.plan(32, 1024, SMS).blocks == 1
    assert sm.plan(65_536, 1024, SMS).blocks == 16
    assert sm.plan(102_400, 81, SMS).blocks == 16
    assert sm.plan(25_600, 324, SMS).blocks == 7
    assert sm.plan(25_600, 81, SMS).blocks == 7
    assert sm.plan(30_000, 40_000, SMS).tier == "passes"  # the histograms outgrow a block
    assert sm.plan(65_536, 16_900, SMS).tier == "passes"


def test_plan_boundaries():
    """The largest call of a lone block and of each cluster size, and the
    first call of the passes, in the batch and in S·A."""
    for k in range(1, 16):
        assert sm.plan(sm.ENVS_A_BLOCK * k, 1024, SMS).blocks == k
        assert sm.plan(sm.ENVS_A_BLOCK * k + 1, 1024, SMS).blocks == k + 1
    assert sm.plan(16 * sm.MAX_BLOCK_ENVS, 1024, SMS).blocks == 16
    assert sm.plan(16 * sm.MAX_BLOCK_ENVS + 1, 1024, SMS).tier == "passes"
    most = max(n for n in range(1, 40_000) if sm.cluster_shared_bytes(n) <= BUDGET and n <= sm.MAX_CLUSTER_SEGMENTS)
    assert most == sm.MAX_CLUSTER_SEGMENTS == 2048
    for b, k in ((4096, 1), (65_536, 16)):
        assert sm.plan(b, most, SMS).blocks == k and sm.plan(b, most + 1, SMS).tier == "passes"


def test_plan_follows_the_cards_cluster_limit():
    """A card that holds clusters of at most eight blocks takes 65,536 envs
    on eight blocks of 8,192, and gives one env more to the passes."""
    assert sm.plan(65_536, 1024, SMS, 8).blocks == 8
    assert sm.plan(65_537, 1024, SMS, 8).tier == "passes"
    assert sm.plan(4096, 1024, SMS, 0).tier == "passes"
    assert sm.plan(65_536, 1024, 4).tier == "passes"  # four SMs: at most four blocks


def test_cluster_shared_bytes_holds_each_part():
    """The histogram, the offsets and the starts, and the region of the
    warps' histograms or the stage of two streamed chunks."""
    assert sm.cluster_shared_bytes(1024) == 2048 + 4096 + 4112 + 98_304
    assert sm.cluster_shared_bytes(2048) == 4096 + 8192 + 8208 + 196_608 <= BUDGET
    assert sm.cluster_shared_bytes(2200) > BUDGET
    assert sm.cluster_shared_bytes(81) == 176 + 336 + 336 + 65_536
    assert sm.stage_values(81) == 16_384
    assert sm.stage_values(1024) == 24_576


def test_plan_refuses_empty_calls():
    with pytest.raises(ValueError):
        sm.plan(0, 1024, SMS)
    with pytest.raises(ValueError):
        sm.plan(1, 0, SMS)
