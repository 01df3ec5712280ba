"""Port parity: Aldous–Broder maze generation (K3's plain version).

With the reference's per-step draws (`randint(fold_in(key, t), (B,), 0, 4)`)
injected, `aldous_broder_mazes_reference` must give the reference's grids
bit for bit, including when the cap cuts the walks short and the safety
net fires. The seeded mode has its own stream, so it is held to what the
algorithm promises: perfect mazes, exactly uniform over spanning trees.
The backtracker's plain version (K11's) is held to the reference's texture
and to the law of a depth-first walk. At the end, both kernels are walked
literally in numpy, thread by thread, and held bit for bit against their
plain versions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from griduniverse_tpu.levels import maze as jm
from griduniverse_tpu_torch.core import semantics as S
from griduniverse_tpu_torch.kernels import maze as km
from griduniverse_tpu_torch.levels import maze as tm

torch.set_num_threads(1)
CPU = torch.device("cpu")


def jax_directions(key, batch, steps):
    """The reference's direction draws, (steps, batch) int8."""
    draw = jax.vmap(lambda t: jax.random.randint(jax.random.fold_in(key, t), (batch,), 0, 4, jnp.int32))
    return torch.as_tensor(np.array(draw(jnp.arange(steps))).astype(np.int8))


@pytest.mark.parametrize(
    "seed,cells,b,max_iters",
    [
        (5, (4, 4), 64, 2000),
        (6, (3, 5), 32, 1500),
        (8, (2, 2), 64, 200),
        (4, (5, 5), 32, 20),   # truncated: the safety net fires
        (9, (6, 4), 16, 150),  # truncated at a larger size
    ],
)
def test_injected_directions_match_jax(seed, cells, b, max_iters):
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jm._aldous_broder_mazes(key, cells, b, max_iters=max_iters))
    dirs = jax_directions(key, b, max_iters)
    got = tm.aldous_broder_mazes_reference(cells, b, max_iters, directions=dirs)
    np.testing.assert_array_equal(ref, got.numpy())
    # the public function takes the plain version for CPU tensors
    assert torch.equal(tm._aldous_broder_mazes(cells, b, max_iters, directions=dirs), got)
    assert all(tm.check_perfect_maze(g, cells) for g in got)


def test_default_cap_is_the_reference_formula():
    assert tm._ab_default_max_iters(16) == 64 * 16 * 4 * 4
    assert tm._ab_default_max_iters(256) == 64 * 256 * 8 * 8
    assert tm._ab_default_max_iters(15) == 64 * 15 * 4 * 4
    assert tm._ab_default_max_iters(2) == 64 * 2


def _fmix32(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def test_seeded_streams_are_the_kernels_hash():
    """maze_stream_init is the hash K3 computes in-kernel."""
    for seed in (0, 99, 2**32 - 1):
        got = tm.maze_stream_init(seed, 300, device=CPU).tolist()
        want = [_fmix32((b * 0x9E3779B9 + seed) & 0xFFFFFFFF) | 1 for b in range(300)]
        assert got == want


@pytest.mark.parametrize("cells", [(4, 4), (3, 5), (6, 6), (1, 4)])
def test_seeded_mazes_are_perfect(cells):
    b = 128
    grids, start = tm.generate_mazes_device(17, cells, b, "aldous_broder", device=CPU)
    s = cells[0] * cells[1]
    n_open = (grids != S.WALL).sum(dim=(1, 2))
    assert bool((n_open == 2 * s - 1).all())
    assert int(start) == 2 * cells[1] + 2
    assert all(tm.check_perfect_maze(g, cells) for g in grids)
    flat = grids.reshape(b, -1)
    assert len({tuple(r.tolist()) for r in flat}) > 4 or s <= 4


def test_exactly_uniform_on_2x2():
    """The 2x2 cell graph has exactly 4 spanning trees; the seeded walks
    must hit each with probability 1/4 (bound at 5 sigma, as the
    reference's own test)."""
    b = 4096
    grids, _ = tm.generate_mazes_device(8, (2, 2), b, "aldous_broder", device=CPU)
    g = grids.numpy()
    walls = np.stack([g[:, 2, 1], g[:, 2, 3], g[:, 1, 2], g[:, 3, 2]], axis=1)
    open_mask = walls != S.WALL
    assert (open_mask.sum(axis=1) == 3).all()
    counts = np.bincount(np.argmin(open_mask, axis=1), minlength=4)
    sigma = np.sqrt(b * 0.25 * 0.75)
    assert np.all(np.abs(counts - b / 4) < 5 * sigma), counts


def test_no_forced_corridors():
    b, cells = 256, (5, 5)
    g, _ = tm.generate_mazes_device(9, cells, b, "aldous_broder", device=CPU)
    g = g.numpy()
    cols = np.arange(1, cells[1]) * 2
    assert np.all((g[:, 1, cols] != S.WALL).mean(axis=0) < 0.95)
    rows = np.arange(1, cells[0]) * 2
    assert np.all((g[:, rows, 1] != S.WALL).mean(axis=0) < 0.95)


def test_injected_directions_are_checked():
    with pytest.raises(ValueError):
        tm.aldous_broder_mazes_reference((3, 3), 4, 10, directions=torch.zeros((9, 4), dtype=torch.int8))
    with pytest.raises(ValueError):
        tm.aldous_broder_mazes_reference((3, 3), 4, 10, directions=torch.zeros((10, 5), dtype=torch.int8))


# ---------------------------------------------------------------------------
# K11's plain version: the device backtracker
# ---------------------------------------------------------------------------


def _dead_ends(grids: np.ndarray) -> np.ndarray:
    """Dead ends per maze: cells with exactly one open passage."""
    open_ = grids != S.WALL
    cells = open_[:, 1::2, 1::2]
    exits = (open_[:, 0:-2:2, 1::2].astype(int) + open_[:, 2::2, 1::2] + open_[:, 1::2, 0:-2:2] + open_[:, 1::2, 2::2])
    return ((exits == 1) & cells).sum(axis=(1, 2))


@pytest.mark.parametrize("cells", [(4, 4), (3, 5), (1, 4), (1, 1), (16, 16)])
def test_backtracker_mazes_are_perfect(cells):
    b = 16 if cells == (16, 16) else 128
    grids, start = tm.generate_mazes_device(17, cells, b, device=CPU)  # the default algorithm
    h, w = 2 * cells[0] + 1, 2 * cells[1] + 1
    assert grids.shape == (b, h, w) and grids.dtype == torch.int32
    s = cells[0] * cells[1]
    assert bool(((grids != S.WALL).sum(dim=(1, 2)) == 2 * s - 1).all())
    assert int(start) == w + 1 and bool((grids[:, h - 2, w - 2] == S.GOAL).all())
    assert bool((grids[:, 1, 1] != S.WALL).all())
    assert all(tm.check_perfect_maze(g, cells) for g in grids)
    assert len({tuple(r.tolist()) for r in grids.reshape(b, -1)}) > 4 or s <= 4
    again, _ = tm.generate_mazes_device(17, cells, b, "backtracker", device=CPU)
    assert torch.equal(grids, again)


def test_backtracker_law_on_2x2():
    """A depth-first walk from the start cell of the 2x2 lattice is one of
    two paths, so of the four spanning trees only the two that lack an edge
    AT the start cell occur, each with probability 1/2 (5 sigma)."""
    b = 4096
    grids, _ = tm.generate_mazes_device(8, (2, 2), b, "backtracker", device=CPU)
    g = grids.numpy()
    walls = np.stack([g[:, 2, 1], g[:, 2, 3], g[:, 1, 2], g[:, 3, 2]], axis=1)  # W-col, E-col, N-row, S-row
    open_mask = walls != S.WALL
    assert (open_mask.sum(axis=1) == 3).all()
    counts = np.bincount(np.argmin(open_mask, axis=1), minlength=4)
    # the start cell (0, 0) touches the west column's wall (index 0) and the north row's (index 2)
    assert counts[1] == 0 and counts[3] == 0
    assert abs(counts[0] - b / 2) < 5 * np.sqrt(b * 0.25), counts


def test_backtracker_texture_matches_jax():
    """Dead ends a maze over 2,048 mazes of 4x4 cells: the mean within 0.12
    of the JAX backtracker's (about 5 standard errors of the difference of
    two such means), and well under Aldous-Broder's, whose uniform trees
    branch more."""
    b, cells = 2048, (4, 4)
    jgrids, _ = jm.generate_mazes_device(jax.random.PRNGKey(0), cells, b, "backtracker")
    want = _dead_ends(np.asarray(jgrids))
    got = _dead_ends(tm.generate_mazes_device(3, cells, b, "backtracker", device=CPU)[0].numpy())
    uniform = _dead_ends(tm.generate_mazes_device(3, cells, b, "aldous_broder", device=CPU)[0].numpy())
    se = np.sqrt(want.var() / b + got.var() / b)
    assert abs(got.mean() - want.mean()) < max(0.12, 5 * se), (got.mean(), want.mean(), se)
    assert got.mean() < uniform.mean() - 1.0


def test_neighbour_orders_are_the_kernels_table():
    """K11 holds the 24 orders packed two bits a place, first place lowest."""
    packed = [sum(d << (2 * k) for k, d in enumerate(p)) for p in tm.NEIGHBOUR_ORDERS]
    assert packed[:4] == [0xE4, 0xB4, 0xD8, 0x78] and packed[-1] == 0x1B
    assert sorted(set(tm.NEIGHBOUR_ORDERS)) == list(tm.NEIGHBOUR_ORDERS) and len(packed) == 24
    import re
    from pathlib import Path

    src = (Path(tm.__file__).resolve().parent.parent / "csrc" / "backtracker.cu").read_text()
    table = re.search(r"kOrders\[24\] = \{([^}]*)\}", src).group(1)
    assert [int(v, 16) for v in re.findall(r"0x[0-9A-Fa-f]{2}", table)] == packed


def test_unknown_algorithm_raises():
    with pytest.raises(ValueError, match="unknown maze algorithm"):
        tm.generate_mazes_device(0, (2, 2), 4, "prim", device=CPU)


# ---------------------------------------------------------------------------
# K3's and K11's kernels walked literally (`csrc/maze_tree.cuh`, `maze.cu`,
# `backtracker.cu`): the nibble trees in a block's shared memory, ⌈cw/8⌉
# words a row, word k of the block's maze m at k·M + m; K11 without a stack,
# its pick read from the 64-bit word of its order; K3's walk in blocks of 16
# steps with its safety net; the trees turned into wall bits in place, row
# by row; the block's 128 threads' 16-byte stores front to back over its
# grids, each from the windows of the (at most two) rows its tiles lie in,
# the region's lead (before its first 16-byte boundary, where M is not a
# multiple of 4) and tail written plainly. Every maze is one thread and every
# thread of the writer one numpy element, so each step below is what one
# thread does.
# ---------------------------------------------------------------------------

_U32_MAX = np.uint32(0xFFFFFFFF)
_STAY = 4
_THREADS = 128


def _pick_words():
    """For each of the 24 orders: bits 3F .. 3F + 2 hold the first direction
    of the order whose bit is set in F, or 4 (K11's table)."""
    words = []
    for order in tm.NEIGHBOUR_ORDERS:
        v = 0
        for f in range(16):
            first = next((d for d in order if (f >> d) & 1), 4)
            v |= first << (3 * f)
        words.append(v)
    return np.array(words, np.uint64)


class _SharedTrees:
    """The blocks' dynamic shared memory: word k of maze b at
    block·(n·M) + k·M + slot, n = ch·⌈cw/8⌉ words a maze."""

    def __init__(self, cells, batch, mazes):
        self.ch, self.cw = cells
        self.wpr = -(-self.cw // 8)
        self.n = self.ch * self.wpr
        self.m = mazes
        self.blocks = -(-batch // self.m)
        self.mem = np.full(self.blocks * self.n * self.m, 0xDEADBEEF, np.uint32)  # never read before written
        b = np.arange(batch)
        self.base = (b // self.m) * self.n * self.m + b % self.m

    def addr(self, k, rows=slice(None)):
        return self.base[rows] + np.asarray(k) * self.m

    def cell(self, r, c, rows=slice(None)):
        """Address of the word that holds cell (r, c), and the cell's shift."""
        return self.addr(np.asarray(r) * self.wpr + (np.asarray(c) >> 3), rows), (np.asarray(c) & 7) * 4


def _nib(word, shift):
    return (word >> np.asarray(shift).astype(np.uint32)) & np.uint32(0xF)


def _tree_init(sh: _SharedTrees):
    for k in range(1, sh.n):
        sh.mem[sh.addr(k)] = _U32_MAX
    sh.mem[sh.addr(0)] = np.uint32(0xFFFFFFF4)


def _xorshift(x):
    x = x ^ (x << np.uint32(13))
    x = x ^ (x >> np.uint32(17))
    return x ^ (x << np.uint32(5))


def _streams(seed, batch):
    return tm.maze_stream_init(seed, batch, device=CPU).numpy().astype(np.uint32)


def _k11_walk(sh: _SharedTrees, cells, batch, seed):
    ch, cw = cells
    _tree_init(sh)
    pick = _pick_words()
    x = _streams(seed, batch)
    r = np.zeros(batch, np.int64)
    c = np.zeros(batch, np.int64)
    for _ in range(2 * ch * cw - 1):
        x = _xorshift(x)
        table = pick[((x >> np.uint32(16)) * np.uint32(24)) >> np.uint32(16)]
        at, shift = sh.cell(r, c)
        in_n, in_s, in_w, in_e = r > 0, r < ch - 1, c > 0, c < cw - 1
        w_edge, e_edge = (c & 7) == 0, (c & 7) == 7

        def load(cond, offset):  # a predicated load at a word's offset from the cell's
            return np.where(cond, sh.mem[np.where(cond, at + offset, 0)], np.uint32(0))

        w_c = sh.mem[at]
        w_n, w_s = load(in_n, -sh.wpr * sh.m), load(in_s, sh.wpr * sh.m)
        w_w = np.where(w_edge & in_w, load(w_edge & in_w, -sh.m), w_c)
        w_e = np.where(e_edge & in_e, load(e_edge & in_e, sh.m), w_c)
        sh_w, sh_e = (shift - 4) & 31, (shift + 4) & 31
        fresh = ((in_n & (_nib(w_n, shift) == 0xF)) * 1 | (in_e & (_nib(w_e, sh_e) == 0xF)) * 2
                 | (in_s & (_nib(w_s, shift) == 0xF)) * 4 | (in_w & (_nib(w_w, sh_w) == 0xF)) * 8)
        d_push = ((table >> (3 * fresh).astype(np.uint64)) & np.uint64(7)).astype(np.int64)
        push = d_push < 4
        t_at = np.select([d_push == 0, d_push == 1, d_push == 2],
                         [at - sh.wpr * sh.m, np.where(e_edge, at + sh.m, at), at + sh.wpr * sh.m],
                         np.where(w_edge, at - sh.m, at))
        w_t = np.select([d_push == 0, d_push == 1, d_push == 2], [w_n, w_e, w_s], w_w)
        sh_t = np.select([d_push == 1, d_push == 3], [sh_e, sh_w], shift)
        marked = w_t ^ ((np.uint32(0xF) ^ ((d_push + 2) & 3).astype(np.uint32)) << sh_t.astype(np.uint32))
        sh.mem[t_at[push]] = marked[push]
        d = np.where(push, d_push, _nib(w_c, shift).astype(np.int64))  # pop: the way to the parent (4 at the root)
        r = r + np.select([d == 0, d == 2], [-1, 1], 0)
        c = c + np.select([d == 1, d == 3], [1, -1], 0)
    assert (r == 0).all() and (c == 0).all()  # the last pop left the root


def _k3_walk(sh: _SharedTrees, cells, batch, max_iters, dirs=None, seed=0):
    """K3's pipelined walk: step t + 1 is prepared (moved, its word loaded)
    before step t is finished (tested, marked), and the finish forwards the
    one store its load may have missed."""
    ch, cw = cells
    s = ch * cw
    _tree_init(sh)
    r = np.zeros(batch, np.int64)
    c = np.zeros(batch, np.int64)
    n_visited = np.ones(batch, np.int64)
    at_prev = np.full(batch, -1)
    stored = np.zeros(batch, np.uint32)

    def direction(t, x):
        if t >= max_iters:
            return np.full(batch, _STAY)
        if dirs is not None:  # zero-extended bytes, loaded a block ahead
            return dirs[t].astype(np.uint8).astype(np.int64)
        return (x >> np.uint32(30)).astype(np.int64)

    def prepare(d):
        nonlocal r, c
        nr = r + np.select([d == 0, d == 2], [-1, 1], 0)
        nc = c + np.select([d == 1, d == 3], [1, -1], 0)
        ok = (nr >= 0) & (nr < ch) & (nc >= 0) & (nc < cw)  # the two unsigned compares
        r, c = np.where(ok, nr, r), np.where(ok, nc, c)
        at, shift = sh.cell(r, c)
        mask = (np.uint32(0xF) ^ ((d + 2) & 3).astype(np.uint32)) << shift.astype(np.uint32)
        return at, shift, sh.mem[at], mask

    x = _xorshift(_streams(seed, batch))
    prepared = prepare(direction(0, x))
    t0 = 0
    while True:
        walking = (n_visited < s) & (t0 < max_iters)
        if not walking.any():
            break
        for k in range(16):  # finishes step t0 + k
            x = np.where(walking, _xorshift(x), x)
            at, shift, raw, mask = prepared
            prepared = prepare(direction(t0 + k + 1, x))  # loaded before the store below
            word = np.where(at == at_prev, stored, raw)
            fresh = walking & (_nib(word, shift) == 0xF)
            sh.mem[at[fresh]] = (word ^ mask)[fresh]
            n_visited += fresh
            at_prev = np.where(walking, np.where(fresh, at, -1), at_prev)
            stored = np.where(walking, word ^ mask, stored)
        t0 += 16
    for rr in range(ch):  # the safety net, a word at a time
        for j in range(sh.wpr):
            word = sh.mem[sh.addr(rr * sh.wpr + j)]
            for k in range(8):
                if 8 * j + k < cw:
                    hole = _nib(word, 4 * k) == 0xF
                    word = np.where(hole, word ^ (np.uint32(0xF ^ (0 if rr > 0 else 3)) << np.uint32(4 * k)), word)
            sh.mem[sh.addr(rr * sh.wpr + j)] = word


def _nibbles_equal(x, v):
    t = x ^ np.uint32(v * 0x11111111)
    return ~(((t & np.uint32(0x77777777)) + np.uint32(0x77777777)) | t) & np.uint32(0x88888888)


def _compress8(z):
    x = z >> np.uint32(3)
    x = (x | (x >> np.uint32(3))) & np.uint32(0x03030303)
    x = (x | (x >> np.uint32(6))) & np.uint32(0x000F000F)
    return (x | (x >> np.uint32(12))) & np.uint32(0xFF)


def _tree_to_walls(sh: _SharedTrees):
    for r in reversed(range(sh.ch)):
        for j in range(-(-sh.cw // 16)):
            north = west = np.uint32(0)
            for half in range(2):
                t = 2 * j + half
                if t >= sh.wpr:
                    break
                own = sh.mem[sh.addr(r * sh.wpr + t)]
                above = sh.mem[sh.addr((r - 1) * sh.wpr + t)] if r > 0 else np.full(len(sh.base), _U32_MAX)
                prev = sh.mem[sh.addr(r * sh.wpr + t - 1)] >> np.uint32(28) if t > 0 else np.uint32(0xF)
                left = (own << np.uint32(4)) | prev
                north = north | (_compress8(_nibbles_equal(own, 0) | _nibbles_equal(above, 2)) << np.uint32(8 * half))
                west = west | (_compress8(_nibbles_equal(own, 3) | _nibbles_equal(left, 1)) << np.uint32(8 * half))
            sh.mem[sh.addr(r * sh.wpr + j)] = north | (west << np.uint32(16))


def _write_grids(sh: _SharedTrees, cells, batch):
    """Every block's threads at once: (flat int32 grids, writes of each int)."""
    ch, cw = cells
    h, w = 2 * ch + 1, 2 * cw + 1
    hw = h * w
    out = np.full(batch * hw, -1, np.int64)
    writes = np.zeros(batch * hw, np.int64)
    base = np.arange(sh.blocks) * sh.m                 # each block's first maze
    nm = np.minimum(sh.m, batch - base)
    lead = np.minimum((-(base * hw)) & 3, nm * hw)     # int32 before the region's first 16-byte boundary
    assert (((base * hw + lead) * 4) % 16 == 0).all()
    assert sh.m % 4 != 0 or (lead == 0).all()
    n4 = (nm * hw - lead) >> 2
    t = np.arange(_THREADS)[None, :]
    word0 = (np.arange(sh.blocks) * sh.n * sh.m)[:, None]
    i0 = lead[:, None] + 4 * t
    m = i0 // hw
    gr = (i0 - m * hw) // w
    gc = i0 - m * hw - gr * w
    rows = 4 * _THREADS // w
    step_c, step_r, step_m = 4 * _THREADS - rows * w, rows % h, rows // h

    def window(mm, rr, c0, live):
        """Bits of cells c0 .. c0 + 2 of grid row rr's walls (north on even rows, west on odd)."""
        r_, j, shift = rr >> 1, c0 >> 4, c0 & 15
        valid = live & (r_ < ch) & (c0 < cw)
        at = word0 + np.where(valid, r_ * sh.wpr + j, 0) * sh.m + mm
        lo = np.where(valid, sh.mem[np.where(valid, at, 0)], 0).astype(np.int64)
        second = valid & (shift > 13) & (16 * (j + 1) < cw)
        hi = np.where(second, sh.mem[np.where(second, at + sh.m, 0)], 0).astype(np.int64)
        half = 16 * (rr & 1)  # __byte_perm: the two low halves (0x5410) or the two high (0x7632)
        both = ((lo >> half) & 0xFFFF) | (((hi >> half) & 0xFFFF) << 16)
        return (both >> shift) & 7

    def wall_mask(bits, odd_r, odd_c):
        """Bit e: tile e of four from a tile of column parity odd_c is WALL."""
        first = odd_r != odd_c
        used = np.where(first, bits, bits >> odd_c) & 3
        shut = (~used & 1) | ((~used & 2) << 1)
        return np.where(first, shut, shut << 1) | np.where(odd_r == 1, 0, np.where(first, 0xA, 0x5))

    def one_tile(mm, rr, cc, live):
        walled = wall_mask(window(mm, rr, cc >> 1, live), rr & 1, cc & 1) & 1
        return np.where((rr == h - 2) & (cc == w - 2), S.GOAL, np.where(walled == 1, S.WALL, S.EMPTY))

    for it in range(int(n4.max() + _THREADS - 1) // _THREADS):
        q = t + _THREADS * it
        live = q < n4[:, None]
        v = np.zeros((4,) + m.shape, np.int64)
        if cw > 1:  # the tiles lie in this row and at most the next
            k = w - gc
            walls4 = wall_mask(window(m, gr, gc >> 1, live), gr & 1, gc & 1)
            wraps = gr + 1 == h
            gr2 = np.where(wraps, 0, gr + 1)
            nxt = wall_mask(window(np.where(wraps, m + 1, m), gr2, np.zeros_like(gc), live & (k < 4)), gr2 & 1, 0)
            merged = (walls4 & ((1 << np.minimum(k, 4)) - 1)) | ((nxt << np.minimum(k, 4)) & 0xF)
            walls4 = np.where(k < 4, merged, walls4)
            goal = np.where(gr == h - 2, w - 2 - gc, -1)
            for e in range(4):
                v[e] = np.where(goal == e, S.GOAL, np.where((walls4 >> e) & 1 == 1, S.WALL, S.EMPTY))
        else:  # one cell a row: tile by tile
            mm, rr, cc = m.copy(), gr.copy(), gc.copy()
            for e in range(4):
                v[e] = one_tile(mm, rr, cc, live)
                cc = cc + 1
                wrap = cc == w
                cc, rr = np.where(wrap, 0, cc), rr + wrap
                wrap = rr == h
                rr, mm = np.where(wrap, 0, rr), mm + wrap
        for e in range(4):
            at_out = (base[:, None] * hw + lead[:, None] + 4 * q + e)[live]
            out[at_out] = v[e][live]
            writes[at_out] += 1
        gc = gc + step_c
        carry = gc >= w
        gc, gr = np.where(carry, gc - w, gc), gr + carry + step_r
        m = m + step_m
        carry = gr >= h
        gr, m = np.where(carry, gr - h, gr), m + carry
    # the lead (thread t < lead writes int32 t) and the tail (the last 1-3 int32), plainly
    lead_f = np.broadcast_to(t, (sh.blocks, _THREADS))
    tail_f = lead[:, None] + 4 * n4[:, None] + t
    for f, plain in ((lead_f, t < lead[:, None]), (tail_f, tail_f < (nm * hw)[:, None])):
        mt = f // hw
        rt = f - mt * hw
        at_out = (base[:, None] * hw + f)[plain]
        out[at_out] = one_tile(mt, rt // w, rt % w, plain)[plain]
        writes[at_out] += 1
    return out.reshape(batch, h, w), writes


def _literal_mazes(cells, batch, algorithm, warps=None, mazes=None, **kw):
    if mazes is None:
        mazes = km.plan(cells, batch).mazes if warps is None else 32 * warps
    sh = _SharedTrees(cells, batch, mazes)
    if algorithm == "backtracker":
        _k11_walk(sh, cells, batch, kw["seed"])
    else:
        _k3_walk(sh, cells, batch, **kw)
    _tree_to_walls(sh)
    grids, writes = _write_grids(sh, cells, batch)
    assert (writes == 1).all()  # every int32 once, no wall fill
    return torch.from_numpy(grids.astype(np.int32))


_LITERAL_SHAPES = [((1, 1), 40, None), ((2, 2), 33, None), ((3, 7), 70, 4), ((1, 63), 40, None),
                   ((63, 1), 40, None), ((17, 16), 33, None), ((17, 16), 200, 4), ((4, 4), 300, 2)]


# (cells, B, mazes a block): fewer than a warp's 32 mazes, as `plan` takes
# above about 120x120 cells; with 1 or 2 a block's region starts off a
# 16-byte boundary and its lead is written plainly
_FEW_MAZES = [((3, 7), 9, 1), ((2, 2), 7, 2), ((1, 1), 5, 1), ((5, 3), 13, 8), ((17, 16), 20, 16), ((1, 9), 6, 2)]


@pytest.mark.parametrize("cells,b,mazes", _FEW_MAZES)
@pytest.mark.parametrize("algorithm", ["backtracker", "aldous_broder"])
def test_literal_walks_with_few_mazes_a_block_match_the_plain_versions(cells, b, mazes, algorithm):
    if algorithm == "backtracker":
        got = _literal_mazes(cells, b, algorithm, mazes=mazes, seed=13)
        want = tm.backtracker_mazes_reference(cells, b, seed=13, device=CPU)
    else:
        max_iters = 2 * cells[0] * cells[1] + 3  # short of cover for most: the safety net carves the rest
        got = _literal_mazes(cells, b, algorithm, mazes=mazes, max_iters=max_iters, seed=13)
        want = tm.aldous_broder_mazes_reference(cells, b, max_iters, seed=13, device=CPU)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cells,b,warps", _LITERAL_SHAPES)
def test_k11_literal_walk_matches_the_plain_version(cells, b, warps):
    got = _literal_mazes(cells, b, "backtracker", warps, seed=11)
    assert torch.equal(got, tm.backtracker_mazes_reference(cells, b, seed=11, device=CPU))


@pytest.mark.parametrize("cells,b,warps", _LITERAL_SHAPES)
@pytest.mark.parametrize("mode", ["injected short", "injected covered", "seeded short", "seeded covered"])
def test_k3_literal_walk_matches_the_plain_version(cells, b, warps, mode):
    s = cells[0] * cells[1]
    # short: the cap stops most walks early (not on a block's edge) and the safety net carves the rest
    max_iters = 3 * s + 5 if mode.endswith("short") else tm._ab_default_max_iters(max(s, 2))
    if mode.startswith("injected"):
        rng = np.random.default_rng(s * 1000 + b)
        dirs = rng.integers(0, 4, (max_iters + 7, b)).astype(np.int8)
        dirs[rng.random(dirs.shape) < 0.01] = 9      # outside 0..3: the walk stays where it is
        dirs[:, b // 2] = np.where(dirs[:, b // 2] == 9, -3, dirs[:, b // 2])
        want = tm.aldous_broder_mazes_reference(cells, b, max_iters, directions=torch.from_numpy(dirs))
        # rows at and past max_iters out of reach: the walk never reads them
        got = _literal_mazes(cells, b, "aldous_broder", warps, max_iters=max_iters, dirs=dirs[:max_iters])
    else:
        want = tm.aldous_broder_mazes_reference(cells, b, max_iters, seed=7, device=CPU)
        got = _literal_mazes(cells, b, "aldous_broder", warps, max_iters=max_iters, seed=7)
    assert torch.equal(got, want)
    assert all(tm.check_perfect_maze(g, cells) for g in got[:8])
