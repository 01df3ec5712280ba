"""Port parity: Aldous–Broder maze generation (K3's plain version).

With the reference's per-step draws (`randint(fold_in(key, t), (B,), 0, 4)`)
injected, `aldous_broder_mazes_reference` must give the reference's grids
bit for bit, including when the cap cuts the walks short and the safety
net fires. The seeded mode has its own stream, so it is held to what the
algorithm promises: perfect mazes, exactly uniform over spanning trees.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from griduniverse_tpu.levels import maze as jm
from griduniverse_tpu_torch.core import semantics as S
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
