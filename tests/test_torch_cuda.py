"""The CUDA kernels K1, K2 and K3 against their plain PyTorch versions.

These tests need a CUDA card and the CUDA toolkit (`nvcc`); without a card
they skip. This file imports no JAX, so it also runs on a machine without
it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import pytest
import torch

import griduniverse_tpu_torch as T
from griduniverse_tpu_torch import kernels
from griduniverse_tpu_torch.levels import builders
from griduniverse_tpu_torch.levels import maze as M
from griduniverse_tpu_torch.ops import bitplane as bp

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _levels(dev):
    walls = bp.pack_level(builders.walls_and_goal_16x16(device=dev))
    grids, start = M.generate_mazes_device(4, (4, 4), 1024, "binary_tree", device=dev)
    mazes = bp.pack_level(T.Level(grid=grids, start_idx=start.expand(1024).contiguous()))
    return {"walls16": walls, "mazes": mazes}


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_same(got, ref):
    for a, b in zip(got, ref):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("mode", [(False, None), (True, None), (True, 32)])
def test_rollout_actions_kernel_matches_plain(dev, mode):
    sem = T.make_semantics(device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for bl in _levels(dev).values():
        st = bp.reset_bits(bl, None if bl.batched else 1024)
        actions = torch.randint(-2, 6, (300, 1024), generator=gen, device=dev, dtype=torch.int32)
        before = kernels.LAUNCHES["rollout_actions_bits"]
        got_state, got = bp.rollout_actions_bits(sem, bl, st, actions, *mode)
        assert kernels.LAUNCHES["rollout_actions_bits"] == before + 1
        ref_state, ref = bp.rollout_actions_bits_reference(sem, bl, st, actions, *mode)
        _assert_same(got, ref)
        for f in ("agent_idx", "agent_code", "t", "done"):
            assert torch.equal(getattr(got_state, f), getattr(ref_state, f))


def test_random_scan_kernel_matches_plain(dev):
    sem = T.make_semantics(device=dev)
    for bl in _levels(dev).values():
        st = bp.reset_bits(bl, None if bl.batched else 1024)
        rs = bp.xorshift_init(9, (1024,), device=dev)
        before = kernels.LAUNCHES["random_scan_bits"]
        got = bp.random_scan_bits(sem, bl, st, rs, None, 700, 100)
        assert kernels.LAUNCHES["random_scan_bits"] == before + 1
        ref = bp.random_scan_bits_reference(sem, bl, st, rs, 700, 100)
        _assert_same(got[1:], ref[1:])
        for f in ("agent_idx", "agent_code", "t", "done"):
            assert torch.equal(getattr(got[0], f), getattr(ref[0], f))


@pytest.mark.parametrize("cells,max_iters", [((4, 4), 3000), ((5, 5), 20), ((16, 16), None)])
def test_aldous_broder_kernel_matches_plain(dev, cells, max_iters):
    b = 256
    before = kernels.LAUNCHES["aldous_broder_mazes"]
    got = M._aldous_broder_mazes(cells, b, max_iters, seed=3, device=dev)
    assert kernels.LAUNCHES["aldous_broder_mazes"] == before + 1
    assert torch.equal(got, M.aldous_broder_mazes_reference(cells, b, max_iters, seed=3, device=dev))
    if max_iters is not None:
        dirs = torch.randint(0, 4, (max_iters, b), device=dev, dtype=torch.int8)
        got = M._aldous_broder_mazes(cells, b, max_iters, directions=dirs)
        assert torch.equal(got, M.aldous_broder_mazes_reference(cells, b, max_iters, directions=dirs))
    assert all(M.check_perfect_maze(g, cells) for g in got.cpu())


def test_wrappers_raise_on_bad_input(dev):
    sem = T.make_semantics(device=dev)
    bl = _levels(dev)["walls16"]
    st = bp.reset_bits(bl, 8)
    with pytest.raises(ValueError):
        bp.random_scan_bits(sem, bl, st, bp.xorshift_init(0, (8,), device=dev).long(), None, 5, None)
    with pytest.raises(ValueError):
        bp.rollout_actions_bits(sem, bl, st, torch.zeros((5, 8), dtype=torch.int32), True)
    with pytest.raises(ValueError):
        M._aldous_broder_mazes((17, 16), 4, 10, device=dev)
