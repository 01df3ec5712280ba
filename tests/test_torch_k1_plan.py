"""K1's launch plan, its exact division and its operation count, on the CPU.

K1 (`csrc/rollout.cu` `random_scan_bits_kernel`) takes the action of a draw
as `(bits >> 9) % A` without dividing: `kernels.rollout.draw_form` hands it a
mask or a multiply-high, which must equal `%` on every value `bits >> 9`
takes. `kernels.rollout.plan` picks its blocks and where each env's level is
read from. `chip_smoke.k1_function_ops` is the count its bound rests on.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from griduniverse_tpu_torch.kernels import rollout as rk

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reduce(x: np.ndarray, a: int) -> np.ndarray:
    """What K1 computes for `x % a` on uint32 lanes, in uint64 numpy."""
    form, magic = rk.draw_form(a)
    u32 = np.uint64(0xFFFFFFFF)
    if form == rk.DRAW_MASK:
        return x & np.uint64(a - 1)
    if form == rk.DRAW_MULHI:
        assert 0 < magic < 1 << 32
        q = (x * np.uint64(magic)) >> np.uint64(32)  # __umulhi: x < 2^23, so the product fits 64 bits
        return (x - ((np.uint64(a) * q) & u32)) & u32
    return x % np.uint64(a)


@pytest.mark.parametrize("a", [*range(1, 26), 127, 256, 511])
def test_draw_form_equals_the_remainder_on_every_draw(a):
    """Every value of `bits >> 9` (all 2^23) gives `%`'s action."""
    chunk = 1 << 20
    for start in range(0, 1 << 23, chunk):
        x = np.arange(start, start + chunk, dtype=np.uint64)
        assert np.array_equal(_reduce(x, a), x % np.uint64(a)), f"A={a}: differs in [{start}, {start + chunk})"


def test_draw_form_picks_mask_multiply_high_and_remainder():
    for a in (1, 2, 4, 8, 16, 512, 1024):
        assert rk.draw_form(a) == (rk.DRAW_MASK, 0)
    for a in (3, 9, 25, 511):
        assert rk.draw_form(a) == (rk.DRAW_MULHI, -(-(1 << 32) // a))
    for a in (513, 600, 1000):
        assert rk.draw_form(a) == (rk.DRAW_MODULO, 0)
    with pytest.raises(ValueError):
        rk.draw_form(0)


SMS = 132  # the H100 SXM's SMs; a card with fewer moves the one-warp limit down with them
ONE_A_SCHEDULER = SMS * rk.SCHEDULERS * rk.WARP  # envs of one warp for each of the card's schedulers


@pytest.mark.parametrize("actions", [8, 9])
@pytest.mark.parametrize("n_words,per_env", [(16, False), (1024, False), (6, True), (69, True), (256, True),
                                             (1024, True)])
@pytest.mark.parametrize("batch", [1, 33, 4096, ONE_A_SCHEDULER, ONE_A_SCHEDULER + 1, 65_536, 1_000_000])
def test_plan_holds_its_limits(batch, n_words, per_env, actions):
    p = rk.plan(batch, n_words, per_env, actions, SMS)
    assert p.threads % rk.WARP == 0 and rk.WARP <= p.threads <= rk.MAX_THREADS
    assert (p.blocks - 1) * p.threads < batch <= p.blocks * p.threads
    # one warp a block while each scheduler gets one warp at most; eight above
    assert p.threads == (rk.WARP if batch <= ONE_A_SCHEDULER else rk.MAX_THREADS)
    assert p.wide == (actions > rk.NARROW_ACTIONS)
    if not per_env:  # a byte a cell, and the cell off the grid
        assert (p.level, p.shared) == (rk.LEVEL_SHARED, 16 * n_words + 4)
    elif p.threads * n_words * 4 <= rk.STAGE_BYTES:  # the packed words of the block's envs
        assert (p.level, p.shared) == (rk.LEVEL_STAGED, p.threads * n_words * 4)
    else:
        assert (p.level, p.shared) == (rk.LEVEL_DEVICE, 0)
    assert p.shared <= rk.STAGE_BYTES  # no launch asks for more than a block takes by default


@pytest.mark.parametrize("sms", [1, 114, 132])
def test_plan_takes_one_warp_blocks_up_to_one_warp_a_scheduler(sms):
    limit = sms * rk.SCHEDULERS * rk.WARP
    assert rk.plan(limit, 16, False, 4, sms).threads == rk.WARP
    assert rk.plan(limit + 1, 16, False, 4, sms).threads == rk.MAX_THREADS


@pytest.mark.parametrize("batch,n_words,level", [
    (65_536, 6, rk.LEVEL_STAGED),      # 9x9 mazes: eight warps' 6,144 bytes a block
    (16_384, 69, rk.LEVEL_STAGED),     # 33x33 mazes: 8,832 bytes a one-warp block
    (65_536, 69, rk.LEVEL_DEVICE),     # 70,656 bytes a block of eight warps
    (65_536, 48, rk.LEVEL_STAGED),     # 49,152 bytes: exactly the limit
    (4096, 384, rk.LEVEL_STAGED),      # 48 KB a one-warp block
    (4096, 385, rk.LEVEL_DEVICE),
    (32, 1024, rk.LEVEL_DEVICE),       # 128 KB a warp
])
def test_plan_stages_per_env_levels_where_a_block_holds_them(batch, n_words, level):
    assert rk.plan(batch, n_words, True, 4, SMS).level == level


def test_plan_refuses_an_empty_batch():
    with pytest.raises(ValueError):
        rk.plan(0, 16, False, 4, SMS)


def test_k1_function_ops_counts_its_terms():
    cs = _chip_smoke()
    assert cs.k1_step_ops(4) == 39
    assert cs.k1_function_ops(65_536, 1_000, 4) == 39 * 65_536 * 1_000
    assert cs.k1_threefry_function_ops(65_536, 1_000, 4) == 69 * 65_536 * 1_000
    # the draw's remainder is a multiply-high below 512 actions, two more
    # multiplies above; no other term depends on the number of actions
    ops = [cs.k1_step_ops(a) for a in range(1, 1025)]
    assert ops == sorted(ops)
    assert set(ops[:511]) == {39} and set(ops[511:]) == {41}
    assert cs.k1_step_ops(9) == cs.k1_step_ops(25) == 39
    # walls16, 65,536 envs, 1,000 steps on 132 SMs x 4 x 32 lanes at 1,980 MHz
    lanes_per_s = 132 * 4 * 32 * 1.98e9
    assert cs.k1_function_ops(65_536, 1_000, 4) / lanes_per_s * 1e3 == pytest.approx(0.0764, abs=5e-5)
