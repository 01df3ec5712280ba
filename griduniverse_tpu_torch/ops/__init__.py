"""Batched rollouts and the bit-packed fast engine."""

from .bitplane import (
    BitLevel,
    FastState,
    compile_rollout_random,
    pack_level,
    random_scan_bits,
    reset_bits,
    rollout_actions_bits,
    rollout_random_bits,
    step_bits,
    tile_code,
    xorshift_init,
    xorshift_next,
)
from .rollout import (
    episode_stats,
    reset_batch,
    rollout_actions,
    rollout_policy,
    rollout_random,
    step_autoreset_batch,
    step_batch,
)

__all__ = [
    "BitLevel",
    "FastState",
    "compile_rollout_random",
    "pack_level",
    "random_scan_bits",
    "reset_bits",
    "rollout_actions_bits",
    "rollout_random_bits",
    "step_bits",
    "tile_code",
    "xorshift_init",
    "xorshift_next",
    "episode_stats",
    "reset_batch",
    "rollout_actions",
    "rollout_policy",
    "rollout_random",
    "step_autoreset_batch",
    "step_batch",
]
