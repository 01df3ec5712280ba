"""Minimal Gym-style spaces — counterpart of
`griduniverse_tpu/compat/spaces.py`, copied.

The reference exposes `action_space = Discrete(4)` and
`observation_space = Discrete(H*W)` from the gym of its era. gym is not a
dependency, so this is the tiny subset the API needs, duck-type compatible
with `gym.spaces.Discrete` (`.n`, `.sample()`, `.contains()`). `sample()`
draws from `np.random.default_rng(seed)`, so a seed gives the reference's
action sequence.
"""

from __future__ import annotations

import numpy as np


class Discrete:
    """A finite set {0, 1, …, n−1}."""

    def __init__(self, n: int, seed: int | None = None):
        if n <= 0:
            raise ValueError("Discrete space needs n > 0")
        self.n = int(n)
        self._rng = np.random.default_rng(seed)

    def seed(self, seed: int | None = None):
        self._rng = np.random.default_rng(seed)

    def sample(self) -> int:
        return int(self._rng.integers(0, self.n))

    def contains(self, x) -> bool:
        try:
            xi = int(x)
        except (TypeError, ValueError):
            return False
        return 0 <= xi < self.n

    def __contains__(self, x) -> bool:
        return self.contains(x)

    def __repr__(self) -> str:
        return f"Discrete({self.n})"

    def __eq__(self, other) -> bool:
        return isinstance(other, Discrete) and other.n == self.n
