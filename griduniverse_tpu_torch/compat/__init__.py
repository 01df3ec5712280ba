"""Gym-style compatibility layer: the reference GridUniverse's mutable
single-env API (`GridUniverseEnv`, on K2 or the host oracle), its
gymnasium adapter and a NumPy-facing vector env (on K2) — counterpart of
`griduniverse_tpu/compat/`."""

from .gym_env import GridUniverseEnv
from .gymnasium_env import ENV_ID, GridUniverseGymnasiumEnv, register_envs
from .spaces import Discrete
from .vector_env import VectorGridEnv
