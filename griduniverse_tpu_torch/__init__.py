"""griduniverse_tpu_torch — the PyTorch/CUDA port of griduniverse_tpu.

The same gridworld engine on natively batched torch tensors, with the hot
loops as hand-written CUDA kernels for Hopper (`csrc/`, bound by
`kernels/`). The JAX package `griduniverse_tpu` is the reference; module
paths and public names mirror it.

Subpackages:
  core      — semantics tables, containers, batched step/reset, model table
  levels    — text-level I/O, builders, maze generation (K3 Aldous–Broder,
              K11 the recursive backtracker)
  ops       — generic rollouts and the bit-packed engine (K1 with its
              xorshift and threefry action streams, K2)
  algos     — tabular solvers: DP over one or N mazes (K4), shared-Q TD
              (K5), per-maze TD (K6), the generic TD learners and
              Monte-Carlo prediction and control (`mc`) over the segment
              mean (K10), TD(λ) control and prediction (`td_lambda`) over
              the trace pass (K12)
  models    — neural learners on one device: networks (K9a, K9b),
              optimizer, A2C and PPO (K7a, K7b), DQN with its replay ring
              and prioritized draw (K8a, K8b), greedy evaluation
  parallel  — sharded runs on `torch.distributed`, one rank a shard:
              the mesh and its collectives, the runtime, sharded rollouts
              (K1), solvers (K4 under one global stop) and tabular
              Q-learners (K5's sharded form, K10 or its sums form, K6)
  compat    — the reference GridUniverse's API: the Gym-style
              `GridUniverseEnv` (a K2 launch a step, or the NumPy oracle),
              its gymnasium adapter (`GridUniverseTorch-v0`) and the
              NumPy-facing `VectorGridEnv` (a K2 launch a step), with
              `Discrete` spaces and headless rendering
  kernels   — build, binding and launch counts of the CUDA kernels
  utils     — device choice, conversion of the reference's objects into the
              port's, checkpoints, metrics, the NumPy oracle (`oracle`) and
              the tracing and timing helpers (`profiling`)
  tools     — command-line tools for the card (profile_rollout,
              profile_solvers, profile_learners, profile_kernels (the
              compat envs' steps too), sass_counts, gather_probe, the
              gather probes P1, P2, and gen_artifact, the generalization
              gate with the fresh-maze curriculum, and its probe
              fresh_maze_curriculum)
"""

from .core.model import ModelTable, build_model_table
from .core.semantics import (
    DEFAULT_CONFIG,
    EMPTY,
    GOAL,
    LAVA,
    NUM_ACTIONS,
    NUM_TILE_TYPES,
    WALL,
    Semantics,
    SemanticsConfig,
    make_semantics,
)
from .core.step import observe, reset, step, step_autoreset, step_autoreset_truncated
from .core.types import EnvState, Level, StepResult, make_level

__version__ = "0.1.0"
