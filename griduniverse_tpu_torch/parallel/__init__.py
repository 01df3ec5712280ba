"""Sharded runs on `torch.distributed` — counterpart of `griduniverse_tpu/parallel/`.

The reference shards with `shard_map` over a JAX `Mesh`; the port shards
over a process group, one rank a shard, each rank on its own device (NCCL
one rank a card; Gloo on the CPU or for ranks sharing a card). An
`EnvMesh` (`parallel.mesh`) names the group with the reference's axis
names; `parallel.distributed` starts and ends it.

Ported: the mesh (`make_env_mesh`, `make_host_env_mesh`, `shard_env_state`),
the runtime (`distributed`), the sharded rollouts (`reset_batch_sharded`,
`episode_stats_sharded` on the generic step; `compile_rollout_random_sharded`
on K1), the sharded solvers (`value_iteration_sharded`,
`policy_iteration_sharded` on the state axis; the batched-table and grid
forms on the maze axis, the grid forms on K4), the shared-Q learners
(`compile_q_learning_fast_sharded` on K5's sharded form, `q_learning_sharded`
on the generic step with K10 or its sums form) and the per-maze learner
(`q_learning_batched_sharded` on K6), the sharded TD(λ) learners
(`td_lambda_sharded`, `td_lambda_prediction_sharded` on K12's partial-sums
form) and the sharded Monte-Carlo learners (`mc_control_sharded`,
`mc_prediction_sharded` on K13 and K10 or its sums form). The sharded
neural trainers are in `models/` (`a2c_run_sharded`, `ppo_run_sharded`,
`dqn_run_sharded` and their init and train entries), as in the
reference. The JAX sharding objects
`env_spec`, `env_sharding` and `replicated_sharding` have no counterpart.
"""

from . import distributed
from .bitplane import compile_q_learning_fast_sharded, compile_rollout_random_sharded
from .dp import (
    policy_iteration_batched_grid_sharded,
    policy_iteration_batched_sharded,
    policy_iteration_sharded,
    value_iteration_batched_grid_sharded,
    value_iteration_batched_sharded,
    value_iteration_sharded,
)
from .learner import (
    DistTDResult,
    mc_control_sharded,
    mc_prediction_sharded,
    q_learning_batched_sharded,
    q_learning_sharded,
    td_lambda_prediction_sharded,
    td_lambda_sharded,
)
from .mesh import (
    ENV_AXIS,
    HOST_AXIS,
    EnvMesh,
    make_env_mesh,
    make_host_env_mesh,
    shard_env_state,
)
from .rollout import episode_stats_sharded, reset_batch_sharded
