"""Neural learners: the on-policy trainers (A2C, PPO), the off-policy one
(DQN with its replay buffer), their networks, optimizer and evaluation, on
one device, and data-parallel over the ranks of a `parallel.mesh.EnvMesh`
(`*_init_sharded`, `*_run_sharded`, `*_train_sharded`; `reshard_stats` for
an elastic resume, `gather_train_state` to bring a rank's state to the host
whole)."""

from .a2c import (
    A2CConfig,
    A2CResult,
    A2CTrainState,
    a2c_init,
    a2c_init_sharded,
    a2c_result,
    a2c_run,
    a2c_run_sharded,
    a2c_train,
    a2c_train_sharded,
    gather_train_state,
    greedy_actions,
    init_network_params,
    make_network,
    reshard_stats,
)
from .dqn import (
    BatchedConvQNetwork,
    ConvQNetwork,
    DQNConfig,
    DQNResult,
    DQNTrainState,
    QNetwork,
    ReplayBuffer,
    buffer_init,
    buffer_sample,
    buffer_sample_idx,
    buffer_write,
    dqn_init,
    dqn_init_sharded,
    dqn_result,
    dqn_run,
    dqn_run_sharded,
    dqn_train,
    dqn_train_sharded,
    greedy_q_actions,
    make_q_network,
    prioritized_sample,
)
from .evaluation import (
    greedy_reached,
    greedy_reached_tabular,
    greedy_success_rate,
    greedy_success_rate_tabular,
)
from .networks import ActorCritic, BatchedConvActorCritic, ConvActorCritic
from .ppo import (
    PPOConfig,
    PPOResult,
    PPOTrainState,
    gae_advantages,
    ppo_init,
    ppo_init_sharded,
    ppo_result,
    ppo_run,
    ppo_run_sharded,
    ppo_train,
    ppo_train_sharded,
)
