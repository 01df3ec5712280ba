"""Neural learners on one device: the on-policy trainers (A2C, PPO), the
off-policy one (DQN with its replay buffer), their networks, optimizer and
evaluation."""

from .a2c import (
    A2CConfig,
    A2CResult,
    A2CTrainState,
    a2c_init,
    a2c_result,
    a2c_run,
    a2c_train,
    greedy_actions,
    init_network_params,
    make_network,
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
    dqn_result,
    dqn_run,
    dqn_train,
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
    ppo_result,
    ppo_run,
    ppo_train,
)
