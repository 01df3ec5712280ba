"""On-device tabular solvers — counterpart of `griduniverse_tpu/algos`."""

from .dp import (
    action_values,
    greedy_policy_improvement,
    policy_evaluation,
    policy_iteration,
    value_iteration,
)
from .dp_batched import (
    action_values_batched,
    build_model_tables,
    policy_evaluation_batched,
    policy_iteration_batched,
    policy_iteration_batched_grid,
    value_iteration_batched,
    value_iteration_batched_grid,
)
from .mc import MCControlResult, MCResult, mc_control, mc_prediction
from .td import (
    DoubleTDResult,
    TDResult,
    apply_td_updates,
    double_q_learning,
    epsilon_greedy,
    expected_sarsa,
    q_learning,
    sarsa,
    td_error_expected_sarsa,
    td_error_qlearning,
    td_error_sarsa,
)
from .td_batched import BatchedTDResult, BatchedTDState, q_learning_batched
from .td_fast import (
    FastTDResult,
    FastTDTrainState,
    compile_fast_td_run,
    compile_q_learning_fast,
    fast_td_init,
    fast_td_result,
)
from .td_lambda import (
    TDLambdaPredictionResult,
    apply_trace_updates,
    bump_traces,
    decay_traces,
    sarsa_lambda,
    td_lambda_prediction,
    watkins_q_lambda,
)
from .utils import (
    greedy_policy_from_q,
    greedy_policy_from_v,
    policy_arrows,
    run_greedy_episode,
    value_grid,
)
