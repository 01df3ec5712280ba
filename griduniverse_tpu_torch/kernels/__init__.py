"""Hand-written CUDA kernels for Hopper, their build and their launch counts.

K1 `random_scan_bits` and K2 `rollout_actions_bits` live in
`csrc/rollout.cu` (with the device step in `csrc/step.cuh`), K3
`aldous_broder_mazes` in `csrc/maze.cu`, K4 `dp_grid` (grid-form VI/PI) in
`csrc/dp_grid.cu`, K5 `td_scan_fast` (shared-Q TD) in `csrc/td_fast.cu`, K6
`td_batched` (per-maze TD) in `csrc/td_batched.cu` and K10 `segment_mean`
in `csrc/segment_mean.cu`. The neural learners' kernels are K7a `gae` (the
GAE and n-step-return scans) in `csrc/gae.cu`, K7b `act_step` (sample,
log-prob and env step; and its greedy form) in `csrc/act_step.cu`, K9a
`embed_rows` (index embedding, with its backward) in `csrc/embed_rows.cu`
and K9b `agent_stamp` (agent plane of the first conv layer, with its
backward) in `csrc/agent_stamp.cu`. The off-policy learner's are K8a
`per_sample` (the prioritized draw: scores, exact top-n, weights) and K8b
`replay` (the ring's write, gather and priority refresh) in `csrc/replay.cu`.
K11 `backtracker_mazes` is in `csrc/backtracker.cu`, and the two gather
probes P1 `gather_1d` and P2 `take_along_axis1` in `csrc/gather_probe.cu`.
K12 `trace_pass` (one step of the TD(λ) eligibility traces: decay, flush,
bump, the live-trace mean and the cut) is in `csrc/trace_pass.cu`. K7c
`dqn_act` (DQN's ε-greedy act, env step and episode statistics) is in
`csrc/dqn_act.cu`, and K13 `mc_returns` (Monte-Carlo returns and the
first-visit mask) in `csrc/mc_returns.cu`.
`build.load()` compiles them with `nvcc` for `sm_90a` at first use.

Dispatch rule, applied by the public functions in `ops/`, `levels/`,
`algos/` and `models/`:
tensors on the CPU take the plain PyTorch version beside each kernel;
CUDA tensors launch the kernel, or raise. There is no fallback.

`LAUNCHES[name]` counts the kernel launches of each entry: a wrapper adds
one for each kernel it launched, right after the call that launched them
succeeded, and nowhere else. K5 is one cooperative launch a scan of any
length, and counts 1; the backward of `embed_rows` launches two kernels and
so does that of `agent_stamp`, and each counts under its kernel's name. A
`per_sample` draw is eight kernels up to 16,384 picks (scores, four
histogram passes, count, compaction, sort and weights) and twenty above
(the sort in twelve multi-block passes), and a `segment_mean` call four
(count, scan, scatter, sum); the ring's write and gather are one each, and
the refresh one up to 8,192 rows and two above, all under `replay`. A trace
step is one (each tile's last block adds the chunks' sums and writes the
table); a DQN act-and-step is one (its last block folds the statistics). K4
counts one launch a call up to 16,384 cells a maze and one a sweep above.

Two forms serve the sharded runs (`parallel/`): `td_step_sharded`, K5's
sharded form in `csrc/td_fast.cu`, one ordinary launch a step with the
all-reduce of the step's aggregate between launches, and one more that
writes the final Q (T + 1 a scan of T steps); and `segment_sums`, K10's
sums form in `csrc/segment_mean.cu`, the same four kernels stopped before
the divide (four a call).
"""

from __future__ import annotations

import torch

LAUNCHES: dict[str, int] = {
    "random_scan_bits": 0,
    "rollout_actions_bits": 0,
    "aldous_broder_mazes": 0,
    "dp_grid": 0,
    "td_scan_fast": 0,
    "td_batched": 0,
    "segment_mean": 0,
    "gae": 0,
    "act_step": 0,
    "embed_rows": 0,
    "agent_stamp": 0,
    "per_sample": 0,
    "replay": 0,
    "backtracker_mazes": 0,
    "gather_1d": 0,
    "take_along_axis1": 0,
    "trace_pass": 0,
    "dqn_act": 0,
    "mc_returns": 0,
    "td_step_sharded": 0,
    "segment_sums": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def on_cuda(*items) -> bool:
    """True if every tensor (or device) lies on a CUDA device, False if
    every one lies on the CPU; raises for a mix or any other device."""
    kinds = {
        (x.device if isinstance(x, torch.Tensor) else torch.device(x)).type
        for x in items
    }
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors must all be on the CPU or all on CUDA; got {sorted(kinds)}")
