#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`griduniverse_tpu_torch`) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
(the kernels are built for sm_90a) and the CUDA toolkit:

    python3 chip_smoke.py

It builds the nineteen hand-written kernels (K1–K6, K7a, K7b, K7c, K8a, K8b,
K9a, K9b, K10, K11, K12, K13, P1, P2) from `griduniverse_tpu_torch/csrc/`, holds
each against its plain PyTorch version, drives the port's main paths at full
size and checks what comes out:

  * the env path: level → pack → K1/K2 rollouts; K3 mazes → pack → K1, and
    K3 on 32×32-cell mazes from injected directions;
  * the solver path: K3 mazes → K4 value/policy iteration, and K4's
    cluster tier over 64 sidewinder mazes of 161×129 (20,769 states each,
    two blocks a maze; its global tier held on the same mazes and on a
    2,401×129 maze that no cluster holds); walls16 → K5
    shared-Q learning, and K5 on one 65×65 backtracker maze (16,900 Q
    entries); mazes → K6 per-maze Q-learning (tables in shared memory at
    9×9, in device memory at 33×33); walls16 → `q_learning` on the generic
    step with K10, at up to 65,536 envs; K10's two tiers (one launch of a
    thread-block cluster, and the four passes) in both forms at the paths'
    batches and tables and at every boundary of `plan`, and timed side by
    side in a CUDA graph;
  * the training path: `ppo_train` on walls16 (K7a, K7b, K9a) and on 65,536
    per-env mazes with the conv trunk (K7a, K7b, K9b), `a2c_train` on walls16
    (K7a's return scan, K7b, K9a), and `greedy_success_rate` (K7b's greedy
    form), 65,536 envs each; K7b through the host plan each run builds;
  * the maze and probe path: K11 backtracker mazes through
    `generate_mazes_device` (up to 63×63 cells) → pack → K1; the gather
    probe tool (P1, P2);
  * the tabular family's last two modules: `mc_prediction` and `mc_control`
    at 25,600 and 102,400 samples a round (K13, K10), and `sarsa_lambda`,
    `watkins_q_lambda` and `td_lambda_prediction` through the trace pass
    (K12) at 65,536 envs, and at 4,096;
  * the off-policy path: `dqn_train` on walls16 with uniform and with
    prioritized replay (K7c, K8a, K8b, K9a; the prioritized draw also at
    4,096 picks) and on 65,536 per-env backtracker mazes with the conv
    Q-network (K7c, K8b, K9b), 65,536 envs and a ring of 131,072 transitions
    each; K7c in its store form, which writes each step's transitions and
    priority into the ring (K8b gathers and refreshes);
  * resume through disk: `dqn_run` (uniform and prioritized, K7c) and
    `ppo_run` at 65,536 envs saved by an async `CheckpointManager`,
    restored into a fresh state and run on, against the unbroken runs;
  * the ceilings closed since: K11 and K3 on mazes above 63×63 cells
    (fewer mazes a block, and one a block with its tree in device memory),
    and every step kernel (K1, K2, K4, K5, K6, K7b, K7c) at nine actions
    (K2 at 25 too), each through its public entry; and K2's times at its
    four shapes, as timed and in a CUDA graph of ten;
  * the compat API: `VectorGridEnv` (a K2 launch a step) over walls16 and
    over per-env mazes at 65,536 envs, and `GridUniverseEnv(backend="torch")`
    (a K2 launch a step) in random walks, each held bit for bit against its
    CPU twin; and K1's threefry action stream through `rollout_random_bits`
    and `compile_rollout_random`, against its plain version and in chunks.

  * the sharded paths: `parallel/`'s rollouts, solvers and Q-learners
    (phase 26), and the sharded TD(λ) learners (K12's partial-sums form),
    MC learners and A2C, PPO and DQN trainers (phase 27), over NCCL in a
    world of one at full width and over Gloo with two ranks on the card,
    each held against the unsharded port.
  * the generalization gate (phase 28, `tools/gen_artifact.py`): K3's
    1,024 training and 256 held-out 7×7 mazes, PPO with the conv trunk over
    them (K7a, K7b, K9b in float32), the greedy evaluation and its
    wrong-tiles ablation (K7b's greedy form), and the 11×11 fresh-maze
    curriculum, cut to 10 updates and 2 chunks × 5; K3's times at 1,024
    mazes of 3×3, 4×4 and 5×5 cells.
  * the captured trainers (phase 29, `utils/capture.py`): `dqn_run`,
    `ppo_run` and `a2c_run` on the card run one step or update captured in a
    CUDA graph and replayed; each path (DQN uniform, PER and over 65,536
    mazes, PPO on walls16 and over the mazes, A2C, the gate's 7×7 PPO) held
    bit for bit against the eager loop, its plain version, and 60 + 60
    against 120 captured (2 + 2 against 4 for PPO over the mazes); ms a
    call each way, the replays' ms a step, the capture's ms and pool, the
    idle share, and device events and graph launches a step. Phases 12, 18
    and 28 count the captured calls' launches: a replay's times the replays
    and the warm-up step.

Each main path is driven with the launch counts set to 0 just before it and
read just after, and every count must be the one the path's shape gives. The
main paths' own outputs are held bit for bit against the plain versions on
the same inputs. Every phase raises on failure. The last two lines are a
JSON record of the kernels (launches on the main paths, error against the
plain version, kernel / plain / library times and the least time the card
could take; K3 and K11 once for each shape they are timed at, K1 for each
action stream, K2 also at the compat step's T = 1) and
`{"ok": true, "device": {...}}`.

It imports nothing of JAX: the reference's per-env golden mazes are read from
`tests/golden/torch/`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MAX_EPISODE_STEPS = 512


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def k10_launches(batch: int, n_seg: int, dev) -> int:
    """Kernels a K10 call of `batch` envs over `n_seg` segments launches on
    `dev`: 1 where `kernels.segment_mean.plan` takes a thread-block cluster,
    4 (count, scan, scatter, sum) where it takes the passes."""
    from griduniverse_tpu_torch.kernels import segment_mean

    return segment_mean.call_plan(batch, n_seg, dev).launches


def _max_err(a, b) -> float:
    return float((a.detach().double() - b.detach().double()).abs().max()) if a.numel() else 0.0


def _same(name: str, a, b) -> float:
    """Bit-exact equality (floats compared by their bits); returns max|a-b|."""
    _require(a.shape == b.shape and a.dtype == b.dtype, f"{name}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    if a.dtype == torch.float32:
        equal = bool((a.view(torch.int32) == b.view(torch.int32)).all())
    else:
        equal = bool((a == b).all())
    err = _max_err(a, b)
    _require(equal, f"{name}: kernel and plain version differ (max abs err {err})")
    return err


def _cuda_ms(fn, reps: int, warm: bool = True):
    """Mean ms of `reps` calls (after a warm-up call unless `warm` is
    False), and the last call's output."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


_STATE_FIELDS = ("agent_idx", "agent_code", "t", "done")

# Thread-instructions per unit of work. They turn a kernel's work into the
# least time the card could take at one instruction per lane and clock. Each
# is the number of SASS instructions on the path that one unit of work takes
# through the kernel built for sm_90a with 4 actions, counted in the listings
# that `python -m griduniverse_tpu_torch.tools.sass_counts DIR` writes (a
# warp issues both sides of a branch its lanes split on, so both count).
# K1's SASS path a step (four actions, a shared level): its loop over a
# block of eight steps with their draws is 380 instructions in the xorshift
# form and 610 in the threefry form (four cipher blocks), over eight. They
# are printed beside the bound, which rests on `k1_function_ops`. The loop
# before the redesign was 85 a step (170 for two unrolled steps, the divides
# included) and 176 in the threefry form (71 of them the cipher, every
# other step)
INSTR_K1_STEP = 380 / 8
INSTR_K1_THREEFRY_STEP = 610 / 8
XORSHIFT_ROUND = 6      # three shifts and three xors
# Threefry-2x32-20's own operations a block: 20 rounds of an add, a rotate
# (one funnel shift) and a xor, and six key injections of two adds each
# (the round count folded into the key word, the same for every block)
THREEFRY_BLOCK = 20 * 3 + 6 * 2


def k1_step_ops(actions: int) -> int:
    """K1's own operations for one auto-reset step, as K4's are counted:
    the draw 10 (the xorshift round 6; `bits >> 9` 1; its remainder by A,
    below 512 actions a multiply-high by ⌈2³²/A⌉, a multiply and a subtract
    3, above with a 64-bit reciprocal, two multiplies more 5); the move 21
    (the (row, column) delta 2, the new row and column 2, the bounds test
    3, the candidate's index 1, its tile code 6: the word's index, the
    load, the bit offset, the shift and the mask, passable and blocked 3,
    four selects of the new position 4); the outcome 6 (the reward 1,
    terminal 2, the time limit's t + 1, compare and or 3: that t + 1 is
    the step's new t); the step's own 2 (`run_ret +=`, the done branch).
    The loop over steps is the implementation's, not the function's, and
    an episode's end, its counters and the reset, is spread over its length:
    neither is counted. 39 a step at four actions."""
    draw = XORSHIFT_ROUND + 1 + (3 if actions < 512 else 5)
    return draw + 21 + 6 + 2


def k1_function_ops(envs: int, steps: int, actions: int) -> int:
    """K1's own operations over a call, `k1_step_ops` a step. The bound of
    its xorshift form rests on this count."""
    return envs * steps * k1_step_ops(actions)


def k1_threefry_function_ops(envs: int, steps: int, actions: int) -> float:
    """K1's threefry form, its own operations over a call: each step is the
    xorshift form's with its xorshift round taken out, and one Threefry
    block feeds two steps. 69 a step at four actions."""
    return envs * steps * (k1_step_ops(actions) - XORSHIFT_ROUND + THREEFRY_BLOCK / 2)


INSTR_K2_STEP = 67      # the replay loop is 1,064 instructions a block of 16 steps, their actions' loads included
# one cell's VI sweep in the packed kernel (`grid_sweeps_packed_kernel<4, false>`:
# between two barriers 26 instructions on odd sweeps and 31 on even ones, of
# them four loads, multiplies, adds and maxima, the store, |ΔV| and its
# maximum)
INSTR_K4_CELL = 29


def k4_function_ops(actions: int) -> int:
    """K4's own operations a cell and sweep, as K9a and K9b count: per
    action a load of the V it continues from (a slot that holds 0.0 where
    the move ends the episode, so nothing is selected), a multiply and an
    add; a max for each action after the first; then |ΔV|, its maximum and
    the store. 18 for a VI sweep of 4 actions, 6 for an evaluation sweep
    (one action). The bounds in the record rest on this count."""
    return 3 * actions + (actions - 1) + 3


# K5, the function's own operations at four actions, as K4, K9a and K9b are
# counted: an env's step is 232 (the per-env path of the earlier kernel of
# one launch a step, whose loops over actions ran to A = 4, less the 76 that
# loaded and stored the env state), and a Q entry's update a step is the
# mean and the add (an estimate). The scan kernel's own extras, its loops
# over actions unrolled to 8 with guards, the warp's combine of the adds,
# the flush, the block's copy of Q and the test that skips an entry no env
# added to, are the design's cost, not the function's: the bound is 0.91 ms
# for 2,000 steps of 65,536 envs at walls16 on the H100
INSTR_K5_STEP = 232
INSTR_K5_ENTRY = 10
# K6, the function's own operations a step at four actions (Q-learning,
# native draws), counted one by one: the auto-reset env step 41 (two delta
# loads and adds, four bound tests, four clamps, the candidate index, six to
# read its tile code, the passable test, the blocked test, four selects of
# the new position, the reward load, the terminal test, the time limit's
# three, five selects of the reset, the four episode accumulators), the
# three rows 15 (addresses and twelve loads), the ε-greedy draw 21 (xorshift
# 6, coin 2, explore action 3, argmax 9, the select), the target and update
# 14 (max 3, Q[s, a] by selects 3, the done select, γ·v, + r, − q, α·δ, + q,
# the store and its address), the loop 3: 94. The shipped loop is 131 SASS
# instructions a step in float32 (136 in bfloat16), the kernel of one thread
# a maze over tables in device memory took 324 (a bound of 1.2694 ms); a
# count made as K5's 232 an env step was, 240, is more than the shipped
# kernel issues and so no bound
INSTR_K6_STEP = 94
INSTR_K10_ENV = 4       # key and α·δ of one env, an estimate
# The learners' kernels. K7a and K7b are one thread per env, counted as K1 is.
# K9a's forward, K9a's backward and K9b are elementwise passes and sums:
# their counts are the function's own operations on an element (load,
# convert, add, compare, select, store), not the index arithmetic of the
# kernels as written. The forward's SASS path is 58 instructions a thread of
# 16 bytes of output (8 bfloat16, `embed_rows_kernel<__nv_bfloat16, 8>`: the
# index loaded once, two 16-byte loads, four packed conversions, one 16-byte
# store), 7.25 an element, against 155 an element when a thread took one
# element; the function's own is a load, a convert and a store an element.
INSTR_K7A_STEP = 35     # the GAE loop is 131 instructions for four unrolled steps, 37 for a single one
INSTR_K7A_NSTEP = 8     # one (t, env) of the n-step scan: two loads, the done select, multiply, add, store (an estimate)
# act_step is 1,065 instructions with no loop over time; less the table
# staging (124) and the untaken sides of the loops over actions, an env's
# path is about 600 (good to 30 %)
INSTR_K7B_ENV = 600
INSTR_K9A_FWD = 3       # one element of the forward: a load, a convert and a store
INSTR_K9A_BWD = 6       # one (sample, column): a load, a convert and two adds, over both levels
INSTR_K9B_FWD = 8       # one output element of the stamp pass
INSTR_K9B_BWD = 12      # one element of the backward: two loads, two converts, the mask, the adds
# K8a, K8b and the probes, from the same listings
INSTR_K8A_SCORE = 131   # per_score_kernel has no loop: one slot's score, mass and share of the block sum (counted before block 0 zeroed the select's histograms; the other blocks skip that with a compare and a branch)
# An exact top-n needs each score keyed and compared once. The select as written reads
# every score six times (four histogram passes, a count, a compaction) and sorts the
# picks in four more passes: that is the design's cost, and it is not part of the bound.
INSTR_K8A_PICK = 2
INSTR_K8B_WRITE = 75    # replay_write_kernel, one transition
INSTR_K8B_GATHER = 49   # replay_gather_kernel, one row
INSTR_K8B_REFRESH = 119 # prio_refresh_kernel, one row, without its scan of the later rows
INSTR_P1 = 23           # gather_1d_kernel, one element
INSTR_P2 = 48           # take_along_axis1_kernel, one element
INSTR_K12_ELEM = 12     # one trace element: load, decay, flush, bump test, multiply, add, count, store (an estimate)
# K7c (`dqn_act_step_kernel<true>`, the 16-byte row load): an env's act, step
# and stores, from the staging barrier to the end of the env's branch,
# before the block's tree of ended returns. K13 is held to the function's own
# operations: a sample's return is a load, a multiply, an add and a store,
# and the first-visit test an id compare and a valid test for each earlier
# step up to the first valid one with the same id, a count that depends on
# the data (`k13_compares` counts it on the call's own ids). The kernel's
# SASS path (`mc_returns_kernel`, a group's tile staged in shared memory) is
# 100 a sample: its staging (33, the loop unrolled four times in 133), its
# step of the returns' chain (6, 50 for eight), its first-visit test outside
# the scan of earlier steps (41) and the store of its return through shared
# memory (20); and 10 an earlier step the scan reads (82 for eight). That is
# the design's cost, not part of the bound.
INSTR_K7C_ENV = 213
# K7c's store form (`dqn_act_step_kernel<true, gu::Tables, true>`): the same
# path and the 38 instructions that its ring's loads, guard and six stores add
# (893 against 855 instructions in all)
INSTR_K7C_STORE_ENV = 251
INSTR_K13_SAMPLE = 4
INSTR_K13_COMPARE = 2
# K4 above 16,384 states a maze, at full width: the mazes, and PI's cap
N_BIG, PI_BIG_ITERS = 64, 10
HBM_BYTES_PER_S = 3.35e12  # the H100's published device-memory rate


def k11_function_ops(cells) -> int:
    """K11's own operations for one maze, as K4's and K13's are counted:
    each of its 2S - 1 iterations is a xorshift round (6: three shifts,
    three xors), the order's pick (3: a multiply, a shift, the table's
    read) and four neighbour tests (8: a bound compare and a visited test
    each); each of the S - 1 pushes marks the target and moves (2), each of
    the S pops moves to the stack's new top (1). The grids are bytes,
    counted apart. The SASS path of the earlier kernel was 172 an
    iteration (and 10 a tile of its wall fill)."""
    s = cells[0] * cells[1]
    return (2 * s - 1) * 17 + (s - 1) * 2 + s


def k3_function_ops(steps: int, marked: int, injected: bool) -> int:
    """K3's own operations over a call: a walk step is the draw (7: a
    xorshift round and the top two bits) or the read of the injected
    direction (1), the move (3: the bound compare, the row or column add,
    the cell's index) and the first-entry test (2: the read and the
    compare); each cell marked, by a first entry or by the safety net,
    takes the mark and the count (2). `steps` are the steps the call's own
    walks took up to cover (or the cap). The grids are bytes, counted
    apart. The SASS path of the earlier kernel was 54 a seeded step (and 17
    a tile of its grid)."""
    return steps * ((1 if injected else 7) + 5) + marked * 2


def _make_bound():
    """bound(bytes, thread_instructions) -> the least time the card could
    take for that work: the larger of the bytes over the memory rate and
    the thread-instructions over the issue rate (SMs x 4 schedulers x 32
    lanes x the card's maximum SM clock)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue_rate = sms * 4 * 32 * mhz * 1e6
    print(f"bounds: {sms} SMs at {mhz} MHz, {issue_rate!r} thread-instructions/s; {HBM_BYTES_PER_S!r} bytes/s")

    def bound(n_bytes: float, thread_instr: float) -> dict:
        by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        by_ops = thread_instr / issue_rate * 1e3
        return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations"}

    bound.clock_hz = mhz * 1e6  # the SM clock the issue rate assumes
    return bound


def _same_fields(tag: str, got, ref, names) -> float:
    """Every named tensor of `got` equals `ref`'s bit for bit; max |a-b|."""
    err = 0.0
    for name, a, b in zip(names, got, ref):
        if a.dtype == torch.bfloat16:
            a, b = a.float(), b.float()
        if a.dim() == 0:
            a, b = a.reshape(1), b.reshape(1)
        err = max(err, _same(f"{tag} {name}", a, b))
    return err


def _same_scan(tag: str, got, ref) -> float:
    """K1's final state and per-env n_eps, ret_sum, len_sum, bit-exact."""
    for f in _STATE_FIELDS:
        _same(f"{tag} {f}", getattr(got[0], f), getattr(ref[0], f))
    return max(_same(f"{tag} {name}", a, b) for name, a, b in zip(("n_eps", "ret_sum", "len_sum"), got[1:], ref[1:]))


_FAST_FIELDS = ("q", "agent_idx", "agent_code", "t", "rs", "run_ret", "n_eps_env", "ret_sum_env")
_BATCHED_FIELDS = ("q", "agent_idx", "agent_code", "t", "a", "rs", "run_ret", "n_eps_env",
                   "ret_sum_env", "episodes", "mean_return")
_TD_FIELDS = ("q", "agent_idx", "t", "action", "rs", "run_ret", "episodes", "ret_sum")


def _fast_fields(ts):
    st = ts.env_state
    return (ts.q, st.agent_idx, st.agent_code, st.t, ts.rs, ts.run_ret, ts.n_eps_env, ts.ret_sum_env)


def _batched_fields(res):
    st = res.state
    return (st.q, st.env_state.agent_idx, st.env_state.agent_code, st.env_state.t, st.a, st.rs,
            st.run_ret, st.n_eps_env, st.ret_sum_env, res.episodes, res.mean_return)


def _td_fields(ts):
    return (ts.q, ts.env_state.agent_idx, ts.env_state.t, ts.action, ts.rs, ts.run_ret,
            ts.episodes, ts.ret_sum)


def solver_phases(gt, dev, gen, bound, smi):
    """Phases 7-10: K4, K5, K6 and K10 against their plain versions at small
    shapes, the solver main path at full width with its launches counted,
    its outputs against the plain versions, and the times. Returns
    (launches, max abs errors, times) by kernel name. `smi` (the card's name
    and power limit) goes beside every time printed."""
    from griduniverse_tpu_torch import algos, kernels
    from griduniverse_tpu_torch.algos import dp_batched, td, td_batched, td_fast
    from griduniverse_tpu_torch.core.semantics import SemanticsConfig
    from griduniverse_tpu_torch.core.step import step_autoreset
    from griduniverse_tpu_torch.kernels import dp_grid, segment_mean
    from griduniverse_tpu_torch.kernels import td_batched as td_batched_kernels
    from griduniverse_tpu_torch.kernels.dp_grid import grid_greedy_cuda, grid_sweeps_cuda
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.levels import maze as M
    from griduniverse_tpu_torch.ops import bitplane as bp
    from griduniverse_tpu_torch.tools.profile_kernels import _graph_ms

    errs = {"dp_grid": 0.0, "td_scan_fast": 0.0, "td_batched": 0.0, "segment_mean": 0.0}
    times = {}
    t_lap = [time.perf_counter()]

    def lap(what: str) -> None:
        now = time.perf_counter()
        print(f"{what}: {now - t_lap[0]:.1f} s")
        t_lap[0] = now

    def hold(name, tag, got, ref, fields):
        errs[name] = max(errs[name], _same_fields(tag, got, ref, fields))

    # Entry points called with NO `device`: they must land on the card.
    sem = gt.make_semantics()
    walls16 = builders.walls_and_goal_16x16()
    _require(sem.deltas.device.type == "cuda" and walls16.grid.device.type == "cuda",
             "a constructor called without `device` did not place its tensors on the card")
    bl_walls = bp.pack_level(walls16)

    def mazes(seed, cells, n):
        grids, start = M.generate_mazes_device(seed, cells, n, "aldous_broder")
        return gt.Level(grid=grids, start_idx=start.expand(n).contiguous())

    # -- phase 7: each solver kernel against its plain version, small shapes --
    inside_a_launch = False
    for cells in ((4, 4), (8, 8)):
        lv = mazes(21, cells, 256)
        got = algos.value_iteration_batched_grid(sem, lv)
        ref = dp_batched.value_iteration_batched_grid_reference(sem, lv)
        _require(got[2] == ref[2], f"K4 VI {cells}: iters {got[2]} != plain {ref[2]}")
        hold("dp_grid", f"K4 VI {cells}", got[:2], ref[:2], ("V", "policy"))
        mid = got[2] % dp_batched.SWEEPS_PER_LAUNCH
        inside_a_launch |= mid != 0
        pgot = algos.policy_iteration_batched_grid(sem, lv)
        pref = dp_batched.policy_iteration_batched_grid_reference(sem, lv)
        _require(pgot[2] == pref[2], f"K4 PI {cells}: iters {pgot[2]} != plain {pref[2]}")
        hold("dp_grid", f"K4 PI {cells}", pgot[:2], pref[:2], ("V", "policy"))
        print(f"K4 cells={cells} N=256 {dp_grid.packing(lv.num_states)}: VI {got[2]} sweeps (convergence at "
              f"sweep {mid} of a launch of {dp_batched.SWEEPS_PER_LAUNCH}), PI {pgot[2]} policy iterations: V, "
              "policy, iters bit-exact vs plain")
    _require(inside_a_launch, "no K4 shape converged inside a launch")

    # K4 above 16,384 states a maze: the cluster tier (one maze a cluster of
    # bands, up to 16 sweeps a launch), held against the plain sweeps and
    # against the global tier forced on the same mazes: two sidewinder mazes of
    # 65x64 cells (131x129, 16,899 states, one block), two of 80x64 (161x129,
    # two bands of 81 and 80 rows: a height no count of blocks divides), the
    # latter at nine actions, and one maze too large for a cluster (2,401x129,
    # 17 bands would be needed) in the global tier
    def plain_sweeps_of(backup, v, policy, k):
        maxima = []
        for _ in range(k):
            q = backup(v)
            v_new = q.max(dim=-1).values if policy is None else q.gather(2, policy.long()[:, :, None])[:, :, 0]
            maxima.append((v_new - v).abs().max())
            v = v_new
        return v, torch.stack(maxima)

    sem9 = gt.make_semantics(SemanticsConfig(action_deltas=KING_AND_STAY))
    for tag, cells, n_m, sem_k in (("131x129", (65, 64), 2, sem), ("161x129", (80, 64), 2, sem),
                                   ("161x129 nine actions", (80, 64), 2, sem9)):
        g_k, _ = M.generate_mazes_device(31, cells, n_m, "sidewinder")
        h_k, w_k = g_k.shape[1:]
        cp = dp_grid.cluster_plan(h_k, w_k)
        _require(dp_grid.grid_tier(h_k, w_k) == "cluster" and cp.blocks == (1 if h_k == 131 else 2),
                 f"K4 {tag}: tier {dp_grid.grid_tier(h_k, w_k)}, {cp}")
        backup_k = dp_batched._grid_backup(sem_k, g_k, 0.99)
        v0_k = torch.zeros((n_m, h_k * w_k), device=dev)
        before = kernels.LAUNCHES["dp_grid"]
        got_k = grid_sweeps_cuda(sem_k, g_k, v0_k, None, 0.99, 19)
        _require(kernels.LAUNCHES["dp_grid"] == before + 2, "K4 cluster tier: not one launch a 16 sweeps")
        hold("dp_grid", f"K4 cluster tier {tag} 19 VI sweeps", got_k, plain_sweeps_of(backup_k, v0_k, None, 19),
             ("V", "sweep maxima"))
        hold("dp_grid", f"K4 cluster tier {tag} 19 VI sweeps vs the global tier", got_k,
             grid_sweeps_cuda(sem_k, g_k, v0_k, None, 0.99, 19, tier="global"), ("V", "sweep maxima"))
        pol_k = torch.randint(0, sem_k.num_actions, (n_m, h_k * w_k), generator=gen, device=dev, dtype=torch.int32)
        got_e = grid_sweeps_cuda(sem_k, g_k, got_k[0], pol_k, 0.99, 5)
        hold("dp_grid", f"K4 cluster tier {tag} 5 evaluation sweeps", got_e,
             plain_sweeps_of(backup_k, got_k[0], pol_k, 5), ("V", "sweep maxima"))
        hold("dp_grid", f"K4 cluster tier {tag} 5 evaluation sweeps vs the global tier", got_e,
             grid_sweeps_cuda(sem_k, g_k, got_k[0], pol_k, 0.99, 5, tier="global"), ("V", "sweep maxima"))
        print(f"K4 cluster tier N={n_m} {tag} ({cp}): 19 VI sweeps in 2 launches and 5 evaluation sweeps (V and "
              "every sweep's maximum) bit-exact vs plain and vs the global tier")
    g_huge = torch.zeros((1, 2_401, 129), dtype=torch.int32, device=dev)
    g_huge[0, 2_400, 128] = 3  # a goal in the far corner
    g_huge[0, 1:2_400:2, 1:128] = 1  # walls on every other row, each row open at its ends
    _require(dp_grid.grid_tier(2_401, 129) == "global", "K4: the 2,401x129 maze is not in the global tier")
    v_huge = torch.zeros((1, 2_401 * 129), device=dev)
    before = kernels.LAUNCHES["dp_grid"]
    got_huge = grid_sweeps_cuda(sem, g_huge, v_huge, None, 0.99, 4)
    _require(kernels.LAUNCHES["dp_grid"] == before + 4, "K4 global tier: not one launch a sweep")
    hold("dp_grid", "K4 global tier 2401x129 4 VI sweeps", got_huge,
         plain_sweeps_of(dp_batched._grid_backup(sem, g_huge, 0.99), v_huge, None, 4), ("V", "sweep maxima"))
    print("K4 global tier N=1 2401x129 (more blocks than a cluster holds): 4 VI sweeps, one launch a sweep, "
          "bit-exact vs plain")
    # the solvers through their public entries at 131x129: VI, PI, the greedy step
    g17, st17 = M.generate_mazes_device(31, (65, 64), 2, "sidewinder")
    lv17 = gt.Level(grid=g17, start_idx=st17.expand(2).contiguous())
    s17 = lv17.num_states
    backup17 = dp_batched._grid_backup(sem, g17, 0.99)
    v17, _ = grid_sweeps_cuda(sem, g17, torch.zeros((2, s17), device=dev), None, 0.99, 9)
    pol17 = torch.randint(0, 4, (2, s17), generator=gen, device=dev, dtype=torch.int32)
    greedy17, changed17 = grid_greedy_cuda(sem, g17, v17, 0.99, pol17)
    want17 = dp_batched.first_argmax(backup17(v17))
    hold("dp_grid", "K4 greedy step 131x129", (greedy17, changed17),
         (want17, (want17 != pol17).any().to(torch.int32).reshape(1)), ("policy", "changed"))
    _require(int(changed17) == 1 and int(grid_greedy_cuda(sem, g17, v17, 0.99, want17)[1]) == 0,
             "K4 above 16,384 states: the `changed` flag")
    got = algos.value_iteration_batched_grid(sem, lv17)
    ref = dp_batched.value_iteration_batched_grid_reference(sem, lv17)
    _require(got[2] == ref[2], f"K4 VI 131x129: iters {got[2]} != plain {ref[2]}")
    hold("dp_grid", "K4 VI 131x129", got[:2], ref[:2], ("V", "policy"))
    kw_pi = dict(max_eval_iters=300, max_policy_iters=3)
    pgot = algos.policy_iteration_batched_grid(sem, lv17, **kw_pi)
    pref = dp_batched.policy_iteration_batched_grid_reference(sem, lv17, **kw_pi)
    _require(pgot[2] == pref[2], f"K4 PI 131x129: iters {pgot[2]} != plain {pref[2]}")
    hold("dp_grid", "K4 PI 131x129", pgot[:2], pref[:2], ("V", "policy"))
    print(f"K4 N=2 131x129 ({s17} states): the greedy step and its `changed` flag, VI ({got[2]} sweeps) and PI "
          "capped at 3 policy iterations: bit-exact vs plain")

    kw5 = dict(alpha=0.1, gamma=0.99, epsilon=0.1, max_episode_steps=MAX_EPISODE_STEPS)
    for algo in td_fast.ALGOS:
        ts = td_fast.fast_td_init(sem, bl_walls, 3, 4096)
        before = kernels.LAUNCHES["td_scan_fast"]
        got = td_fast.td_scan_fast(sem, bl_walls, ts, 500, algo=algo, **kw5)
        _require(kernels.LAUNCHES["td_scan_fast"] == before + 1, f"K5 {algo}: not one launch a scan")
        ref = td_fast.td_scan_fast_reference(sem, bl_walls, ts, 500, algo=algo, **kw5)
        hold("td_scan_fast", f"K5 {algo}", _fast_fields(got), _fast_fields(ref), _FAST_FIELDS)
        again = td_fast.td_scan_fast(sem, bl_walls, ts, 500, algo=algo, **kw5)
        chunked = td_fast.td_scan_fast(
            sem, bl_walls, td_fast.td_scan_fast(sem, bl_walls, ts, 200, algo=algo, **kw5), 300, algo=algo, **kw5)
        _same_fields(f"K5 {algo} second run", _fast_fields(again), _fast_fields(got), _FAST_FIELDS)
        _same_fields(f"K5 {algo} chunked", _fast_fields(chunked), _fast_fields(got), _FAST_FIELDS)
        print(f"K5 {algo} B=4096 T=500: one launch, bit-exact vs plain; a second run and a 200+300 chunked run give "
              "the same bits")

    n6, t6 = 1024, 500
    lv6 = mazes(22, (4, 4), n6)
    draws = (
        torch.rand((t6, n6), generator=gen, device=dev) < 0.1,
        torch.randint(0, 4, (t6, n6), generator=gen, device=dev, dtype=torch.int32),
        torch.rand((n6,), generator=gen, device=dev) < 0.1,
        torch.randint(0, 4, (n6,), generator=gen, device=dev, dtype=torch.int32),
    )
    for algo in td_batched.ALGOS:
        for dtype in ("float32", "bfloat16"):
            for d in (None, draws):
                kw = dict(algo=algo, dtype=dtype, max_episode_steps=MAX_EPISODE_STEPS, draws=d)
                got = algos.q_learning_batched(sem, lv6, 5, t6, **kw)
                ref = td_batched.q_learning_batched_reference(sem, lv6, 5, t6, **kw)
                hold("td_batched", f"K6 {algo} {dtype} injected={d is not None}",
                     _batched_fields(got), _batched_fields(ref), _BATCHED_FIELDS)
        print(f"K6 {algo} N={n6} T={t6}: float32 and bfloat16, native and injected actions, bit-exact vs plain")

    for b in (1, 32, 4096):
        q = torch.randn((256, 4), generator=gen, device=dev)
        s = torch.randint(0, 8, (b,), generator=gen, device=dev, dtype=torch.int32)  # heavy collisions
        a = torch.randint(0, 4, (b,), generator=gen, device=dev, dtype=torch.int32)
        delta = torch.randn((b,), generator=gen, device=dev)
        mask = torch.rand((b,), generator=gen, device=dev) < 0.5
        hold("segment_mean", f"K10 B={b}", (td.apply_td_updates(q, s, a, delta, 0.1),),
             (td.apply_td_updates_reference(q, s, a, delta, 0.1),), ("q",))
        hold("segment_mean", f"K10 masked B={b}", (td.apply_td_updates_masked(q, s, a, delta, 0.1, mask),),
             (td.apply_td_updates_reference(q, s, a, delta, 0.1, mask),), ("q",))
    print("K10 B=1, 32, 4096, plain and masked: bit-exact vs plain")

    # -- phase 8: the solver main path at full width, counted ------------------
    lap("phase 7")
    torch.cuda.synchronize()
    kernels.reset_launches()
    n64, n33, n_pi, steps = 65_536, 8_192, 4_096, 2_000
    lv64 = mazes(2026, (4, 4), n64)
    _require(bool((lv64.grid[:, 7, 7] == 3).all()), "the 9x9 mazes have no goal at (7, 7)")
    lv33 = mazes(2027, (16, 16), n33)
    lv_pi = gt.Level(grid=lv64.grid[:n_pi].contiguous(), start_idx=lv64.start_idx[:n_pi].contiguous())

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    def check_policies(tag, lv, policy, n_sample=1024, max_steps=None):
        sample = gt.Level(grid=lv.grid[:n_sample], start_idx=lv.start_idx[:n_sample])
        _, ret, length, done = algos.run_greedy_episode(sem, sample, policy[:n_sample],
                                                        max_steps=max_steps or lv.num_states)
        _require(bool(done.all()), f"{tag}: a sampled greedy policy does not reach its goal")
        _require(bool((ret == 10.0 - (length - 1)).all()), f"{tag}: a sampled return is not goal minus steps")

    outs = {}  # the main path's results, held against the plain versions in phase 9
    ms, outs["vi64"] = timed(lambda: algos.value_iteration_batched_grid(sem, lv64))
    _require(10 < outs["vi64"][2] < 60, f"VI 9x9: implausible iters {outs['vi64'][2]}")
    check_policies("VI 9x9", lv64, outs["vi64"][1])
    print(f"K4 main VI N={n64} 9x9: {outs['vi64'][2]} sweeps, {ms!r} ms, {n64 / ms * 1e3!r} mazes/s; 1024 sampled policies reach their goals ({smi})")
    ms, outs["vi33"] = timed(lambda: algos.value_iteration_batched_grid(sem, lv33, max_iters=400))
    _require(40 < outs["vi33"][2] < 400, f"VI 33x33: implausible iters {outs['vi33'][2]}")
    check_policies("VI 33x33", lv33, outs["vi33"][1], 256)
    print(f"K4 main VI N={n33} 33x33: {outs['vi33'][2]} sweeps, {ms!r} ms, {n33 / ms * 1e3!r} mazes/s; 256 sampled policies reach their goals ({smi})")
    ms, outs["pi"] = timed(lambda: algos.policy_iteration_batched_grid(sem, lv_pi))
    _require(2 <= outs["pi"][2] < 100, f"PI: implausible iters {outs['pi'][2]}")
    check_policies("PI 9x9", lv_pi, outs["pi"][1])
    print(f"K4 main PI N={n_pi} 9x9: {outs['pi'][2]} policy iterations, {ms!r} ms, {n_pi / ms * 1e3!r} mazes/s ({smi})")
    # above 16,384 states a maze, K4's cluster tier: 64 sidewinder mazes of 80x64
    # cells (161x129, 20,769 states, two blocks a maze; sidewinder takes at most
    # 64 cell columns). VI runs to convergence; PI to a cap of PI_BIG_ITERS
    # policy iterations, as these mazes need more than the reference's 100 to settle
    k = dp_batched.SWEEPS_PER_LAUNCH
    g_big, st_big = M.generate_mazes_device(2029, (80, 64), N_BIG, "sidewinder")
    lv_big = gt.Level(grid=g_big, start_idx=st_big.expand(N_BIG).contiguous())
    _require(dp_grid.grid_tier(161, 129) == "cluster", "K4 161x129: not the cluster tier")
    before = kernels.LAUNCHES["dp_grid"]
    ms, outs["vi_big"] = timed(lambda: algos.value_iteration_batched_grid(sem, lv_big))
    it = outs["vi_big"][2]
    # launches of 16 sweeps until the one where it converged, that many sweeps rerun, and the greedy step
    expect = -(-it // k) + (1 if it % k else 0) + 1
    _require(kernels.LAUNCHES["dp_grid"] - before == expect,
             f"K4 cluster VI: {kernels.LAUNCHES['dp_grid'] - before} launches, expected {expect}")
    _require(100 < it < 10_000, f"VI 161x129: implausible iters {it}")
    check_policies("VI 161x129", lv_big, outs["vi_big"][1], N_BIG, max_steps=it + 1)
    print(f"K4 main VI N={N_BIG} 161x129 ({lv_big.num_states} states, cluster tier, "
          f"{dp_grid.cluster_plan(161, 129)}): {it} sweeps in {expect} launches, {ms!r} ms, "
          f"{N_BIG / ms * 1e3!r} mazes/s; every greedy policy reaches its goal ({smi})")
    before_pi = kernels.LAUNCHES["dp_grid"]
    ms, outs["pi_big"] = timed(lambda: algos.policy_iteration_batched_grid(sem, lv_big, max_policy_iters=PI_BIG_ITERS))
    _require(outs["pi_big"][2] == PI_BIG_ITERS, f"PI 161x129: {outs['pi_big'][2]} policy iterations")
    # the cluster tier's launches on the path: VI's and PI's sweeps, not their greedy steps (one a policy iteration)
    cluster_launches = expect - 1 + kernels.LAUNCHES["dp_grid"] - before_pi - PI_BIG_ITERS
    print(f"K4 main PI N={N_BIG} 161x129 (cluster tier): {PI_BIG_ITERS} policy iterations (the cap), "
          f"{kernels.LAUNCHES['dp_grid'] - before_pi} launches, {ms!r} ms ({smi})")

    ms, outs["fast"] = timed(lambda: algos.compile_q_learning_fast(sem, bl_walls, n64, steps, **kw5)(7))
    res = outs["fast"]
    _require(int(res.episodes) > 0 and bool(torch.isfinite(res.q).all()), "K5 main: no episodes or a non-finite Q")
    print(f"K5 main walls16 B={n64} T={steps}: episodes {int(res.episodes)}, mean_return {float(res.mean_return)!r}, "
          f"{ms!r} ms, {n64 * steps / ms * 1e3!r} transitions/s ({smi})")
    # the same run in two chunks: equal bits, and the return rises
    run = algos.compile_fast_td_run(sem, bl_walls, steps // 2, **kw5)
    half1 = run(algos.fast_td_init(sem, bl_walls, 7, n64))
    half2 = run(half1)
    _same("K5 main chunked q", half2.q, res.q)
    _same("K5 main chunked episodes", half2.n_eps_env.sum(), res.episodes)
    r1 = algos.fast_td_result(half1)
    mean2 = (half2.ret_sum_env.sum() - half1.ret_sum_env.sum()) / (half2.n_eps_env.sum() - half1.n_eps_env.sum())
    _require(float(mean2) > float(r1.mean_return), f"K5 main: return did not rise ({float(r1.mean_return)} -> {float(mean2)})")
    print(f"K5 main: chunked 1000+1000 equals the unbroken run bit for bit; mean return {float(r1.mean_return)!r} -> {float(mean2)!r}")

    # above the 8,192 Q entries of the staged form: one 65x65 backtracker
    # maze (32x32 cells, made by K11) shared by 65,536 envs, 16,900 entries
    g65, start65 = M.generate_mazes_device(2028, (32, 32), 1)
    bl65 = bp.pack_level(gt.Level(grid=g65[0].contiguous(), start_idx=start65))
    steps65 = 300
    ms, outs["fast65"] = timed(lambda: algos.compile_q_learning_fast(sem, bl65, n64, steps65, **kw5)(7))
    res = outs["fast65"]
    _require(res.q.numel() == 16_900 and bool(torch.isfinite(res.q).all()) and bool((res.q != 0).any()),
             "K5 main 65x65: a non-finite or untouched Q")
    print(f"K5 main 65x65 maze B={n64} T={steps65}: Q of {res.q.numel()} entries, episodes {int(res.episodes)}, "
          f"{ms!r} ms, {n64 * steps65 / ms * 1e3!r} transitions/s ({smi})")

    kw6 = dict(max_episode_steps=MAX_EPISODE_STEPS)
    for dtype in ("float32", "bfloat16"):
        ms, res = timed(lambda: algos.q_learning_batched(sem, lv64, 9, steps, dtype=dtype, **kw6))
        outs["batched_" + dtype] = res
        h1 = algos.q_learning_batched(sem, lv64, 9, steps // 2, dtype=dtype, **kw6)
        h2 = algos.q_learning_batched(sem, lv64, 9, steps // 2, dtype=dtype, state0=h1.state, **kw6)
        _same_fields(f"K6 main {dtype} chunked", _batched_fields(h2), _batched_fields(res), _BATCHED_FIELDS)
        mean2 = (h2.state.ret_sum_env.sum() - h1.state.ret_sum_env.sum()) / (h2.episodes - h1.episodes)
        _require(float(mean2) > float(h1.mean_return), f"K6 main {dtype}: return did not rise")
        print(f"K6 main N={n64} T={steps} {dtype}: episodes {int(res.episodes)}, {ms!r} ms, "
              f"{n64 * steps / ms * 1e3!r} transitions/s; chunked equals unbroken; "
              f"mean return {float(h1.mean_return)!r} -> {float(mean2)!r} ({smi})")

    late = 50  # the last steps of the run are a chunk of their own, so that phase 9 can redo them
    td_steps = {32: 1_000, 4096: steps}
    for b, n_steps in td_steps.items():
        ts0 = td.td_init(sem, walls16, 11, b)
        ms1, h1 = timed(lambda: td.td_run(sem, walls16, ts0, n_steps // 2))
        ms2, before_late = timed(lambda: td.td_run(sem, walls16, h1, n_steps // 2 - late))
        ms3, h2 = timed(lambda: td.td_run(sem, walls16, before_late, late))
        ms2 += ms3
        outs[f"td_{b}"] = (ts0, before_late, h2)
        res = algos.q_learning(sem, walls16, 11, num_steps=n_steps, batch_size=b)
        _same(f"td_run B={b} chunked q", h2.q, res.q)
        _require(int(h2.episodes) > 0 and bool(torch.isfinite(h2.q).all()), f"td_run B={b}: no episodes")
        mean1 = h1.ret_sum / h1.episodes.clamp(min=1)
        mean2 = (h2.ret_sum - h1.ret_sum) / (h2.episodes - h1.episodes).clamp(min=1)
        if b == 4096:
            _require(float(mean2) > float(mean1), f"td_run B={b}: return did not rise")
        print(f"td_run main walls16 B={b} T={n_steps}: episodes {int(h2.episodes)}, {ms1 + ms2!r} ms, "
              f"{b * n_steps / (ms1 + ms2) * 1e3!r} transitions/s; `q_learning` equals the three chunks; "
              f"mean return {float(mean1)!r} -> {float(mean2)!r} ({smi})")

    # K10 over 64 chunks of envs: `q_learning` at 65,536 envs
    b_wide, steps_wide, late_wide = 65_536, 200, 5
    ts0 = td.td_init(sem, walls16, 11, b_wide)
    ms1, before_late = timed(lambda: td.td_run(sem, walls16, ts0, steps_wide - late_wide))
    ms2, end = timed(lambda: td.td_run(sem, walls16, before_late, late_wide))
    outs["td_wide"] = (ts0, before_late, end)
    res = algos.q_learning(sem, walls16, 11, num_steps=steps_wide, batch_size=b_wide)
    _same(f"td_run B={b_wide} chunked q", end.q, res.q)
    _require(int(end.episodes) > 0 and bool(torch.isfinite(end.q).all()), f"td_run B={b_wide}: no episodes")
    print(f"td_run main walls16 B={b_wide} T={steps_wide}: episodes {int(end.episodes)}, {ms1 + ms2!r} ms, "
          f"{b_wide * steps_wide / (ms1 + ms2) * 1e3!r} transitions/s; `q_learning` equals the two chunks ({smi})")

    torch.cuda.synchronize()
    launches = {name: kernels.LAUNCHES[name] for name in errs}
    print(f"launches on the solver main path: {launches}")
    _require(all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}")
    # one launch a scan: the unbroken run, its two chunks and the 65x65 run
    _require(launches["td_scan_fast"] == 4, f"K5: {launches['td_scan_fast']} launches on the main path, expected 4")

    # -- phase 9: the main path's outputs against the plain versions, timed ----
    lap("phase 8")
    plain_ms, ref = timed(lambda: dp_batched.value_iteration_batched_grid_reference(sem, lv64))
    _require(ref[2] == outs["vi64"][2], "K4 main VI 9x9: iters differ from plain")
    hold("dp_grid", "K4 main VI 9x9", outs["vi64"][:2], ref[:2], ("V", "policy"))
    print(f"K4 main VI 9x9: V, policy and iters bit-exact vs plain ({plain_ms!r} ms) ({smi})")
    plain_ms, ref = timed(lambda: dp_batched.value_iteration_batched_grid_reference(sem, lv33, max_iters=400))
    _require(ref[2] == outs["vi33"][2], "K4 main VI 33x33: iters differ from plain")
    hold("dp_grid", "K4 main VI 33x33", outs["vi33"][:2], ref[:2], ("V", "policy"))
    print(f"K4 main VI 33x33: V, policy and iters bit-exact vs plain ({plain_ms!r} ms) ({smi})")
    ref = dp_batched.policy_iteration_batched_grid_reference(sem, lv_pi)
    _require(ref[2] == outs["pi"][2], "K4 main PI: iters differ from plain")
    hold("dp_grid", "K4 main PI", outs["pi"][:2], ref[:2], ("V", "policy"))
    print("K4 main PI: V, policy and iters bit-exact vs plain")
    plain_ms, ref = timed(lambda: dp_batched.value_iteration_batched_grid_reference(sem, lv_big))
    _require(ref[2] == outs["vi_big"][2], "K4 main VI 161x129: iters differ from plain")
    hold("dp_grid", "K4 main VI 161x129", outs["vi_big"][:2], ref[:2], ("V", "policy"))
    plain_pi_ms, ref = timed(lambda: dp_batched.policy_iteration_batched_grid_reference(
        sem, lv_big, max_policy_iters=PI_BIG_ITERS))
    _require(ref[2] == outs["pi_big"][2], "K4 main PI 161x129: iters differ from plain")
    hold("dp_grid", "K4 main PI 161x129", outs["pi_big"][:2], ref[:2], ("V", "policy"))
    print(f"K4 main 161x129 (cluster tier): VI and PI's V, policy and iters bit-exact vs plain (plain VI {plain_ms!r} ms, "
          f"PI {plain_pi_ms!r} ms) ({smi})")

    ts = algos.fast_td_init(sem, bl_walls, 7, n64)
    ms5, got = _cuda_ms(lambda: td_fast.td_scan_fast(sem, bl_walls, ts, steps, algo="q_learning", **kw5), 3)
    plain5, ref = _cuda_ms(lambda: td_fast.td_scan_fast_reference(sem, bl_walls, ts, steps, algo="q_learning", **kw5), 1, warm=False)
    hold("td_scan_fast", "K5 main", _fast_fields(got), _fast_fields(ref), _FAST_FIELDS)
    _same("K5 main q vs compile_q_learning_fast", got.q, outs["fast"].q)
    n_entries = 256 * 4
    times["td_scan_fast"] = dict(
        ms=ms5, plain_ms=plain5, shape=f"walls16 B={n64} T={steps}", library_ms=None,
        # env state in and out (7 words each way) and Q in and out, once; per
        # step every env's transition and ONE update of each Q entry (that the
        # kernel rebuilds Q in every block is its design's cost, not the work's)
        **bound(n64 * 14 * 4 + 2 * n_entries * 4,
                steps * (INSTR_K5_STEP * n64 + INSTR_K5_ENTRY * n_entries)))
    print(f"K5 main: the {steps}-step scan at B={n64} bit-exact vs plain; {n64 * steps / ms5 * 1e3!r} transitions/s ({smi})")
    ts = algos.fast_td_init(sem, bl65, 7, n64)
    ms65, got = _cuda_ms(lambda: td_fast.td_scan_fast(sem, bl65, ts, steps65, algo="q_learning", **kw5), 3)
    plain65, ref = _cuda_ms(lambda: td_fast.td_scan_fast_reference(sem, bl65, ts, steps65, algo="q_learning", **kw5), 1, warm=False)
    hold("td_scan_fast", "K5 main 65x65", _fast_fields(got), _fast_fields(ref), _FAST_FIELDS)
    _same("K5 main 65x65 q vs compile_q_learning_fast", got.q, outs["fast65"].q)
    n65 = got.q.numel()
    t5 = bound(n64 * 14 * 4 + 2 * n65 * 4, steps65 * (INSTR_K5_STEP * n64 + INSTR_K5_ENTRY * n65))
    print(f"time td_scan_fast at one 65x65 maze B={n64} T={steps65}, {n65} Q entries (global-memory form): kernel {ms65!r} ms, "
          f"plain {plain65!r} ms, bound {t5['bound_ms']!r} ms by {t5['bound_by']}, library None ms; bit-exact vs plain "
          f"and vs compile_q_learning_fast ({smi})")

    for dtype in ("float32", "bfloat16"):
        ms6, got = _cuda_ms(lambda: algos.q_learning_batched(sem, lv64, 9, steps, dtype=dtype, **kw6), 2)
        plain6, ref = _cuda_ms(lambda: td_batched.q_learning_batched_reference(sem, lv64, 9, steps, dtype=dtype, **kw6), 1, warm=False)
        hold("td_batched", f"K6 main {dtype}", _batched_fields(got), _batched_fields(ref), _BATCHED_FIELDS)
        _same_fields(f"K6 main {dtype} rerun", _batched_fields(got), _batched_fields(outs["batched_" + dtype]), _BATCHED_FIELDS)
        q_bytes = got.q.numel() * got.q.element_size()
        t6 = dict(
            ms=ms6, plain_ms=plain6, shape=f"{n64} mazes 9x9 T={steps} {dtype}", library_ms=None,
            # the tables once in and once out, the packed levels, the state both ways
            **bound(2 * q_bytes + n64 * (6 * 4 + 2 * 8 * 4), INSTR_K6_STEP * n64 * steps))
        print(f"K6 main {dtype}: the {steps}-step run at N={n64} bit-exact vs plain; kernel {ms6!r} ms "
              f"({n64 * steps / ms6 * 1e3!r} transitions/s), plain {plain6!r} ms, bound {t6['bound_ms']!r} ms by {t6['bound_by']} ({smi})")
        if dtype == "float32":
            times["td_batched"] = t6
    layout = td_batched_kernels.plan(lv64.num_states, sem.num_actions, "float32", n64,
                                     sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    print(f"K6 main layout (float32): {layout}")

    # K6 where no 32 tables fit a block: every maze on device memory (8,192 33x33
    # mazes; a time limit of 64 steps, so that episodes end and reset in the run)
    steps33, kw33 = 400, dict(max_episode_steps=64)
    layout33 = td_batched_kernels.plan(lv33.num_states, sem.num_actions, "float32", n33)
    _require(layout33.tier == "global", f"K6 33x33: {layout33}")
    ms33, got = _cuda_ms(lambda: algos.q_learning_batched(sem, lv33, 9, steps33, **kw33), 2)
    plain33, ref = _cuda_ms(lambda: td_batched.q_learning_batched_reference(sem, lv33, 9, steps33, **kw33), 1, warm=False)
    hold("td_batched", "K6 33x33", _batched_fields(got), _batched_fields(ref), _BATCHED_FIELDS)
    _require(int(got.episodes) > 0, "K6 33x33: no episode ended")
    # the tables once each way, the packed levels (2 bits a tile), the state both ways
    t33 = bound(2 * got.q.numel() * 4 + lv33.grid.numel() // 4 + n33 * 2 * 8 * 4, INSTR_K6_STEP * n33 * steps33)
    print(f"K6 33x33 (the global tier, {layout33}): the {steps33}-step run at N={n33} bit-exact vs plain; kernel "
          f"{ms33!r} ms, plain {plain33!r} ms, bound {t33['bound_ms']!r} ms by {t33['bound_by']} ({smi})")

    lap("phase 9, the K4, K5 and K6 holds")
    # K10 at full width: the main path's `td_run` redone one step at a time,
    # every step's new Q held against the plain update rule on that step's own
    # (q, s, a, δ). The plain rule needs one pass per env of the fullest cell
    # (thousands while all envs share the start state). So at B=32 the first
    # 300 and the last 50 of 1,000 steps are held; at B=4096 the first 8,
    # where every env collides, and the main run's last 50, where the envs
    # are spread over the level; at B=65,536 the first and the last 5.
    def held_steps(tag, ts, n_steps):
        for _ in range(n_steps):
            s, a = ts.env_state.agent_idx, ts.action
            _, out = step_autoreset(sem, walls16, ts.env_state, a)
            delta = td.td_error_qlearning(ts.q, s, a, out.reward, out.obs, out.done, 0.99)
            ref_q = td.apply_td_updates_reference(ts.q, s, a, delta, 0.1)
            ts = td.td_run(sem, walls16, ts, 1)
            hold("segment_mean", tag, (ts.q,), (ref_q,), ("q",))
        return ts

    ts0, before_late, end = outs["td_32"]
    held_steps("K10 main td_run B=32 first steps", ts0, 300)
    redone = held_steps("K10 main td_run B=32 last steps", before_late, late)
    _same_fields("K10 main td_run B=32 redone", _td_fields(redone), _td_fields(end), _TD_FIELDS)
    print(f"K10 main: td_run B=32, the first 300 and the last {late} of {td_steps[32]} steps' Q bit-exact vs the "
          "plain update rule; the last steps redone equal the main path's")
    ts0, before_late, end = outs["td_4096"]
    held_steps("K10 main td_run B=4096 first steps", ts0, 8)
    redone = held_steps("K10 main td_run B=4096 last steps", before_late, late)
    _same_fields("K10 main td_run B=4096 redone", _td_fields(redone), _td_fields(end), _TD_FIELDS)
    cells = int(torch.unique(end.env_state.agent_idx).numel())
    print(f"K10 main: td_run B=4096, the first 8 and the last {late} of {steps} steps bit-exact vs the "
          f"plain update rule (the envs end on {cells} distinct cells); the last steps redone equal the main path's")
    ts0, before_late, end = outs["td_wide"]
    held_steps(f"K10 main td_run B={b_wide} first step", ts0, 1)
    redone = held_steps(f"K10 main td_run B={b_wide} last steps", before_late, late_wide)
    _same_fields(f"K10 main td_run B={b_wide} redone", _td_fields(redone), _td_fields(end), _TD_FIELDS)
    print(f"K10 main: td_run B={b_wide} (64 chunks of envs), the first and the last {late_wide} of "
          f"{steps_wide} steps bit-exact vs the plain update rule; the last steps redone equal the main path's")

    for name, err in k10_tier_holds(dev, smi).items():
        errs[name] = max(errs.get(name, 0.0), err)

    # -- phase 10: K4 and K10 times at the main path's shapes ------------------
    lap("phase 9, the K10 holds")
    k = dp_batched.SWEEPS_PER_LAUNCH
    v0 = torch.zeros((n64, 81), dtype=torch.float32, device=dev)
    grids = lv64.grid.contiguous()
    backup = dp_batched._grid_backup(sem, grids, 0.99)

    def plain_sweeps():
        v, maxima = v0, []
        for _ in range(k):
            v_new = backup(v).max(dim=-1).values
            maxima.append((v_new - v).abs().max())
            v = v_new
        return v, torch.stack(maxima)

    pk = dp_grid.packing(81)
    _require(pk.mazes == 3 and pk.cells == 1, f"K4 9x9: packing {pk}, not three mazes a block")
    ms4, got = _cuda_ms(lambda: grid_sweeps_cuda(sem, grids, v0, None, 0.99, k), 10)
    plain4, ref = _cuda_ms(plain_sweeps, 2)
    hold("dp_grid", "K4 timed sweeps", got, ref, ("V", "sweep maxima"))
    times["dp_grid"] = dict(
        ms=ms4, plain_ms=plain4, shape=f"{k} VI sweeps, {n64} mazes 9x9", library_ms=None,
        # grids and V in, V out; per sweep one backup of every cell
        **bound(n64 * 81 * 4 * 3, k * n64 * 81 * k4_function_ops(4)))
    sass4 = bound(n64 * 81 * 4 * 3, k * n64 * 81 * INSTR_K4_CELL)
    print(f"K4 {k} VI sweeps, {n64} mazes 9x9, {pk}: kernel {ms4!r} ms; bound {times['dp_grid']['bound_ms']!r} ms "
          f"by the function's {k4_function_ops(4)} operations a cell and sweep, {sass4['bound_ms']!r} ms by the "
          f"kernel's {INSTR_K4_CELL} SASS instructions ({smi})")
    # the other two solver shapes: 33x33 (a table of decoded actions, five
    # cells a thread) and PI's evaluation sweeps over 4,096 9x9 mazes
    for tag, g4, pol4 in (("VI sweeps, 8192 mazes 33x33", lv33.grid.contiguous(), None),
                          ("evaluation sweeps, 4096 mazes 9x9", lv_pi.grid,
                           torch.randint(0, 4, (n_pi, 81), generator=gen, device=dev, dtype=torch.int32))):
        n4, s4 = g4.shape[0], g4.shape[1] * g4.shape[2]
        v04 = torch.zeros((n4, s4), dtype=torch.float32, device=dev)
        ms_t, got = _cuda_ms(lambda: grid_sweeps_cuda(sem, g4, v04, pol4, 0.99, k), 10)
        plain_t, ref = _cuda_ms(lambda: plain_sweeps_of(dp_batched._grid_backup(sem, g4, 0.99), v04, pol4, k), 2)
        hold("dp_grid", f"K4 timed {tag}", got, ref, ("V", "sweep maxima"))
        # grids and V in (and the policy), V out
        t4 = bound(n4 * s4 * 4 * (3 if pol4 is None else 4), k * n4 * s4 * k4_function_ops(4 if pol4 is None else 1))
        print(f"time dp_grid at {k} {tag} ({dp_grid.packing(s4)}): kernel {ms_t!r} ms, plain {plain_t!r} ms, "
              f"bound {t4['bound_ms']!r} ms by {t4['bound_by']}, library None ms; bit-exact vs plain ({smi})")
    # K4's cluster tier at the main path's 64 x 161x129: 16 VI sweeps as timed and
    # in a CUDA graph, beside the global tier forced on the same mazes
    s_big = lv_big.num_states
    v0_big = torch.zeros((N_BIG, s_big), dtype=torch.float32, device=dev)
    g_big = lv_big.grid.contiguous()
    backup_big = dp_batched._grid_backup(sem, g_big, 0.99)
    ms4c, got = _cuda_ms(lambda: grid_sweeps_cuda(sem, g_big, v0_big, None, 0.99, k), 10)
    graph4c = _graph_ms(lambda: grid_sweeps_cuda(sem, g_big, v0_big, None, 0.99, k))
    plain4c, ref = _cuda_ms(lambda: plain_sweeps_of(backup_big, v0_big, None, k), 2)
    err4c = _same_fields("K4 cluster tier timed sweeps", got, ref, ("V", "sweep maxima"))
    errs["dp_grid"] = max(errs["dp_grid"], err4c)
    ms4g, got_g = _cuda_ms(lambda: grid_sweeps_cuda(sem, g_big, v0_big, None, 0.99, k, tier="global"), 10)
    graph4g = _graph_ms(lambda: grid_sweeps_cuda(sem, g_big, v0_big, None, 0.99, k, tier="global"))
    _same_fields("K4 global tier timed sweeps vs the cluster tier", got_g, got, ("V", "sweep maxima"))
    # grids and V in, V out; per sweep one backup of every cell (the function's 18 operations)
    t4c = dict(ms=ms4c, graph_ms=graph4c, plain_ms=plain4c, library_ms=None, launches=cluster_launches,
               max_abs_err=err4c, shape=f"{k} VI sweeps, {N_BIG} mazes 161x129, cluster tier "
                                       f"({dp_grid.cluster_plan(161, 129).blocks} blocks a maze)",
               **bound(N_BIG * s_big * 4 * 3, k * N_BIG * s_big * k4_function_ops(4)))
    times["dp_grid"] = [times["dp_grid"], t4c]
    print(f"time dp_grid cluster tier at {k} VI sweeps, {N_BIG} mazes 161x129 (one launch): kernel {ms4c!r} ms as "
          f"timed, {graph4c!r} ms in a CUDA graph of ten; the global tier forced ({k} launches) {ms4g!r} ms as "
          f"timed, {graph4g!r} ms in a graph; plain {plain4c!r} ms, bound {t4c['bound_ms']!r} ms by "
          f"{t4c['bound_by']}, library None ms; bit-exact vs plain and vs the global tier ({smi})")
    for tag, lv, key in (("9x9", lv64, "vi64"), ("33x33", lv33, "vi33")):
        cap = 400 if tag == "33x33" else 10_000
        ms, _ = _cuda_ms(lambda: algos.value_iteration_batched_grid(sem, lv, max_iters=cap), 3)
        n = lv.grid.shape[0]
        print(f"K4 solve {tag} N={n}: {ms!r} ms a solve ({outs[key][2]} sweeps), {n / ms * 1e3!r} mazes/s ({smi})")

    for b, hot in ((4096, False), (b_wide, False), (b_wide, True)):
        n_seg = 256 * 4
        q = torch.randn((256, 4), generator=gen, device=dev)
        s = torch.randint(0, 256, (b,), generator=gen, device=dev, dtype=torch.int32)
        a = torch.randint(0, 4, (b,), generator=gen, device=dev, dtype=torch.int32)
        if hot:  # 90 % of the envs in one cell: one chain of dependent adds
            in_cell = torch.rand((b,), generator=gen, device=dev) < 0.9
            s[in_cell], a[in_cell] = 17, 2
        delta = torch.randn((b,), generator=gen, device=dev)
        p10 = segment_mean.call_plan(b, n_seg, dev)
        ms10, got = _cuda_ms(lambda: td.apply_td_updates(q, s, a, delta, 0.1), 50)
        graph10 = _graph_ms(lambda: td.apply_td_updates(q, s, a, delta, 0.1))
        passes10 = _graph_ms(lambda: segment_mean.segment_mean_cuda(q, s, a, delta, 0.1, None, tier="passes"))
        # one plain call serves K10 and its sums form: K10's plain version
        # is the sums form's, then the apply
        plain10, ref_sums = _cuda_ms(lambda: td.segment_sums_reference(s, a, delta, 0.1, 256, 4),
                                     1 if hot else 3, warm=not hot)
        ref = td.apply_segment_sums(q, *ref_sums)
        lib10, lib = _cuda_ms(lambda: _segment_mean_library(q, s, a, delta, 0.1, None), 50)
        hold("segment_mean", f"K10 timed B={b} hot={hot}", (got,), (ref,), ("q",))
        _same(f"K10 passes B={b} hot={hot}", segment_mean.segment_mean_cuda(q, s, a, delta, 0.1, None, tier="passes"), got)
        _require(bool(torch.allclose(got, lib, rtol=1e-5, atol=1e-6)), "K10: the library yardstick computes another function")
        cells = "90 % in one cell" if hot else "uniform cells"
        t10 = dict(
            ms=ms10, graph_ms=graph10, plain_ms=plain10, shape=f"B={b}, S*A={n_seg}, {cells}", library_ms=lib10,
            # s, a, delta in; Q in and out
            **bound(b * 12 + 2 * n_seg * 4, INSTR_K10_ENV * b + 2 * n_seg))
        print(f"time segment_mean at {t10['shape']} ({p10.tier}, {p10.blocks} blocks): kernel {ms10!r} ms as timed, "
              f"{graph10!r} ms in a CUDA graph of ten; the four passes {passes10!r} ms in a graph; plain {plain10!r} ms, "
              f"bound {t10['bound_ms']!r} ms by {t10['bound_by']}, library {lib10!r} ms; bit-exact vs plain ({smi})")
        if b == 4096:
            times["segment_mean"] = t10
            continue
        # K10's sums form on the same inputs (the sharded learner's scalable mode)
        before = kernels.LAUNCHES["segment_sums"]
        ms_s, got_s = _cuda_ms(lambda: td.segment_sums(s, a, delta, 0.1, 256, 4), 50)
        _require(kernels.LAUNCHES["segment_sums"] == before + 51 * p10.launches,
                 f"K10's sums form: not {p10.launches} launches a call")
        graph_s = _graph_ms(lambda: td.segment_sums(s, a, delta, 0.1, 256, 4))
        passes_s = _graph_ms(lambda: segment_mean.segment_sums_cuda(s, a, delta, 0.1, 256, 4, tier="passes"))
        lib_s, lib = _cuda_ms(lambda: _segment_sums_library(s, a, delta, 0.1, n_seg), 50)
        err = _same_fields(f"K10 sums form timed B={b} hot={hot}", got_s, ref_sums, ("sums", "counts"))
        _same_fields(f"K10 sums form passes B={b} hot={hot}",
                     segment_mean.segment_sums_cuda(s, a, delta, 0.1, 256, 4, tier="passes"), got_s, ("sums", "counts"))
        _same(f"K10 sums form + apply B={b} hot={hot}", td.apply_segment_sums(q, *got_s), got)
        _require(bool(torch.allclose(got_s[0], lib[0], rtol=1e-4, atol=1e-5)) and bool(torch.equal(got_s[1], lib[1])),
                 "K10's sums form: the library yardstick computes another function")
        errs["segment_sums"] = max(errs.get("segment_sums", 0.0), err)
        t_s = dict(
            ms=ms_s, graph_ms=graph_s, plain_ms=plain10, shape=f"B={b}, S*A={n_seg}, {cells}", library_ms=lib_s,
            # s, a, delta in; the sums and the counts out
            **bound(b * 12 + 2 * n_seg * 4, INSTR_K10_ENV * b + n_seg))
        print(f"time segment_sums at {t_s['shape']} ({p10.tier}, {p10.blocks} blocks): kernel {ms_s!r} ms, in a CUDA "
              f"graph of ten {graph_s!r} ms; the four passes {passes_s!r} ms in a graph; plain {plain10!r} ms, bound "
              f"{t_s['bound_ms']!r} ms by {t_s['bound_by']}, library {lib_s!r} ms; bit-exact vs plain, and with the "
              f"apply equal to K10 ({smi})")
        if not hot:
            times["segment_sums"] = t_s
    return launches, errs, times


def k10_tier_holds(dev, smi) -> dict:
    """K10's two tiers, both forms, bit for bit against the plain versions:
    B = 1, 32, 4,096, 65,536 and 102,400 over S·A = 81, 324, 1,024 and
    16,900 (a 65×65 maze), with uniform cells, half the envs masked, and
    (up to 4,096 envs) 90 % in one cell; then each tier's boundaries at the
    plan's own shapes: the largest call of a lone block and of each cluster
    size, the first call of the passes, in the batch (S·A = 1,024) and in
    S·A (4,096 envs; the largest S·A also at 65,536). Every call launches
    what `plan` says, and the passes
    forced on the same inputs give the same bits. Returns the max abs errors
    of `segment_mean` and `segment_sums`."""
    from griduniverse_tpu_torch import kernels
    from griduniverse_tpu_torch.algos import td
    from griduniverse_tpu_torch.kernels import segment_mean as sm

    gen = torch.Generator(device=dev).manual_seed(25)
    errs = {"segment_mean": 0.0, "segment_sums": 0.0}
    tiers: dict = {}

    def held(b, n_states, n_actions, kind):
        n_seg = n_states * n_actions
        q = torch.randn((n_states, n_actions), generator=gen, device=dev)
        s = torch.randint(0, n_states, (b,), generator=gen, device=dev, dtype=torch.int32)
        a = torch.randint(0, n_actions, (b,), generator=gen, device=dev, dtype=torch.int32)
        if kind == "hot":
            in_cell = torch.rand((b,), generator=gen, device=dev) < 0.9
            s[in_cell], a[in_cell] = n_states // 3, 0
        delta = torch.randn((b,), generator=gen, device=dev)
        mask = torch.rand((b,), generator=gen, device=dev) < 0.5 if kind == "masked" else None
        p = sm.call_plan(b, n_seg, dev)
        tiers.setdefault((p.tier, p.blocks), []).append((b, n_seg))
        tag = f"K10 {p.tier} ({p.blocks} blocks) B={b} S*A={n_seg} {kind}"
        before = (kernels.LAUNCHES["segment_mean"], kernels.LAUNCHES["segment_sums"])
        got = (td.apply_td_updates(q, s, a, delta, 0.1) if mask is None
               else td.apply_td_updates_masked(q, s, a, delta, 0.1, mask))
        got_s = td.segment_sums(s, a, delta, 0.1, n_states, n_actions, mask)
        _require((kernels.LAUNCHES["segment_mean"], kernels.LAUNCHES["segment_sums"])
                 == (before[0] + p.launches, before[1] + p.launches), f"{tag}: not {p.launches} launches a call")
        ref_s = td.segment_sums_reference(s, a, delta, 0.1, n_states, n_actions, mask)
        errs["segment_mean"] = max(errs["segment_mean"], _same(f"{tag} mean", got, td.apply_segment_sums(q, *ref_s)))
        errs["segment_sums"] = max(errs["segment_sums"], _same_fields(f"{tag} sums", got_s, ref_s, ("sums", "counts")))
        if p.tier == "cluster":
            _same(f"{tag} mean vs the passes", sm.segment_mean_cuda(q, s, a, delta, 0.1, mask, tier="passes"), got)
            _same_fields(f"{tag} sums vs the passes",
                         sm.segment_sums_cuda(s, a, delta, 0.1, n_states, n_actions, mask, tier="passes"), got_s,
                         ("sums", "counts"))

    for b in (1, 32, 4096, 65_536, 102_400):
        for n_states, n_actions in ((81, 1), (81, 4), (256, 4), (4225, 4)):
            for kind in ("uniform", "masked", "hot") if b <= 4096 else ("uniform", "masked"):
                held(b, n_states, n_actions, kind)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    most = sm.cluster_blocks(dev)

    def largest(k):  # the largest batch the plan gives a cluster of at most k blocks (S*A = 1,024)
        lo, hi = 1, 16 * sm.MAX_BLOCK_ENVS + 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            p = sm.plan(mid, 1024, sms, most)
            lo, hi = (mid, hi) if p.tier == "cluster" and p.blocks <= k else (lo, mid - 1)
        return lo

    sizes = sorted({sm.plan(b, 1024, sms, most).blocks for b in range(1, 16 * sm.MAX_BLOCK_ENVS + 1, 512)} - {0})
    edges = [largest(k) for k in sizes]
    first_passes = edges[-1] + 1
    _require(sm.plan(first_passes, 1024, sms, most).tier == "passes", "K10: no passes above the largest cluster")
    for b in (*edges, edges[0] + 1, first_passes):
        held(b, 256, 4, "uniform")
    widest = sm.MAX_CLUSTER_SEGMENTS
    for b, n in ((4096, widest), (4096, widest + 1), (65_536, widest)):
        held(b, n, 1, "uniform")
    _require(sm.call_plan(4096, widest, dev).blocks == 1 and sm.call_plan(4096, widest + 1, dev).tier == "passes",
             "K10: the plan's S*A boundary moved")
    print(f"K10's tiers, both forms, bit-exact vs plain and vs the passes: {sum(map(len, tiers.values()))} calls; "
          f"by (tier, blocks): {dict(sorted((k, len(v)) for k, v in tiers.items()))}; cluster sizes used "
          f"{sizes} (the card holds {most}), the largest call of each {edges}, the first of the passes "
          f"{first_passes} envs; S*A up to {widest} on a cluster, {widest + 1} on the passes ({smi})")
    return errs


def _segment_mean_library(q, s, a, delta, alpha, mask):
    """K10's function by PyTorch's scatter (`index_add_` twice, a divide and
    an add): timed as a yardstick, used nowhere in the port."""
    n_seg = q.numel()
    flat = s.long() * q.shape[1] + a.long()
    inc, ones = alpha * delta, torch.ones_like(delta)
    if mask is not None:
        inc, ones = inc * mask, ones * mask
    upd = torch.zeros(n_seg, device=q.device).index_add_(0, flat, inc)
    cnt = torch.zeros(n_seg, device=q.device).index_add_(0, flat, ones)
    return q + (upd / cnt.clamp(min=1.0)).reshape(q.shape)


def _segment_sums_library(s, a, delta, alpha, n_seg):
    """K10's sums form by PyTorch's scatter (`index_add_` of α·δ, `bincount`
    of the keys): timed as a yardstick, used nowhere in the port."""
    flat = s.long() * 4 + a.long()
    sums = torch.zeros(n_seg, device=delta.device).index_add_(0, flat, alpha * delta)
    return sums, torch.bincount(flat, minlength=n_seg).to(torch.int32)


def _rel_err(name: str, a, b, tol: float) -> float:
    """max |a - b| must stay within `tol` times max |b|; returns max |a - b|."""
    err = _max_err(a.float(), b.float())
    scale = float(b.float().abs().max())
    _require(err <= tol * max(scale, 1e-30), f"{name}: max abs err {err} against scale {scale} (tolerance {tol})")
    return err


def _ulp_err(name: str, got, ref, ulps: int) -> float:
    """`got` within `ulps` float32 ulp (of max(|ref|, 1)) of `ref` wherever
    `ref` is finite, and infinite exactly where it is; max |got - ref| there."""
    finite = torch.isfinite(ref)
    _require(bool((torch.isfinite(got) == finite).all()) and bool((got[~finite] == ref[~finite]).all()),
             f"{name}: infinite values differ")
    gap = (got[finite] - ref[finite]).abs()
    err = float(gap.max()) if gap.numel() else 0.0
    _require(bool((gap <= ulps * 2.0 ** -23 * ref[finite].abs().clamp(min=1.0)).all()),
             f"{name}: more than {ulps} ulp from the plain version (max abs err {err})")
    return err


def _logp_err(name: str, got, ref) -> float:
    """K7b's log-prob within 2 ulp (of max(|logp|, 1)) of the plain version's."""
    return _ulp_err(f"{name} logp", got, ref, 2)


_ACT_FIELDS = ("action", "obs", "reward", "done", "agent_idx", "agent_code", "t", "state done")


def _act_fields(out):
    st, action, _, obs, reward, done = out
    return (action, obs, reward, done, st.agent_idx, st.agent_code, st.t, st.done)


def _train_state_fields(ts):
    names = sorted(ts.params)
    fields = [ts.params[k] for k in names] + [ts.opt_state.mu[k] for k in names] + [ts.opt_state.nu[k] for k in names]
    fields += [ts.opt_state.count, ts.env_state.agent_idx, ts.env_state.agent_code, ts.env_state.t,
               ts.run_ret, ts.episodes.reshape(1), ts.ret_sum, ts.last_loss]
    labels = [f"param {k}" for k in names] + [f"mu {k}" for k in names] + [f"nu {k}" for k in names]
    labels += ["adam count", "agent_idx", "agent_code", "t", "run_ret", "episodes", "ret_sum", "last_loss"]
    return fields, labels


def _same_train_state(tag: str, a, b) -> None:
    fa, labels = _train_state_fields(a)
    fb, _ = _train_state_fields(b)
    _same_fields(tag, fa, fb, labels)


def _apply(net, params, obs, tiles):
    return torch.func.functional_call(net, params, (obs,) if tiles is None else (obs, tiles))


def _hold_last_update(name, sem, level, cfg, before_last, end, batch, tol, errs):
    """A training run's last update against the plain versions (phases 13
    and 28). The update is redone by the trainer's own update function on
    the trainer's own draws and must end in the run's state. Every act_step
    of it: the plain version, chained from the update's first state on the
    same logits and noise, against the rows the trainer recorded, and the
    kernel once more on each step's inputs; then the bootstrap, the plain
    rollout's last state, and K7a's advantages (PPO) or returns (A2C). The
    update's first minibatch, forward and backward, with the kernels and with
    the plain versions: the losses bit-equal, each gradient within `tol` of
    its scale, and the K9a or K9b backward's own gradients bit for bit
    against the plain fixed-order backward. Adds each kernel's largest error
    into `errs`. Returns ((trajectory, bootstrap, first minibatch, its tiles,
    network, parameters), the last act_step's inputs)."""
    from griduniverse_tpu_torch.models import a2c, networks, ppo

    def hold(kname, tag, got, ref, fields):
        errs[kname] = max(errs[kname], _same_fields(tag, got, ref, fields))

    is_ppo = isinstance(cfg, ppo.PPOConfig)
    params = before_last.params
    with networks.exact_kernels():
        if is_ppo:
            learner = ppo.ppo_learner(sem, level, cfg, batch)
            noise, draws = ppo.update_draws(level.grid.device, before_last.seed, before_last.update, cfg, batch,
                                            sem.num_actions)
            upd = ppo.ppo_update(sem, learner, cfg, params, before_last.opt_state, before_last.env_state, noise, draws)
        else:
            learner = a2c.a2c_learner(sem, level, cfg, batch)
            noise = a2c.update_noise(level.grid.device, before_last.seed, before_last.update, cfg, batch,
                                     sem.num_actions)
            upd = a2c.a2c_update(sem, learner, cfg, params, before_last.opt_state, before_last.env_state, noise)
    bl, net, tiles, _, act_plan = learner
    _require(act_plan is not None, f"{name}: the learner built no K7b plan on the card")
    stand_in = type(end)(**{**vars(end), "params": upd.params, "opt_state": upd.opt_state,
                            "env_state": upd.env_state, "last_loss": upd.loss})
    _same_train_state(f"{name} the last update redone", stand_in, end)
    traj = upd.traj

    st = before_last.env_state
    with torch.no_grad(), networks.exact_kernels():
        for t, g_t in enumerate(noise):
            logits, value = _apply(net, params, st.agent_idx, tiles)
            _same(f"{name} step {t} value", value, traj.value[t])
            ref = a2c.act_step_reference(sem, bl, st, logits, g_t, cfg.max_episode_steps)
            hold("act_step", f"K7b main {name} step {t}", (traj.action[t], traj.obs[t], traj.reward[t], traj.done[t]),
                 (ref[1], ref[3], ref[4], ref[5]), _ACT_FIELDS[:4])
            errs["act_step"] = max(errs["act_step"], _logp_err(f"K7b main {name} step {t}", traj.logp[t], ref[2]))
            got = a2c.act_step(sem, bl, st, logits, g_t, cfg.max_episode_steps)
            hold("act_step", f"K7b main {name} step {t} again", _act_fields(got), _act_fields(ref), _ACT_FIELDS)
            last_act = (bl, st, logits, g_t, cfg.max_episode_steps)
            st = ref[0]
        _, bootstrap = _apply(net, params, st.agent_idx, tiles)
    _same(f"{name} bootstrap", bootstrap, upd.bootstrap)
    _same_fields(f"K7b main {name}: the plain rollout's last state", [getattr(st, f) for f in _STATE_FIELDS],
                 [getattr(upd.env_state, f) for f in _STATE_FIELDS], _STATE_FIELDS)
    if is_ppo:
        hold("gae", f"K7a main {name}", (upd.adv, upd.targets),
             ppo.gae_advantages_reference(traj, upd.bootstrap, cfg.gamma, cfg.gae_lambda), ("adv", "targets"))
        mb, mb_tiles = upd.first_minibatch

        def loss_of(live):
            return ppo.ppo_loss(net, live, mb, mb_tiles, cfg)[0]
    else:
        hold("gae", f"K7a main {name}", (upd.returns,),
             (a2c.nstep_returns_reference(traj.reward, traj.done, upd.bootstrap, cfg.gamma),), ("returns",))
        mb = mb_tiles = None

        def loss_of(live):
            return a2c.a2c_loss(net, live, tiles, traj, upd.returns, cfg)
    print(f"{name} main, last update: redone by the trainer's update function it ends in the main path's state; "
          f"every act_step exact vs plain (logp within 2 ulp), K7a bit-exact vs plain (episode ends: {int(traj.done.sum())})")

    seen_embed, seen_stamp = [], []
    real_embed, real_stamp = networks.embed_rows, networks.agent_stamp

    def recording_embed(table, obs, dtype):
        out = real_embed(table, obs, dtype)
        out.retain_grad()
        seen_embed.append((obs, out))
        return out

    def recording_stamp(y_tiles, k_agent, bias, obs):
        out = real_stamp(y_tiles, k_agent, bias, obs)
        for x in (y_tiles, k_agent, out):
            x.retain_grad()
        seen_stamp.append((y_tiles, k_agent, obs, out))
        return out

    def loss_and_grads(**patches):
        live = a2c.leaves(params)
        with mock.patch.multiple(networks, **patches), networks.exact_kernels():
            loss = loss_of(live)
            loss.backward()
        return loss.detach(), {k: v.grad for k, v in live.items()}

    loss_k, grads_k = loss_and_grads(embed_rows=recording_embed, agent_stamp=recording_stamp)
    loss_p, grads_p = loss_and_grads(embed_rows=networks.embed_rows_reference,
                                     agent_stamp=networks.agent_stamp_reference)
    _same(f"{name} minibatch loss, kernels vs plain", loss_k, loss_p)
    if not is_ppo:  # A2C's one minibatch is its whole update
        _same(f"{name} minibatch loss vs the update's", loss_k, upd.loss)
    worst = 0.0
    for leaf in grads_k:
        err = _rel_err(f"{name} minibatch gradient {leaf}", grads_k[leaf], grads_p[leaf], tol)
        worst = max(worst, err / max(float(grads_p[leaf].abs().max()), 1e-30))
    if seen_stamp:
        kname = "agent_stamp"
        (y_tiles, k_agent, obs, out), = seen_stamp
        fixed = networks.agent_stamp_backward_reference(out.grad, out.detach(), obs, y_tiles.shape[0])
        hold(kname, f"K9b main {name} backward", (y_tiles.grad, k_agent.grad, grads_k["conv_0_bias"]),
             fixed, ("dy_tiles", "dk", "dbias"))
        del fixed, y_tiles, k_agent, out
    else:
        kname = "embed_rows"
        (obs, out), = seen_embed
        hold(kname, f"K9a main {name} backward", (grads_k["embed"],),
             (networks.embed_rows_backward_reference(out.grad, obs, params["embed"].shape[0]),), ("dtable",))
    print(f"{name} main, one minibatch of {int(obs.shape[0])} samples: loss bit-equal with kernels and with plain "
          f"versions, every gradient within {tol} of its scale of autograd's (worst {worst!r}); the {kname} "
          "backward's own gradients bit-exact vs the plain fixed-order backward")
    return (traj, upd.bootstrap, mb, mb_tiles, net, params), last_act


def learner_phases(gt, dev, gen, bound, smi):
    """Phases 11-14: K7a, K7b, K9a and K9b against their plain versions at
    small shapes, the training main path at full width with its launches
    counted, its outputs against the plain versions, and the times. Returns
    (launches, max abs errors, times) by kernel name."""
    from griduniverse_tpu_torch import kernels, models
    from griduniverse_tpu_torch.kernels import act_step as act_kernels
    from griduniverse_tpu_torch.kernels import agent_stamp as k9b
    from griduniverse_tpu_torch.kernels import embed_rows as k9a
    from griduniverse_tpu_torch.kernels import gae as gae_kernels
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.levels import maze as M
    from griduniverse_tpu_torch.models import a2c, networks, ppo
    from griduniverse_tpu_torch.tools.profile_learners import _profile
    from griduniverse_tpu_torch.tools.profile_solvers import _wall_ms
    from griduniverse_tpu_torch.tools.profile_kernels import _graph_ms
    from griduniverse_tpu_torch.tools.profile_turns import _plan_graph_ms
    from griduniverse_tpu_torch.ops import bitplane as bp
    from griduniverse_tpu_torch.utils import capture

    errs = {"gae": 0.0, "act_step": 0.0, "embed_rows": 0.0, "agent_stamp": 0.0}
    times = {}

    def hold(name, tag, got, ref, fields):
        errs[name] = max(errs[name], _same_fields(tag, got, ref, fields))

    sem = gt.make_semantics()
    walls16 = builders.walls_and_goal_16x16()
    num_actions = sem.num_actions

    def mazes(seed, cells, n):
        grids, start = M.generate_mazes_device(seed, cells, n, "aldous_broder")
        return gt.Level(grid=grids, start_idx=start.expand(n).contiguous())

    def rollout_arrays(t, b):
        value = torch.randn((t, b), generator=gen, device=dev)
        reward = torch.randn((t, b), generator=gen, device=dev)
        done = torch.rand((t, b), generator=gen, device=dev) < 0.25
        return a2c.Trajectory(None, None, None, value, reward, done), torch.randn((b,), generator=gen, device=dev)

    # -- phase 11: each learner kernel against its plain version, small shapes --
    # K7a's register tier (T <= 16) and group tier, 4, 2 and 1 envs a thread, and done
    # bytes that start off a 4-byte boundary (the scalar path)
    for t7, b7 in ((12, 4096), (1, 4095), (16, 4098), (33, 4098), (128, 4097)):
        traj, boot = rollout_arrays(t7, b7)
        shifted = torch.zeros(t7 * b7 + 1, dtype=torch.bool, device=dev)
        shifted[1:] = traj.done.reshape(-1)
        for tag, done in (("", traj.done), (", done off 4 bytes", shifted[1:].view(t7, b7))):
            traj = a2c.Trajectory(None, None, None, traj.value, traj.reward, done)
            hold("gae", f"K7a gae T={t7} B={b7}{tag}", ppo.gae_advantages(traj, boot, 0.99, 0.95),
                 ppo.gae_advantages_reference(traj, boot, 0.99, 0.95), ("adv", "targets"))
            hold("gae", f"K7a n-step returns T={t7} B={b7}{tag}", (a2c.nstep_returns(traj.reward, done, boot, 0.99),),
                 (a2c.nstep_returns_reference(traj.reward, done, boot, 0.99),), ("returns",))
    print("K7a T=1, 12, 16, 33, 128, B=4,095 to 4,098 (4, 2 and 1 envs a thread), done bytes aligned and off 4 "
          "bytes, a quarter of done set: advantages, targets and n-step returns bit-exact vs plain")

    for lname, bl in (("walls16", bp.pack_level(walls16)), ("mazes4k", bp.pack_level(mazes(11, (4, 4), 4096)))):
        st = bp.reset_bits(bl, None if bl.batched else 4096)
        gst, reached = st, torch.zeros(4096, dtype=torch.bool, device=dev)
        for _ in range(96):
            logits = 3 * torch.randn((4096, num_actions), generator=gen, device=dev)
            noise = a2c.draw_gumbel(gen, (4096, num_actions), dev)
            got = a2c.act_step(sem, bl, st, logits, noise, 64)
            ref = a2c.act_step_reference(sem, bl, st, logits, noise, 64)
            _same_fields(f"K7b {lname}", _act_fields(got), _act_fields(ref), _ACT_FIELDS)
            errs["act_step"] = max(errs["act_step"], _logp_err(f"K7b {lname}", got[2], ref[2]))
            g_got = a2c.greedy_step(sem, bl, gst, reached, logits)
            g_ref = a2c.greedy_step_reference(sem, bl, gst, reached, logits)
            _same_fields(f"K7b greedy {lname}", (*(getattr(g_got[0], f) for f in _STATE_FIELDS), g_got[1]),
                         (*(getattr(g_ref[0], f) for f in _STATE_FIELDS), g_ref[1]), (*_STATE_FIELDS, "reached"))
            st, (gst, reached) = got[0], g_got
        print(f"K7b {lname} B=4096, 96 steps, max_episode_steps=64: action, obs, reward, done and state exact, "
              f"logp within 2 ulp (max abs err so far {errs['act_step']!r}); the greedy form exact "
              f"({int(reached.sum())} envs reached their goal)")

    for s in (256, 4225):
        for e in (16, 64):
            for cdt in (torch.float32, torch.bfloat16):
                n = 8192
                table = torch.randn((s, e), generator=gen, device=dev, requires_grad=True)
                obs = torch.randint(0, 9, (n,), generator=gen, device=dev, dtype=torch.int32)  # heavy collisions
                obs[::5] = torch.randint(0, s, (len(obs[::5]),), generator=gen, device=dev, dtype=torch.int32)
                out = networks.embed_rows(table, obs, cdt)
                hold("embed_rows", f"K9a forward S={s} E={e} {cdt}", (out,),
                     (networks.embed_rows_reference(table, obs, cdt),), ("out",))
                g = torch.randn((n, e), generator=gen, device=dev).to(cdt)
                (grad,) = torch.autograd.grad(out, table, g)
                hold("embed_rows", f"K9a backward S={s} E={e} {cdt}", (grad,),
                     (networks.embed_rows_backward_reference(g, obs, s),), ("dtable",))
                (auto,) = torch.autograd.grad(networks.embed_rows_reference(table, obs, cdt), table, g)
                errs["embed_rows"] = max(errs["embed_rows"], _rel_err(f"K9a vs autograd S={s} E={e} {cdt}", grad, auto, 1e-5))
    print("K9a S=256, 4225; E=16, 64; float32, bfloat16; N=8192: forward bit-exact vs plain, backward bit-exact "
          "vs the plain fixed-order backward and within 1e-5 of autograd's (max abs err "
          f"{errs['embed_rows']!r})")
    # the backward at the shared tier's largest table and one row above it (the global tier)
    limits = {}
    for cdt in (torch.float32, torch.bfloat16):
        s_lim = 1
        while k9a.uses_shared_tier(s_lim + 1, 16, cdt):
            s_lim += 1
        limits[str(cdt)] = s_lim
        for s in (256, s_lim, s_lim + 1):
            for n in (1, 511, 513, 262_144):
                obs = torch.randint(0, 9, (n,), generator=gen, device=dev, dtype=torch.int32)  # heavy collisions
                obs[::5] = torch.randint(0, s, (len(obs[::5]),), generator=gen, device=dev, dtype=torch.int32)
                obs[-1] = s - 1
                g = torch.randn((n, 16), generator=gen, device=dev).to(cdt)
                hold("embed_rows", f"K9a backward S={s} N={n} {cdt} shared tier {k9a.uses_shared_tier(s, 16, cdt)}",
                     (k9a.embed_rows_backward_cuda(g, obs, s),),
                     (networks.embed_rows_backward_reference(g, obs, s),), ("dtable",))
    print(f"K9a backward E=16, S=256, the shared tier's largest table {limits} and one row above it (the global "
          "tier); N=1, 511, 513, 262,144; float32, bfloat16: bit-exact vs the plain fixed-order backward")

    # (Nl, T, H, W, C): a shared level, many levels, a level split over four
    # ranges, Nl = N, C = 12 with two ranges, levels above one tile of
    # cells, 33x33, and a C no vector divides
    stamp_shapes = ((1, 4, 9, 9, 16), (512, 4, 9, 9, 32), (1, 200, 9, 9, 8), (256, 1, 9, 9, 32),
                    (3, 70, 5, 6, 12), (3, 4, 17, 17, 8), (2, 5, 33, 33, 32), (2, 3, 5, 6, 3))
    for nl, t, h, w, ch in stamp_shapes:
        for cdt in (torch.float32, torch.bfloat16):
            n = nl * t
            y_tiles = torch.randn((nl, h, w, ch), generator=gen, device=dev).to(cdt).requires_grad_(True)
            k = torch.randn((3, 3, ch), generator=gen, device=dev, requires_grad=True)
            bias = torch.randn((ch,), generator=gen, device=dev, requires_grad=True)
            obs = torch.randint(0, h * w, (n,), generator=gen, device=dev, dtype=torch.int32)
            cot = torch.randn((n, h, w, ch), generator=gen, device=dev).to(cdt)
            out = networks.agent_stamp(y_tiles, k, bias, obs)
            ref = networks.agent_stamp_reference(y_tiles, k, bias, obs)
            hold("agent_stamp", f"K9b forward Nl={nl} T={t} {h}x{w} ch={ch} {cdt}", (out,), (ref,), ("out",))
            grads = torch.autograd.grad(out, (y_tiles, k, bias), cot)
            again = torch.autograd.grad(networks.agent_stamp(y_tiles, k, bias, obs), (y_tiles, k, bias), cot)
            _same_fields(f"K9b backward twice Nl={nl} T={t} {h}x{w} ch={ch} {cdt}", grads, again,
                         ("dy_tiles", "dk", "dbias"))
            fixed = networks.agent_stamp_backward_reference(cot, out.detach(), obs, nl)
            hold("agent_stamp", f"K9b backward Nl={nl} T={t} {h}x{w} ch={ch} {cdt}", grads, fixed,
                 ("dy_tiles", "dk", "dbias"))
            auto = torch.autograd.grad(ref, (y_tiles, k, bias), cot)
            # autograd adds in another order, and rounds all three gradients to the compute dtype
            tol = 1e-2 if cdt == torch.bfloat16 else 1e-5
            for name, a, b in zip(("dy_tiles", "dk", "dbias"), grads, auto):
                err = _rel_err(f"K9b {name} Nl={nl} T={t} {h}x{w} ch={ch} {cdt}", a, b, tol)
                if cdt == torch.float32:  # bfloat16 gradients are held to their scale only
                    errs["agent_stamp"] = max(errs["agent_stamp"], err)
    print(f"K9b (Nl, T, H, W, C) in {stamp_shapes}; float32, bfloat16: forward bit-exact vs plain, the three gradients "
          "bit-exact vs the plain fixed-order backward, the same bits on two runs, and within 1e-5 (bfloat16: 1e-2) "
          f"of their scale of autograd's through the plain version (float32 max abs err {errs['agent_stamp']!r})")

    # -- phase 12: the training main paths at full width, each counted ----------
    n64 = 65_536
    lv64 = mazes(2026, (4, 4), n64)
    cfgs = {
        "ppo walls16": (walls16, models.PPOConfig(max_episode_steps=MAX_EPISODE_STEPS), 3),
        "ppo mazes64k": (lv64, models.PPOConfig(max_episode_steps=MAX_EPISODE_STEPS, obs="grid",
                                                conv_channels=(32,), hidden=(64,)), 2),
        "a2c walls16": (walls16, models.A2CConfig(max_episode_steps=MAX_EPISODE_STEPS), 3),
    }
    api = {"ppo": (models.ppo_train, models.ppo_init, models.ppo_run),
           "a2c": (models.a2c_train, models.a2c_init, models.a2c_run)}
    backward_launches = {"embed_rows": 2, "agent_stamp": k9b.backward_launches()}  # a forward is one launch
    path_launches = {}

    def counted(name, fn, expected):
        """Drive one main path with the counts set to 0 just before and read
        just after; every count must be the one the path's shape gives."""
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {k: kernels.LAUNCHES[k] for k in errs}
        path_launches[name] = got
        print(f"launches on the main path {name}: {got}")
        _require(got == {**dict.fromkeys(errs, 0), **expected}, f"{name}: launches {got}, expected {expected}")
        return ms, out

    runs = {}
    for name, (level, cfg, updates) in cfgs.items():
        train, init, run = api[name.split()[0]]
        train(sem, level, 1, cfg, 1, n64)  # first call: library handles, allocator
        torch.cuda.reset_peak_memory_stats()
        t_len = cfg.rollout_len
        sgd_steps = cfg.num_epochs * cfg.num_minibatches if name.startswith("ppo") else 1
        net_kernel = "agent_stamp" if cfg.obs == "grid" else "embed_rows"
        # an update: T policy forwards and the bootstrap's, then a forward and a backward an SGD step
        # the captured call's replays and its warm-up update
        ran = updates + capture.WARMUP_STEPS
        expected = {"gae": ran, "act_step": ran * t_len,
                    net_kernel: ran * (t_len + 1 + sgd_steps * (1 + backward_launches[net_kernel]))}
        capture.reset_counts()
        ms, res = counted(name, lambda: train(sem, level, 5, cfg, updates, n64), expected)
        _require(capture.COUNTS == {"captures": 1, "warmup_steps": capture.WARMUP_STEPS, "replays": updates},
                 f"{name}: {capture.COUNTS}")
        peak = torch.cuda.max_memory_allocated()
        finite = all(bool(torch.isfinite(p).all()) for p in res.params.values())
        _require(finite and bool(torch.isfinite(res.final_loss)) and bool(torch.isfinite(res.mean_return)),
                 f"{name}: a non-finite parameter, loss or return")
        _require(all(p.device.type == "cuda" for p in res.params.values()), f"{name}: parameters are not on the card")
        steps = updates * t_len * n64
        print(f"{name} main: B={n64} T={t_len} updates={updates}: {ms!r} ms, {steps / ms * 1e3!r} env steps/s, "
              f"episodes {int(res.episodes)}, mean_return {float(res.mean_return)!r}, final_loss {float(res.final_loss)!r}, "
              f"peak memory {peak / 2**30:.3f} GiB ({smi})")
        # chunk invariance on the card (not counted): all but the last update,
        # then the last, against the unbroken run; and the unbroken run twice
        before_last = run(sem, level, init(sem, level, 5, cfg, n64), cfg, updates - 1)
        end = run(sem, level, before_last, cfg, 1)
        whole = run(sem, level, init(sem, level, 5, cfg, n64), cfg, updates)
        _same_train_state(f"{name} chunked {updates - 1}+1 vs {updates}", end, whole)
        _same_fields(f"{name} a second run", [res.params[k] for k in sorted(res.params)],
                     [whole.params[k] for k in sorted(whole.params)], sorted(res.params))
        _same(f"{name} a second run: final_loss", res.final_loss, whole.last_loss)
        print(f"{name} main: {updates - 1}+1 updates from a saved state equal {updates} unbroken bit for bit "
              "(parameters, Adam moments and count, env state, statistics); two runs give the same bits")
        runs[name] = (level, cfg, before_last, end)
        if name == "ppo mazes64k":  # the device-bound path: its rate, and K9b's share of its device time
            ts0 = init(sem, level, 5, cfg, n64)

            def call(level=level, cfg=cfg, ts0=ts0, updates=updates, run=run):
                return run(sem, level, ts0, cfg, updates)

            walls = sorted(_wall_ms(call) for _ in range(3))
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
                torch.zeros(1, device=dev).sum().item()  # the profiler's own start-up
            prof = _profile(f"{name} {updates} updates", call, walls[1], smi, top=6)
            _require(prof is not None, f"the profiler recorded no device time for {name}")
            stamp_us = sum(us for kname, (us, _) in prof[3].items() if "agent_stamp" in kname)
            print(f"{name} rate: {walls!r} ms a call of {updates} updates, {[steps / m * 1e3 for m in walls]!r} env "
                  f"steps/s; device busy {prof[0]!r} us, idle share {100 * prof[2]:.2f} %, K9b {stamp_us!r} us "
                  f"({100 * stamp_us / prof[0]:.2f} % of busy) ({smi})")

    level, cfg, _, end = runs["ppo mazes64k"]
    greedy_steps = 60
    net = models.make_network(level, num_actions, cfg)
    ms, rate = counted("greedy_success_rate", lambda: models.greedy_success_rate(sem, net, end.params, level, greedy_steps),
                       {"act_step": greedy_steps, "agent_stamp": greedy_steps})
    fresh = models.greedy_success_rate(sem, net, models.init_network_params(net, 0), level, greedy_steps)
    _require(0.0 <= float(rate) <= 1.0, "greedy_success_rate out of range")
    print(f"greedy_success_rate main: {n64} mazes, {greedy_steps} steps: {float(rate)!r} after 2 updates "
          f"({float(fresh)!r} with fresh parameters), {ms!r} ms ({smi})")

    launches = {k: sum(path[k] for path in path_launches.values()) for k in errs}
    print(f"launches on the training main paths, summed: {launches}")
    _require(all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}")

    # -- phase 13: the main paths' last updates against the plain versions -------
    kept = {}
    for name, (level, cfg, before_last, end) in runs.items():
        # autograd's plain backward adds in another order (float atomics over
        # up to a million samples); with the conv trunk it also rounds the
        # gradients of the stamp's three inputs to bfloat16
        tol = 2e-2 if "mazes" in name else 1e-4
        kept[name], kept[f"act {name}"] = _hold_last_update(name, sem, level, cfg, before_last, end, n64, tol, errs)

    # the greedy path once more: every step of it against the plain version
    level, cfg, _, end = runs["ppo mazes64k"]
    bl, net, tiles, _, _ = ppo.ppo_learner(sem, level, cfg, n64)
    st = bp.reset_bits(bl, None)
    reached = torch.zeros(n64, dtype=torch.bool, device=dev)
    with torch.no_grad(), networks.exact_kernels():
        for t in range(greedy_steps):
            logits, _ = _apply(net, end.params, st.agent_idx, tiles)
            got = a2c.greedy_step(sem, bl, st, reached, logits)
            ref = a2c.greedy_step_reference(sem, bl, st, reached, logits)
            _same_fields(f"K7b greedy main step {t}", (*(getattr(got[0], f) for f in _STATE_FIELDS), got[1]),
                         (*(getattr(ref[0], f) for f in _STATE_FIELDS), ref[1]), (*_STATE_FIELDS, "reached"))
            st, reached = got
    _same("K7b greedy main: the success rate", reached.float().mean(), rate)
    print(f"greedy_success_rate main, redone: each of the {greedy_steps} greedy steps on {n64} mazes exact vs plain "
          f"(state and reached); {int(reached.sum())} envs reached, the rate equals the main path's")

    # -- phase 14: times at the main path's shapes ------------------------------
    traj, bootstrap, mb, _, _, params = kept["ppo walls16"]
    t_len = traj.value.shape[0]
    k7a_plan = gae_kernels.plan(t_len, n64, (traj.value.data_ptr(), traj.reward.data_ptr(), bootstrap.data_ptr()),
                                traj.done.data_ptr())

    def gae_call():
        return ppo.gae_advantages(traj, bootstrap, 0.99, 0.95)

    def nstep_call():
        return (a2c.nstep_returns(traj.reward, traj.done, bootstrap, 0.99),)

    ms, got = _cuda_ms(gae_call, 50)
    graph_ms = _graph_ms(gae_call)
    plain_ms, ref = _cuda_ms(lambda: ppo.gae_advantages_reference(traj, bootstrap, 0.99, 0.95), 3)
    hold("gae", "K7a timed", got, ref, ("adv", "targets"))
    ms_r, got = _cuda_ms(nstep_call, 50)
    graph_ms_r = _graph_ms(nstep_call)
    plain_ms_r, ref = _cuda_ms(lambda: (a2c.nstep_returns_reference(traj.reward, traj.done, bootstrap, 0.99),), 3)
    hold("gae", "K7a n-step returns timed", got, ref, ("returns",))
    times["gae"] = [
        dict(ms=ms, graph_ms=graph_ms, plain_ms=plain_ms, shape=f"GAE T={t_len} B={n64}", library_ms=None,
             # value, reward (4 bytes) and done (1) in, adv and targets out, per (t, env); the bootstrap
             **bound(t_len * n64 * 17 + n64 * 4, INSTR_K7A_STEP * t_len * n64)),
        dict(ms=ms_r, graph_ms=graph_ms_r, plain_ms=plain_ms_r, shape=f"n-step returns T={t_len} B={n64}",
             library_ms=None,
             # reward (4 bytes) and done (1) in, the return out, per (t, env); the bootstrap
             **bound(t_len * n64 * 9 + n64 * 4, INSTR_K7A_NSTEP * t_len * n64))]
    print(f"K7a at the main path's rollout, T={t_len} B={n64} ({k7a_plan.width} envs a thread, the {k7a_plan.tier} "
          f"tier): GAE {ms!r} ms as timed, {graph_ms!r} ms in a CUDA graph of ten (bound {times['gae'][0]['bound_ms']!r} "
          f"ms); n-step returns {ms_r!r} ms as timed, {graph_ms_r!r} ms in a graph (bound {times['gae'][1]['bound_ms']!r} "
          f"ms) ({smi})")

    # K7b as the rollout calls it: a step through a plan built once, on the
    # main path's last step of each shape
    for name in ("ppo walls16", "ppo mazes64k"):
        bl, st, logits, g_t, max_ep = kept[f"act {name}"]

        def make_plan(bl=bl, st=st, g_t=g_t, max_ep=max_ep):
            plan = act_kernels.ActStepPlan(sem, bl, n64, 1, max_ep)
            plan.begin(st, g_t[None])
            return plan

        logits = logits.contiguous()
        plan = make_plan()
        new_st = plan.step(0, logits)
        obs, action, logp, reward, done = (row[0] for row in plan.rows)
        got = (new_st, action, logp, obs, reward, done)
        ref = a2c.act_step_reference(sem, bl, st, logits, g_t, max_ep)
        _same_fields(f"K7b timed {name}", _act_fields(got), _act_fields(ref), _ACT_FIELDS)
        errs["act_step"] = max(errs["act_step"], _logp_err(f"K7b timed {name}", logp, ref[2]))
        ms, _ = _cuda_ms(lambda: plan.step(0, logits), 200)
        graph_ms = _plan_graph_ms(make_plan, lambda p, logits=logits: p.step(0, logits))
        plain_ms, _ = _cuda_ms(lambda: a2c.act_step_reference(sem, bl, st, logits, g_t, max_ep), 3)
        level_bytes = bl.code_words.shape[-1] * 4 if bl.batched else 0
        # logits and noise (2·A floats), state in (12 bytes) and out (13), five outputs (17), a per-env level's words
        t7b = dict(ms=ms, plain_ms=plain_ms, shape=f"{name.split()[1]} B={n64} A={num_actions}", library_ms=None,
                   **bound(n64 * (8 * num_actions + 42 + level_bytes), INSTR_K7B_ENV * n64))
        print(f"K7b timed {name}, a step through the run's plan: kernel {ms!r} ms as timed, {graph_ms!r} ms in a "
              f"CUDA graph, plain {plain_ms!r} ms, bound {t7b['bound_ms']!r} ms by {t7b['bound_by']} ({smi})")
        if name == "ppo walls16":
            times["act_step"] = t7b

    # K9a at a PPO minibatch (the record's shape), the rollout's and A2C's N
    table = params["embed"].detach().clone().requires_grad_(True)
    s_n, e_n = table.shape
    cdt = torch.bfloat16
    a2c_obs = kept["a2c walls16"][0].obs.reshape(-1)
    for tag, obs in (("minibatch", mb[0].reshape(-1)), ("rollout", traj.obs[-1]), ("a2c", a2c_obs)):
        n = obs.shape[0]
        g = torch.randn((n, e_n), generator=gen, device=dev).to(cdt)
        f_ms, out = _cuda_ms(lambda: networks.embed_rows(table, obs, cdt), 50)
        b_ms, (grad,) = _cuda_ms(lambda: torch.autograd.grad(networks.embed_rows(table, obs, cdt), table, g), 20)
        b_ms -= f_ms
        pf_ms, pout = _cuda_ms(lambda: networks.embed_rows_reference(table, obs, cdt), 50)
        pb_ms, (pgrad,) = _cuda_ms(
            lambda: torch.autograd.grad(networks.embed_rows_reference(table, obs, cdt), table, g), 20)
        pb_ms -= pf_ms

        def library(obs=obs):  # one library call for the same function: timed here, used nowhere in the port
            return torch.nn.functional.embedding(obs, table.to(cdt))

        lf_ms, lout = _cuda_ms(library, 50)
        lb_ms, (lgrad,) = _cuda_ms(lambda: torch.autograd.grad(library(), table, g), 20)
        lb_ms -= lf_ms
        hold("embed_rows", f"K9a timed {tag} forward", (out, out), (pout, lout), ("vs plain", "vs F.embedding"))
        errs["embed_rows"] = max(errs["embed_rows"], _rel_err(f"K9a timed {tag} backward vs autograd", grad, pgrad, 1e-4))
        # the library's backward adds in bfloat16; it is a yardstick of time, held loosely
        _rel_err(f"K9a timed {tag} backward vs F.embedding", grad, lgrad, 5e-2)
        fixed_ms, fixed = _cuda_ms(lambda: networks.embed_rows_backward_reference(g, obs, s_n), 1, warm=False)
        hold("embed_rows", f"K9a timed {tag} backward", (grad,), (fixed,), ("dtable",))
        # the backward alone: the wrapper, and the library's kernel behind F.embedding's backward
        alone_ms, alone = _cuda_ms(lambda: k9a.embed_rows_backward_cuda(g, obs, s_n), 50)
        lalone_ms, _ = _cuda_ms(lambda: torch.ops.aten.embedding_backward(g, obs, s_n, -1, False, False), 50)
        hold("embed_rows", f"K9a timed {tag} backward alone", (alone,), (fixed,), ("dtable",))
        # the forward alone in a CUDA graph of ten (the device's time), and the library's two launches
        w = table.detach()
        fg_ms = _graph_ms(lambda: k9a.embed_rows_cuda(w, obs, cdt))
        lg_ms = _graph_ms(lambda: torch.nn.functional.embedding(obs, w.to(cdt)))
        fb = bound(n * 4 + s_n * e_n * 4 + n * e_n * 2, INSTR_K9A_FWD * n * e_n)
        bb = bound(n * 4 + s_n * e_n * 4 + n * e_n * 2, INSTR_K9A_BWD * n * e_n)
        print(f"K9a timed {tag} N={n} S={s_n} E={e_n} bfloat16: forward {f_ms!r} ms (in a CUDA graph {fg_ms!r}; plain "
              f"{pf_ms!r}, F.embedding {lf_ms!r}, in a graph {lg_ms!r}, bound {fb['bound_ms']!r} by "
              f"{fb['bound_by']}), backward {b_ms!r} ms (autograd of plain "
              f"{pb_ms!r}, of F.embedding {lb_ms!r}, plain fixed-order {fixed_ms!r}, bound {bb['bound_ms']!r} by "
              f"{bb['bound_by']}); the backward alone {alone_ms!r} ms, aten.embedding_backward alone {lalone_ms!r} "
              f"ms; forward bit-exact, backward bit-exact vs the plain fixed-order backward ({smi})")
        if tag == "minibatch":
            both = bound(2 * (n * 4 + s_n * e_n * 4 + n * e_n * 2), (INSTR_K9A_FWD + INSTR_K9A_BWD) * n * e_n)
            times["embed_rows"] = dict(ms=f_ms + b_ms, plain_ms=pf_ms + pb_ms, library_ms=lf_ms + lb_ms,
                                       shape=f"forward + backward, N={n} S={s_n} E={e_n} bfloat16", **both)

    # K9b at a PPO minibatch over per-env mazes (the record's shape) and at a rollout step
    _, _, mb, mb_tiles, net, params = kept["ppo mazes64k"]
    ch, c_t = net.channels[0], net.num_tile_types
    k_agent = params["conv_0_kernel"][:, c_t].permute(1, 2, 0).contiguous().requires_grad_(True)
    bias = params["conv_0_bias"].detach().clone().requires_grad_(True)
    h, w = net.height, net.width
    for tag, obs, planes in (("minibatch", mb[0].reshape(-1).contiguous(), mb_tiles),
                             ("rollout", kept["ppo mazes64k"][0].obs[-1], a2c._tiles_for(net, runs["ppo mazes64k"][0]))):
        with torch.no_grad(), networks.exact_kernels():
            y = torch.nn.functional.conv2d(planes.permute(0, 3, 1, 2), params["conv_0_kernel"][:, :c_t].to(cdt), padding=1)
        y_tiles = y.permute(0, 2, 3, 1).contiguous().requires_grad_(True)
        n, nl = obs.shape[0], y_tiles.shape[0]
        cot = torch.randn((n, h, w, ch), generator=gen, device=dev).to(cdt)
        args = (y_tiles, k_agent, bias)
        f_ms, out = _cuda_ms(lambda: networks.agent_stamp(*args, obs), 10)
        b_ms, grads = _cuda_ms(lambda: torch.autograd.grad(networks.agent_stamp(*args, obs), args, cot), 5)
        b_ms -= f_ms
        pf_ms, pout = _cuda_ms(lambda: networks.agent_stamp_reference(*args, obs), 3)
        pb_ms, pgrads = _cuda_ms(lambda: torch.autograd.grad(networks.agent_stamp_reference(*args, obs), args, cot), 2)
        pb_ms -= pf_ms
        hold("agent_stamp", f"K9b timed {tag} forward", (out,), (pout,), ("out",))
        for gname, a, b in zip(("dy_tiles", "dk", "dbias"), grads, pgrads):
            _rel_err(f"K9b timed {tag} {gname}", a, b, 1e-2)
        del pout, pgrads
        fixed_ms, fixed = _cuda_ms(lambda: networks.agent_stamp_backward_reference(cot, out, obs, nl), 1, warm=False)
        hold("agent_stamp", f"K9b timed {tag} backward", grads, fixed, ("dy_tiles", "dk", "dbias"))
        del fixed

        # the library's way to the same function: the one-hot agent plane through
        # its conv, then add and ReLU, with autograd's backward; timed here, used
        # nowhere in the port
        k_lib = params["conv_0_kernel"][:, c_t:].detach().clone().requires_grad_(True)
        b_lib = params["conv_0_bias"].detach().clone().requires_grad_(True)
        y_lib = y.detach().clone().requires_grad_(True)

        def library(obs=obs, n=n, k_lib=k_lib, b_lib=b_lib, y_lib=y_lib):
            plane = torch.nn.functional.one_hot(obs.long(), h * w).to(cdt).reshape(n, 1, h, w)
            y_agent = torch.nn.functional.conv2d(plane, k_lib.to(cdt), padding=1)
            y_sum = y_agent.reshape(n // y_lib.shape[0], *y_lib.shape) + y_lib
            return torch.relu(y_sum + b_lib.to(cdt)[:, None, None]).reshape(n, ch, h, w)

        with networks.exact_kernels():
            with torch.no_grad():
                l_ms, lout = _cuda_ms(library, 5)
            lb_ms, lgrads = _cuda_ms(
                lambda: torch.autograd.grad(library(), (y_lib, k_lib, b_lib), cot.permute(0, 3, 1, 2)), 3)
        lb_ms -= l_ms
        # the library rounds every add to bfloat16; the kernel rounds once
        _rel_err(f"K9b timed {tag} vs the library's conv", out.permute(0, 3, 1, 2), lout, 3e-2)
        _rel_err(f"K9b timed {tag} dk vs the library's", grads[1], lgrads[1][:, 0].permute(1, 2, 0), 5e-2)
        _rel_err(f"K9b timed {tag} dbias vs the library's", grads[2], lgrads[2], 5e-2)
        del lout, lgrads
        elem = n * h * w * ch
        fb = bound(elem * 2 + nl * h * w * ch * 2 + n * 4, INSTR_K9B_FWD * elem)
        bb = bound(elem * 4 + nl * h * w * ch * 2 + n * 4, INSTR_K9B_BWD * elem)
        print(f"K9b timed {tag} N={n} Nl={nl} {h}x{w} ch0={ch} bfloat16: forward {f_ms!r} ms (plain {pf_ms!r}, library "
              f"conv + add + ReLU {l_ms!r}, bound {fb['bound_ms']!r} by {fb['bound_by']}), backward {b_ms!r} ms "
              f"(autograd of plain {pb_ms!r}, of the library's {lb_ms!r}, plain fixed-order {fixed_ms!r}, bound "
              f"{bb['bound_ms']!r} by {bb['bound_by']}); forward bit-exact vs plain, backward bit-exact vs the plain "
              f"fixed-order backward and within 1e-2 of autograd's scale ({smi})")
        if tag == "minibatch":
            both = bound(elem * 6 + 2 * nl * h * w * ch * 2 + 2 * n * 4, (INSTR_K9B_FWD + INSTR_K9B_BWD) * elem)
            times["agent_stamp"] = dict(ms=f_ms + b_ms, plain_ms=pf_ms + pb_ms, library_ms=l_ms + lb_ms,
                                        shape=f"forward + backward, N={n} Nl={nl} {h}x{w} ch0={ch} bfloat16", **both)
    return launches, errs, times


# kernels a K8a draw launches up to 16,384 picks: score, four histogram passes, count,
# compaction, sort and weights (each main path draws at most 4,096)
K8A_LAUNCHES = 8
K8A_SCORE_ULPS = 4      # logf and one more rounding of α·log p + g
K8A_WEIGHT_RTOL = 2e-5  # expf, powf and the mass summed in another order


def maze_probe_phases(gt, dev, bound, smi):
    """Phases 15-16: K11, P1 and P2 against their plain versions, the maze
    and probe main path with its launches counted, and the times. Returns
    (launches, errs, times, the 65,536 backtracker mazes as a Level)."""
    from griduniverse_tpu_torch import kernels
    from griduniverse_tpu_torch.core import semantics as S
    from griduniverse_tpu_torch.levels import maze as M
    from griduniverse_tpu_torch.ops import bitplane as bp
    from griduniverse_tpu_torch.tools import gather_probe

    names = ("backtracker_mazes", "gather_1d", "take_along_axis1")
    errs = dict.fromkeys(names, 0.0)
    times = {}
    sem = gt.make_semantics()

    # -- phase 15: K11 against its plain version at small shapes -------------
    for cells, b in (((1, 1), 8), ((2, 2), 4096), ((3, 7), 512), ((6, 6), 512)):
        got, _ = M.generate_mazes_device(99, cells, b, "backtracker")
        ref = M.backtracker_mazes_reference(cells, b, seed=99, device=dev)
        errs["backtracker_mazes"] = max(errs["backtracker_mazes"], _same(f"K11 {cells}", got, ref))
        _require(all(M.check_perfect_maze(g, cells) for g in got[:256].cpu().numpy()), f"K11 {cells}: a maze is not perfect")
    g2, _ = M.generate_mazes_device(8, (2, 2), 4096, "backtracker")
    sides = torch.stack([g2[:, 2, 1], g2[:, 2, 3], g2[:, 1, 2], g2[:, 3, 2]], dim=1)
    open_mask = (sides != S.WALL).cpu().numpy()
    _require(bool((open_mask.sum(axis=1) == 3).all()), "K11 2x2: not a spanning tree")
    counts = np.bincount(np.argmin(open_mask, axis=1), minlength=4)
    _require(counts[1] == 0 and counts[3] == 0 and abs(counts[0] - 2048) < 5 * 32,
             f"K11 2x2: a depth-first walk gives the two trees that lack an edge at the start cell, each half: {counts}")
    print(f"K11 cells=(1,1), (2,2), (3,7), (6,6): bit-exact vs plain, all perfect; 2x2 tree counts {counts.tolist()}")

    # -- phase 16: the maze and probe main path, counted ----------------------
    torch.cuda.synchronize()
    kernels.reset_launches()
    n64, n33, n127 = 65_536, 8_192, 1_024
    g64, start64 = M.generate_mazes_device(2026, (4, 4), n64)       # the default algorithm: the backtracker
    g33, _ = M.generate_mazes_device(2027, (16, 16), n33)
    # the 65x65 grid of the shared-Q run above 8,192 entries, and the largest maze the port packs
    g65, _ = M.generate_mazes_device(2029, (32, 32), n64)
    g127, _ = M.generate_mazes_device(2030, (63, 63), n127)
    shapes = (("9x9", g64, (4, 4), 2026), ("33x33", g33, (16, 16), 2027),
              ("65x65", g65, (32, 32), 2029), ("127x127", g127, (63, 63), 2030))
    for tag, grids, cells, _ in shapes:
        s = cells[0] * cells[1]
        n_open = (grids != S.WALL).sum(dim=(1, 2))
        _require(bool((n_open == 2 * s - 1).all()), f"K11 {tag}: a maze has the wrong number of open tiles")
        _require(bool((grids[:, -2, -2] == S.GOAL).all()), f"K11 {tag}: goal missing")
        n_check = {"9x9": 1024, "33x33": 128}.get(tag, 16)
        _require(all(M.check_perfect_maze(g, cells) for g in grids[:n_check].cpu().numpy()), f"K11 {tag}: a maze is not perfect")
        print(f"K11 main {tag} B={grids.shape[0]}: every maze has {2 * s - 1} open tiles; {n_check} checked perfect")
    lv64 = gt.Level(grid=g64, start_idx=start64.expand(n64).contiguous())
    fn = bp.compile_rollout_random(sem, bp.pack_level(lv64), n64, 1_000, max_episode_steps=MAX_EPISODE_STEPS)
    _, stats = fn(7)
    _require(int(stats["episodes"]) > 0 and 1.0 <= float(stats["mean_length"]) <= MAX_EPISODE_STEPS,
             f"K1 over the backtracker mazes: implausible stats {stats}")
    print(f"K1 over the backtracker mazes B={n64} T=1000: episodes {int(stats['episodes'])}, "
          f"mean_length {float(stats['mean_length'])!r}")
    _require(gather_probe.probe_gather_1d() == "OK" and gather_probe.probe_take_along_axis() == "OK",
             "the gather probe did not report OK")
    torch.cuda.synchronize()
    launches = {name: kernels.LAUNCHES[name] for name in names}
    print(f"launches on the maze and probe main path: {launches}; K1 {kernels.LAUNCHES['random_scan_bits']}")
    _require(launches == {"backtracker_mazes": 4, "gather_1d": 3, "take_along_axis1": 2}
             and kernels.LAUNCHES["random_scan_bits"] == 1, f"maze and probe path: launches {launches}")
    print("gather probe: 1-D vector gather OK, 2-D take_along_axis OK (zero and seeded indices, and the step lookup)")

    # the main path's grids against the plain version, and the times
    times["backtracker_mazes"] = []
    for tag, grids, cells, seed in shapes:
        b, s = grids.shape[0], cells[0] * cells[1]
        ms, got = _cuda_ms(lambda: M.generate_mazes_device(seed, cells, b)[0], 5 if s <= 256 else 2)
        plain_ms, ref = _cuda_ms(lambda: M.backtracker_mazes_reference(cells, b, seed=seed, device=dev), 1, warm=False)
        errs["backtracker_mazes"] = max(errs["backtracker_mazes"], _same(f"K11 main {tag}", grids, ref))
        _same(f"K11 timed {tag}", got, ref)
        tiles = grids.shape[1] * grids.shape[2]
        # the grids written once; 2S - 1 iterations a maze, whatever the draws
        t11 = dict(ms=ms, plain_ms=plain_ms, shape=f"cells={cells} B={b}", library_ms=None,
                   **bound(b * tiles * 4, b * k11_function_ops(cells)))
        print(f"K11 main {tag}: grids bit-exact vs plain; kernel {ms!r} ms ({b / ms * 1e3!r} mazes/s), plain {plain_ms!r} ms, "
              f"bound {t11['bound_ms']!r} ms by {t11['bound_by']}; {ms * 1e-3 * bound.clock_hz / (2 * s - 1)!r} cycles "
              f"an iteration at {bound.clock_hz / 1e6!r} MHz, the grids' writing included ({smi})")
        times["backtracker_mazes"].append(t11)
        del got, ref

    states, envs = gather_probe.STEP_LOOKUP
    gen = torch.Generator(device=dev).manual_seed(4)
    codes = torch.randint(0, 4, (states,), generator=gen, device=dev, dtype=torch.int32)
    pos = torch.randint(0, states, (envs,), generator=gen, device=dev, dtype=torch.int32)
    ms, got = _cuda_ms(lambda: gather_probe.gather_1d(codes, pos), 50)
    plain_ms, ref = _cuda_ms(lambda: gather_probe.gather_1d_reference(codes, pos), 50)
    errs["gather_1d"] = _same("P1 timed", got, ref.to(torch.int32))
    # the plain version IS the one library call, `table[idx]`
    times["gather_1d"] = dict(ms=ms, plain_ms=plain_ms, library_ms=plain_ms, shape=f"table ({states},), {envs} indices",
                              **bound(states * 4 + envs * 8, INSTR_P1 * envs))
    table = torch.randint(0, 1000, (8, 256), generator=gen, device=dev, dtype=torch.int32)
    idx = torch.randint(0, 256, (8, 256), generator=gen, device=dev, dtype=torch.int32)
    ms, got = _cuda_ms(lambda: gather_probe.take_along_axis1(table, idx), 50)
    plain_ms, ref = _cuda_ms(lambda: gather_probe.take_along_axis1_reference(table, idx), 50)
    errs["take_along_axis1"] = _same("P2 timed", got, ref.to(torch.int32))
    times["take_along_axis1"] = dict(ms=ms, plain_ms=plain_ms, library_ms=plain_ms, shape="table (8, 256), indices (8, 256)",
                                     **bound(8 * 256 * 12, INSTR_P2 * 8 * 256))
    return launches, errs, times, lv64


_DQN_SCALARS = ("p_max", "t", "run_ret", "episodes", "ret_sum", "last_loss")
_K7C_FIELDS = ("agent_idx", "agent_code", "t", "state done", "action", "next_obs", "reward", "done", "run_ret",
               "episodes", "ret_sum")


def _fast_state(st):
    return st.agent_idx, st.agent_code, st.t, st.done


def resume_through_disk(gt, dev, smi, runs, walls16):
    """Phase 22: `dqn_run` at 65,536 envs on walls16 (uniform and PER, a ring
    of 131,072) saved after 60 steps by an async `CheckpointManager`,
    restored into a fresh template and run 60 more, against phase 18's 120
    unbroken steps; the same for `ppo_run` (1 + 1 updates against 2). The
    checkpoints go under `build/` of the checkout and are removed."""
    import shutil

    from griduniverse_tpu_torch import kernels, models
    from griduniverse_tpu_torch.utils import capture
    from griduniverse_tpu_torch.utils.checkpoint import CheckpointManager

    root = ROOT / "build" / "smoke_checkpoints"
    shutil.rmtree(root, ignore_errors=True)
    n64 = 65_536

    def through_disk(tag, state, step, template):
        """Async save, wait, restore; returns the restored state and prints
        the size and the times."""
        with CheckpointManager(root / tag, async_=True) as mgr:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(step, state)
            t_call = time.perf_counter() - t0
            mgr.wait()
            t_write = time.perf_counter() - t0
            size = sum(f.stat().st_size for f in (root / tag).rglob("*") if f.is_file())
            t0 = time.perf_counter()
            got_step, restored = mgr.restore_latest(template)
            torch.cuda.synchronize()
            t_read = time.perf_counter() - t0
        _require(got_step == step, f"{tag}: restored step {got_step}")
        print(f"checkpoint {tag}: {size} bytes; save {t_call * 1e3!r} ms until it returned (the host snapshot), "
              f"{t_write * 1e3!r} ms until written; restore {t_read * 1e3!r} ms ({smi})")
        return restored

    sem = gt.make_semantics()
    for name in ("dqn walls16 uniform", "dqn walls16 per"):
        level, cfg, at60, at120 = runs[name]
        restored = through_disk(name.replace(" ", "_"), at60, 60, models.dqn_init(sem, level, 0, cfg, n64))
        torch.cuda.synchronize()
        kernels.reset_launches()
        resumed = models.dqn_run(sem, level, restored, cfg, 60)
        torch.cuda.synchronize()
        # the resumed call is captured: 60 replays and its warm-up step
        ran = 60 + capture.WARMUP_STEPS
        _require(kernels.LAUNCHES["dqn_act"] == ran, f"{name} resumed: {kernels.LAUNCHES['dqn_act']} K7c launches")
        _same_dqn_state(f"{name} resumed through disk", resumed, at120)
        _require(resumed.seed == at120.seed and int(resumed.t) == 120, f"{name} resumed: seed or step counter")
        print(f"{name}: 60 steps, an async save, a restore into a fresh template and 60 more steps equal 120 unbroken "
              f"bit for bit (parameters, target, Adam, env state, the whole ring, priorities, statistics; K7c "
              f"launched {ran} times in the resumed run: 60 replays and the warm-up step)")
    cfg = models.PPOConfig(max_episode_steps=MAX_EPISODE_STEPS)
    ts0 = models.ppo_init(sem, walls16, 5, cfg, n64)
    two = models.ppo_run(sem, walls16, ts0, cfg, 2)
    restored = through_disk("ppo_walls16", models.ppo_run(sem, walls16, ts0, cfg, 1), 1,
                            models.ppo_init(sem, walls16, 0, cfg, n64))
    resumed = models.ppo_run(sem, walls16, restored, cfg, 1)
    _same_train_state("ppo walls16 resumed through disk", resumed, two)
    _require(resumed.seed == two.seed and resumed.update == 2, "ppo resumed: seed or update counter")
    print("ppo walls16 B=65536: 1 update, an async save, a restore into a fresh template and 1 more update equal "
          "2 unbroken bit for bit (parameters, Adam moments and count, env state, statistics)")
    shutil.rmtree(root, ignore_errors=True)


def _dqn_state_fields(ts):
    names = sorted(ts.params)
    fields, labels = [], []
    for tag, tree in (("param", ts.params), ("target", ts.target_params), ("mu", ts.opt_state.mu), ("nu", ts.opt_state.nu)):
        fields += [tree[k] for k in names]
        labels += [f"{tag} {k}" for k in names]
    st = ts.env_state
    fields += [ts.opt_state.count, st.agent_idx, st.agent_code, st.t, *ts.buf, ts.prio]
    labels += ["adam count", "agent_idx", "agent_code", "env t", *(f"buf.{f}" for f in ts.buf._fields), "prio"]
    fields += [getattr(ts, f).reshape(-1) for f in _DQN_SCALARS]
    return fields, labels + list(_DQN_SCALARS)


def _same_dqn_state(tag: str, a, b) -> None:
    fa, labels = _dqn_state_fields(a)
    fb, _ = _dqn_state_fields(b)
    _same_fields(tag, fa, fb, labels)


def replay_phases(gt, dev, gen, bound, smi, lv64):
    """Phases 17-20: K8a's and K8b's edge cases against their plain versions
    at a small shape, the DQN main paths at full width with their launches
    counted, every K8 launch of their steps 60..119 against the plain
    version on the step's own inputs, and the times.
    K7c is held at small shapes (ties in q, a shared level and per-env
    mazes, every episode edge) and at every one of those steps, and DQN and
    PPO resume through disk (phase 22).
    Returns (launches, max abs errors, times) by kernel name."""
    from griduniverse_tpu_torch import kernels, models
    from griduniverse_tpu_torch.core import semantics as S
    from griduniverse_tpu_torch.kernels import agent_stamp as stamp_kernels
    from griduniverse_tpu_torch.kernels import replay as k8
    from griduniverse_tpu_torch.kernels.dqn_act import DqnActPlan
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.models import a2c, dqn, networks
    from griduniverse_tpu_torch.ops import bitplane as bp
    from griduniverse_tpu_torch.tools.profile_turns import _plan_graph_ms
    from griduniverse_tpu_torch.utils import capture

    errs = {"per_sample": 0.0, "replay": 0.0, "dqn_act": 0.0}
    times = {}
    sem = gt.make_semantics()
    walls16 = builders.walls_and_goal_16x16()
    num_actions = sem.num_actions
    n64, cap64 = 65_536, 131_072

    def ring(cap):
        return dqn.ReplayBuffer(
            torch.randint(0, 256, (cap,), generator=gen, device=dev, dtype=torch.int32),
            torch.randint(0, 4, (cap,), generator=gen, device=dev, dtype=torch.int32),
            torch.randn((cap,), generator=gen, device=dev),
            torch.randint(0, 256, (cap,), generator=gen, device=dev, dtype=torch.int32),
            torch.rand((cap,), generator=gen, device=dev) < 0.3)

    def held_draw(tag, prio, noise, size, n, alpha=0.6, beta=0.4):
        """One K8a draw held against the plain version: scores to the ulp
        bound, the selection bit-exact on the kernel's own scores, weights
        to the stated tolerance. Returns (idx, w)."""
        size_t = torch.as_tensor(size, dtype=torch.int64, device=dev)
        beta_t = torch.as_tensor(beta, dtype=torch.float32, device=dev)
        idx, w, score = dqn._per_sample(prio, noise, size_t, n, alpha, beta_t)
        ref_score, pa = dqn.per_scores_reference(prio, noise, size_t, alpha)
        _ulp_err(f"K8a {tag} scores", score, ref_score, K8A_SCORE_ULPS)
        ref_idx, ref_w = dqn.per_select_reference(score, pa, size_t, beta_t, n)
        _same(f"K8a {tag} selection", idx, ref_idx)
        errs["per_sample"] = max(errs["per_sample"], _rel_err(f"K8a {tag} weights", w, ref_w, K8A_WEIGHT_RTOL))
        return idx, w

    # -- phase 17: K8b and K8a against their plain versions: the edge cases at a
    # small shape (phase 19 holds every launch of the main paths at full width)
    for cap, b, n in ((4096, 1024, 256),):
        got = ring(cap)
        ref = dqn.ReplayBuffer(*(x.clone() for x in got))
        prio_g = torch.rand((cap,), generator=gen, device=dev)
        prio_r = prio_g.clone()
        p_max = torch.tensor(3.5, device=dev)
        for at in (0, cap - b):
            batch, at_t = ring(b), torch.tensor(at, device=dev)
            dqn.buffer_write(got, at_t, batch, prio_g, p_max)
            dqn.replay_write_reference(ref, prio_r, at_t, batch, p_max)
            errs["replay"] = max(errs["replay"], _same_fields(f"K8b write cap={cap} at={at}", (*got, prio_g), (*ref, prio_r),
                                                              (*got._fields, "prio")))
        idx = torch.randint(0, cap, (n,), generator=gen, device=dev, dtype=torch.int32)
        idx[n // 2:] = idx[: n - n // 2]  # equal indices: the highest position wins
        _same_fields(f"K8b gather cap={cap}", dqn.replay_gather(got, idx), dqn.replay_gather_reference(ref, idx), got._fields)
        abs_err = torch.rand((n,), generator=gen, device=dev) * 5
        pm_g = dqn.prio_refresh(prio_g, idx, abs_err, 1e-3, p_max)
        pm_r = dqn.prio_refresh_reference(prio_r, idx, abs_err, 1e-3, p_max)
        _same_fields(f"K8b refresh cap={cap}", (prio_g, pm_g.reshape(1)), (prio_r, pm_r.reshape(1)), ("prio", "p_max"))
        _same(f"K8b refresh cap={cap}: the last of equal indices wins", prio_g[idx[-1].long()].reshape(1),
              (abs_err[-1] + 1e-3).reshape(1))
        print(f"K8b cap={cap} B={b} n={n}: write at both ends with the priority fill, gather and refresh with "
              "equal indices bit-exact vs plain")
        # the refresh at its one-block limit (a hash table in shared memory) and one row above (two launches)
        for n_r in (k8.MAX_HASH_REFRESH, k8.MAX_HASH_REFRESH + 1):
            for span in (64, cap64):  # at most 64 slots, each repeated; and slots across the whole ring
                prio_g = torch.rand((cap64,), generator=gen, device=dev)
                prio_r = prio_g.clone()
                idx = torch.randint(0, span, (n_r,), generator=gen, device=dev, dtype=torch.int32)
                idx[n_r // 2:] = idx[: n_r - n_r // 2].clone()
                abs_err = torch.rand((n_r,), generator=gen, device=dev) * 5
                before = kernels.LAUNCHES["replay"]
                pm_g = dqn.prio_refresh(prio_g, idx, abs_err, 1e-3, p_max)
                _require(kernels.LAUNCHES["replay"] - before == k8.refresh_launches(n_r),
                         f"K8b refresh n={n_r}: {kernels.LAUNCHES['replay'] - before} launches")
                pm_r = dqn.prio_refresh_reference(prio_r, idx, abs_err, 1e-3, p_max)
                errs["replay"] = max(errs["replay"], _same_fields(
                    f"K8b refresh n={n_r} over {span} slots", (prio_g, pm_g.reshape(1)), (prio_r, pm_r.reshape(1)),
                    ("prio", "p_max")))
        print(f"K8b refresh capacity {cap64}, n={k8.MAX_HASH_REFRESH} (one launch) and {k8.MAX_HASH_REFRESH + 1} "
              "(two), half the rows repeating a slot, over 64 slots and over the whole ring: prio and p_max "
              "bit-exact vs plain")

        prio = torch.rand((cap,), generator=gen, device=dev) * 4 + 1e-3
        prio[torch.randint(0, cap, (cap // 16,), generator=gen, device=dev)] = 0.0
        for size in (cap, cap // 2 + 37, 100):
            noise = a2c.draw_gumbel(gen, (cap,), dev)
            idx, w = held_draw(f"cap={cap} size={size}", prio, noise, size, n)
            _require(bool((idx >= 0).all()) and bool((idx < size).all()), f"K8a cap={cap} size={size}: a slot outside the valid region")
            if size < n:
                _require(bool((w[size:] == 1.0).all()), "K8a size < n: a fallback row's weight is not exactly 1")
        ones, flat = torch.ones(cap, device=dev), torch.zeros(cap, device=dev)
        idx, _ = held_draw(f"cap={cap} all scores equal", ones, flat, cap, n)
        _require(idx.tolist() == list(range(n)), "K8a: equal scores did not come out by lowest index")
        flat[torch.arange(0, cap, cap // 100, device=dev)] = 1.0
        held_draw(f"cap={cap} two levels of ties", ones, flat, cap, n)
        print(f"K8a cap={cap} n={n}: size = cap, cap/2 + 37 and 100 < n, and ties: scores within {K8A_SCORE_ULPS} ulp, "
              f"selection bit-exact on the kernel's own scores, weights within {K8A_WEIGHT_RTOL} (max abs err so far {errs['per_sample']!r})")

    # K7c at a small shape: q with many ties, a shared level and per-env mazes,
    # a short time limit, so that episodes end at the goal, in lava and by
    # truncation; every output of every step against the plain version
    ends = {"goal": 0, "lava": 0, "truncation": 0}
    b7 = 4096
    mazes4k = gt.Level(grid=lv64.grid[:b7].contiguous(), start_idx=lv64.start_idx[:b7].contiguous())
    corridor = builders.make_level_from_indices((2, 6), start_idx=0, goals=[5])  # a goal five steps away
    for lname, level in (("walls16", walls16), ("lava", builders.lava_level()), ("corridor", corridor),
                         ("mazes", mazes4k)):
        bl = bp.pack_level(level)
        st = bp.reset_bits(bl, None if bl.batched else b7)
        stats = (torch.zeros(b7, device=dev), torch.zeros((), dtype=torch.int64, device=dev), torch.zeros((), device=dev))
        store_buf, store_prio = ring(2 * b7), torch.rand((2 * b7,), generator=gen, device=dev)
        ref_buf, ref_prio = dqn.ReplayBuffer(*(x.clone() for x in store_buf)), store_prio.clone()
        for i in range(48):
            q = torch.randint(-2, 3, (b7, num_actions), generator=gen, device=dev).float() * 0.5
            explore = torch.rand(b7, generator=gen, device=dev) < 0.5
            rand_a = torch.randint(0, num_actions, (b7,), generator=gen, device=dev, dtype=torch.int32)
            if i % 2:  # the store form, into either half of a ring with priorities
                at_t, p_max = torch.tensor(b7 * (i // 2 % 2), device=dev), torch.rand((), generator=gen, device=dev)
                got = dqn.dqn_act_step(sem, bl, st, q, explore, rand_a, *stats, 16, ring=(store_buf, store_prio, at_t, p_max))
                ref = dqn.dqn_act_store_reference(sem, bl, st, q, explore, rand_a, *stats, (ref_buf, ref_prio, at_t, p_max), 16)
                errs["dqn_act"] = max(errs["dqn_act"], _same_fields(f"K7c store form {lname} ring", (*store_buf, store_prio),
                                                                    (*ref_buf, ref_prio), (*store_buf._fields, "prio")))
            else:
                got = dqn.dqn_act_step(sem, bl, st, q, explore, rand_a, *stats, 16)
                ref = dqn.dqn_act_step_reference(sem, bl, st, q, explore, rand_a, *stats, 16)
            errs["dqn_act"] = max(errs["dqn_act"], _same_fields(
                f"K7c {lname}", (*_fast_state(got[0]), *got[1:]), (*_fast_state(ref[0]), *ref[1:]), _K7C_FIELDS))
            done, code = got[4], bp.tile_code(bl, got[2])
            ends["goal"] += int((done & (code == S.GOAL)).sum())
            ends["lava"] += int((done & (code == S.LAVA)).sum())
            ends["truncation"] += int((done & ~sem.terminal[code.long()]).sum())
            st, stats = got[0], got[5:]
    _require(all(v > 0 for v in ends.values()), f"K7c small shapes: an episode edge never happened: {ends}")
    print(f"K7c B={b7}, walls16, lava, a corridor and per-env mazes, 48 steps each, q with ties, every other step the store "
          f"form into a ring of {2 * b7} with priorities: every output, the ring and the priorities bit-exact vs plain; "
          f"episodes ended {ends}")

    # -- phase 18: the DQN main paths at full width, each counted --------------
    base = dict(buffer_capacity=cap64, max_episode_steps=MAX_EPISODE_STEPS)
    cfgs = {
        "dqn walls16 uniform": (walls16, models.DQNConfig(**base), 300),
        "dqn walls16 per": (walls16, models.DQNConfig(**base, prioritized=True), 300),
        # above the 1,024 picks of one block: K8a's picks in dynamic shared
        # memory, K8b's refresh in one block over a hash table
        "dqn walls16 per n4096": (walls16, models.DQNConfig(**base, prioritized=True, batch_size_train=4096), 60),
        "dqn mazes64k grid": (lv64, models.DQNConfig(**base, obs="grid", conv_channels=(32,), hidden=(64,)), 100),
    }
    path_launches, runs = {}, {}
    for name, (level, cfg, steps) in cfgs.items():
        models.dqn_train(sem, level, 1, cfg, 2, n64)  # first call: library handles, allocator
        torch.cuda.reset_peak_memory_stats()
        # a step: the acting forward, three forwards and one backward of the loss
        net_kernel, per_step = (("agent_stamp", 1 + 3 + stamp_kernels.backward_launches()) if cfg.obs == "grid"
                                else ("embed_rows", 1 + 3 + 2))
        # a step: K7c's store form (the act, the step, the statistics and the ring write), then
        # K8b's gather, with PER the refresh (two launches above 8,192 rows)
        refresh = k8.refresh_launches(cfg.batch_size_train) if cfg.prioritized else 0
        ran = steps + capture.WARMUP_STEPS  # the captured call's replays and its warm-up step
        expected = {net_kernel: ran * per_step, "replay": ran * (1 + refresh),
                    "per_sample": ran * K8A_LAUNCHES if cfg.prioritized else 0, "dqn_act": ran}
        torch.cuda.synchronize()
        kernels.reset_launches()
        capture.reset_counts()
        t0 = time.perf_counter()
        res = models.dqn_train(sem, level, 5, cfg, steps, n64)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {k: v for k, v in kernels.LAUNCHES.items() if v}
        path_launches[name] = got
        print(f"launches on the main path {name}: {got}")
        _require(got == {k: v for k, v in expected.items() if v}, f"{name}: launches {got}, expected {expected}")
        _require(capture.COUNTS == {"captures": 1, "warmup_steps": capture.WARMUP_STEPS, "replays": steps},
                 f"{name}: {capture.COUNTS}")
        peak = torch.cuda.max_memory_allocated()
        finite = all(bool(torch.isfinite(p).all()) for p in res.params.values())
        # a run of 60 steps need not see an episode of walls16 end (the limit is 512)
        ended = int(res.episodes) > 0 or steps < 100
        _require(finite and bool(torch.isfinite(res.final_loss)) and bool(torch.isfinite(res.mean_return))
                 and float(res.final_loss) > 0 and ended,
                 f"{name}: a non-finite parameter, a loss of {float(res.final_loss)}, or {int(res.episodes)} episodes")
        _require(all(p.device.type == "cuda" for p in res.params.values()), f"{name}: parameters are not on the card")
        print(f"{name} main: B={n64} capacity={cap64} steps={steps}: {ms!r} ms, {steps * n64 / ms * 1e3!r} env steps/s, "
              f"episodes {int(res.episodes)}, mean_return {float(res.mean_return)!r}, final_loss {float(res.final_loss)!r}, "
              f"peak memory {peak / 2**30:.3f} GiB ({smi})")
        # chunk invariance on the card (not counted): 60 + 60 against 120, and the whole run twice
        ts0 = models.dqn_init(sem, level, 5, cfg, n64)
        at60 = models.dqn_run(sem, level, ts0, cfg, 60)
        at120 = models.dqn_run(sem, level, at60, cfg, 60)
        _same_dqn_state(f"{name} chunked 60+60 vs 120", at120, models.dqn_run(sem, level, ts0, cfg, 120))
        whole = models.dqn_run(sem, level, ts0, cfg, steps)
        _same_fields(f"{name} a second run", [res.params[k] for k in sorted(res.params)],
                     [whole.params[k] for k in sorted(whole.params)], sorted(res.params))
        _same(f"{name} a second run: final_loss", res.final_loss.reshape(1), whole.last_loss.reshape(1))
        _require(int(whole.t) == steps and int(ts0.t) == 0 and not bool(ts0.buf.obs.any()), f"{name}: the state given was written")
        print(f"{name} main: 60+60 steps from a saved state equal 120 unbroken bit for bit (parameters, target, Adam, "
              "env state, the whole ring, priorities, statistics); two runs give the same bits")
        runs[name] = (level, cfg, at60, at120)

    launches = {k: sum(path.get(k, 0) for path in path_launches.values()) for k in errs}
    print(f"launches on the off-policy main paths, summed: {launches}")
    _require(all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}")

    # -- phase 19: steps 60..119 of each main path against the plain rule ------
    def plain_act(*args, plan=None, ring=None):
        return dqn.dqn_act_store_reference(*args[:9], ring, *args[9:])

    plain_ring = dict(replay_gather_cuda=dqn.replay_gather_reference, prio_refresh_cuda=dqn.prio_refresh_reference,
                      dqn_act_step=plain_act)
    kept = {}
    for name, (level, cfg, at60, at120) in runs.items():
        learner = dqn.dqn_learner(sem, level, cfg, n64)
        scalars = dqn.step_scalars(cfg, at60.t, 60, n64)

        def redo(patches):
            """Steps 60..119 once more, by the trainer's own step function on
            the trainer's own draws; `hold` sees every step."""
            params, target, opt_state, env_state = at60.params, at60.target_params, at60.opt_state, at60.env_state
            buf = dqn.ReplayBuffer(*(x.clone() for x in at60.buf))
            prio, p_max = at60.prio.clone(), at60.p_max
            stats = (at60.run_ret, at60.episodes, at60.ret_sum)
            learner.act_plan.bind_ring(buf, prio if cfg.prioritized else None)  # as `dqn_run` binds its ring
            patched = mock.patch.multiple(dqn, **patches) if patches else contextlib.nullcontext()
            with networks.exact_kernels(), patched:
                for i in range(60):
                    sc = scalars[i]
                    draws = dqn.step_draws(dev, at60.seed, 60 + i, cfg, n64, num_actions, sc.eps, sc.size)
                    before = (dqn.ReplayBuffer(*(x.clone() for x in buf)), prio.clone(), p_max)
                    pre = (params, env_state, stats)
                    upd = dqn.dqn_update(sem, learner, cfg, params, target, opt_state, env_state, buf, prio, p_max, sc,
                                         draws, stats)
                    if not patches:
                        hold_step(f"{name} step {60 + i}", cfg, before, pre, upd, sc, draws, buf, prio)
                    params, target, opt_state, env_state, p_max = (upd.params, upd.target_params, upd.opt_state,
                                                                   upd.env_state, upd.p_max)
                    stats = upd.stats
            kept[name] = (buf, prio, upd, sc, draws)
            return type(at120)(**{**vars(at120), "params": params, "target_params": target, "opt_state": opt_state,
                                  "env_state": env_state, "buf": buf, "prio": prio, "p_max": p_max,
                                  "run_ret": stats[0], "episodes": stats[1], "ret_sum": stats[2], "last_loss": upd.loss})

        def hold_step(tag, cfg, before, pre, upd, sc, draws, buf, prio):
            """Every K7c and K8 launch of one step against its plain version
            on the step's own inputs: K7c's store form's outputs, then the
            ring it wrote, the draw, the gather and the refresh."""
            params, env_state, stats = pre
            with torch.no_grad():
                q, _ = a2c._net_apply(learner.net, params, env_state.agent_idx, learner.tiles)
            ref = dqn.dqn_act_step_reference(sem, learner.bl, env_state, q, draws[0], draws[1], *stats,
                                             cfg.max_episode_steps)
            b_ = upd.batch
            errs["dqn_act"] = max(errs["dqn_act"], _same_fields(
                f"K7c main {tag}", (*_fast_state(upd.env_state), b_.action, b_.next_obs, b_.reward, b_.done, *upd.stats),
                (*_fast_state(ref[0]), *ref[1:]), _K7C_FIELDS))
            _same(f"K7c main {tag} obs", b_.obs, env_state.agent_idx)
            ref_buf, ref_prio, ref_p_max = before
            dqn.replay_write_reference(ref_buf, ref_prio if cfg.prioritized else None, sc.at, upd.batch, ref_p_max)
            if cfg.prioritized:
                ref_score, pa = dqn.per_scores_reference(ref_prio, draws[2], sc.size, cfg.per_alpha)
                _ulp_err(f"K8a main {tag} scores", upd.score, ref_score, K8A_SCORE_ULPS)
                ref_idx, ref_w = dqn.per_select_reference(upd.score, pa, sc.size, sc.beta, cfg.batch_size_train)
                _same(f"K8a main {tag} selection", upd.idx, ref_idx)
                errs["per_sample"] = max(errs["per_sample"], _rel_err(f"K8a main {tag} weights", upd.w, ref_w, K8A_WEIGHT_RTOL))
            errs["replay"] = max(errs["replay"], _same_fields(f"K8b main {tag} gather", upd.mb,
                                                              dqn.replay_gather_reference(ref_buf, upd.idx), upd.mb._fields))
            if cfg.prioritized:
                ref_p_max = dqn.prio_refresh_reference(ref_prio, upd.idx, upd.abs_err, cfg.per_eps, ref_p_max)
                _same(f"K8b main {tag} p_max", upd.p_max.reshape(1), ref_p_max.reshape(1))
            _same_fields(f"K8b main {tag} ring", (*buf, prio), (*ref_buf, ref_prio), (*buf._fields, "prio"))

        _same_dqn_state(f"{name}: steps 60..119 redone with the kernels", redo({}), at120)
        msg = (f"{name} main, steps 60..119 redone by the trainer's step function end in the main path's state; at every "
               "step K7c's store form's outputs (state, transition, statistics), the ring after its write and the "
               "refresh, the minibatch and p_max bit-exact vs plain")
        if cfg.prioritized:
            msg += (f", K8a's scores within {K8A_SCORE_ULPS} ulp, its selection bit-exact on its own scores, its weights "
                    f"within {K8A_WEIGHT_RTOL}")
        else:  # no float of K7c or K8 differs from plain here, so the whole run must repeat with the plain versions
            _same_dqn_state(f"{name}: steps 60..119 redone with the plain ring and act-step", redo(plain_ring), at120)
            msg += "; redone with the plain ring and act-and-store they end in the same state bit for bit"
        print(msg)

    # -- phase 22: resume through disk ------------------------------------------
    resume_through_disk(gt, dev, smi, runs, walls16)

    # -- phase 20: times at the main path's shapes -----------------------------
    alpha, cap = 0.6, cap64

    def k8a_timed(key, n, reps):
        """K8a at n picks on the last step's ring of the main path `key`, timed
        beside the plain draw and `torch.topk` with the same lines; the
        timed draw's selection held bit-exact on its own scores and its
        weights to the tolerance. Returns the row of the record."""
        _, prio, _, sc, draws = kept[key]
        noise = draws[2]
        ms, (idx, w, score) = _cuda_ms(lambda: dqn._per_sample(prio, noise, sc.size, n, alpha, sc.beta), reps)

        def plain_draw():
            ref_score, pa = dqn.per_scores_reference(prio, noise, sc.size, alpha)
            return dqn.per_select_reference(ref_score, pa, sc.size, sc.beta, n)

        def library():  # `torch.topk` with the same elementwise lines: timed here, used nowhere in the port
            ref_score, pa = dqn.per_scores_reference(prio, noise, sc.size, alpha)
            top = torch.topk(ref_score, n).indices
            picked = pa[top]
            wl = (sc.size.clamp(min=1).to(torch.float32) * (picked / pa.sum().clamp(min=1e-30))) ** (-sc.beta)
            return top, wl / wl.max()

        plain_ms, (p_idx, _) = _cuda_ms(plain_draw, max(reps // 5, 2))
        lib_ms, (l_idx, _) = _cuda_ms(library, max(reps // 2, 2))
        _, pa = dqn.per_scores_reference(prio, noise, sc.size, alpha)
        own_idx, own_w = dqn.per_select_reference(score, pa, sc.size, sc.beta, n)
        _same(f"K8a timed n={n} selection", idx, own_idx)
        errs["per_sample"] = max(errs["per_sample"], _rel_err(f"K8a timed n={n} weights", w, own_w, K8A_WEIGHT_RTOL))
        common = len(set(idx.tolist()) & set(l_idx.tolist()))
        _require(common >= n - 2, f"K8a n={n}: the library yardstick picks other slots ({common} of {n} in common)")
        row = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, shape=f"capacity {cap}, size {int(sc.size)}, n={n}",
            # priorities and noise read once, idx and weights written
            **bound(cap * 8 + n * 8, (INSTR_K8A_SCORE + INSTR_K8A_PICK) * cap))
        print(f"time per_sample at {row['shape']}: kernel {ms!r} ms, plain {plain_ms!r} ms, bound {row['bound_ms']!r} ms "
              f"by {row['bound_by']}, library (torch.topk with the same lines) {lib_ms!r} ms; selection bit-exact on "
              f"its own scores, {int((idx == p_idx).sum())} of {n} picks equal the plain draw's, {common} among "
              f"torch.topk's ({smi})")
        return row

    times["per_sample"] = k8a_timed("dqn walls16 per", 256, 50)
    k8a_timed("dqn walls16 per n4096", 4096, 20)
    k8a_timed("dqn walls16 per n4096", 16_384, 10)

    buf, prio, upd, sc, _ = kept["dqn walls16 per"]
    n, p_max = upd.idx.shape[0], upd.p_max
    w_ms, _ = _cuda_ms(lambda: dqn.buffer_write(buf, sc.at, upd.batch, prio, p_max), 50)
    g_ms, _ = _cuda_ms(lambda: dqn.replay_gather(buf, upd.idx), 50)
    r_ms, _ = _cuda_ms(lambda: dqn.prio_refresh(prio, upd.idx, upd.abs_err, 1e-3, p_max), 50)
    ref_buf, ref_prio = dqn.ReplayBuffer(*(x.clone() for x in buf)), prio.clone()
    pw_ms, _ = _cuda_ms(lambda: dqn.replay_write_reference(ref_buf, ref_prio, sc.at, upd.batch, p_max), 10)
    pg_ms, _ = _cuda_ms(lambda: dqn.replay_gather_reference(ref_buf, upd.idx), 10)
    pr_ms, _ = _cuda_ms(lambda: dqn.prio_refresh_reference(ref_prio, upd.idx, upd.abs_err, 1e-3, p_max), 10)
    _same_fields("K8b timed", (*buf, prio), (*ref_buf, ref_prio), (*buf._fields, "prio"))
    slots = sc.at + torch.arange(n64, device=dev)
    rows = upd.idx.long()

    def library_ring():  # the library's scatters and gathers for the same three functions; used nowhere in the port
        for full, part in zip(ref_buf, upd.batch):
            full.index_copy_(0, slots, part)
        ref_prio.index_fill_(0, slots, 3.5)
        out = [torch.index_select(full, 0, rows) for full in ref_buf]
        fresh = upd.abs_err + 1e-3
        ref_prio.index_put_((rows,), fresh)
        return out, torch.maximum(p_max, fresh.max())

    lib_ms, _ = _cuda_ms(library_ring, 20)
    times["replay"] = dict(
        ms=w_ms + g_ms + r_ms, plain_ms=pw_ms + pg_ms + pr_ms, library_ms=lib_ms,
        # the write is the public `buffer_write`'s; the trainer's is K7c's store form
        shape=f"write B={n64} (buffer_write) + gather n={n} + refresh n={n}, capacity {cap}",
        # a transition is 17 bytes read and written, its priority 4; the gather reads an index and moves 17 bytes; the refresh 12
        **bound(n64 * (2 * 17 + 4) + n * (4 + 2 * 17) + n * 12,
                INSTR_K8B_WRITE * n64 + (INSTR_K8B_GATHER + INSTR_K8B_REFRESH) * n))
    print(f"K8b timed: write {w_ms!r} ms, gather {g_ms!r} ms, refresh {r_ms!r} ms; plain {pw_ms!r}, {pg_ms!r}, {pr_ms!r} ms; "
          f"index_copy_ x5 + index_fill_ + index_select x5 + index_put_ + max {lib_ms!r} ms ({smi})")

    # K8b's gather and refresh at 4,096 picks, on that main path's last step
    buf, prio, upd, sc, draws = kept["dqn walls16 per n4096"]
    n = upd.idx.shape[0]
    rows = upd.idx.long()
    g_ms, _ = _cuda_ms(lambda: dqn.replay_gather(buf, upd.idx), 50)
    r_ms, _ = _cuda_ms(lambda: dqn.prio_refresh(prio, upd.idx, upd.abs_err, 1e-3, upd.p_max), 50)
    ref_buf, ref_prio = dqn.ReplayBuffer(*(x.clone() for x in buf)), prio.clone()
    pg_ms, _ = _cuda_ms(lambda: dqn.replay_gather_reference(ref_buf, upd.idx), 10)
    pr_ms, _ = _cuda_ms(lambda: dqn.prio_refresh_reference(ref_prio, upd.idx, upd.abs_err, 1e-3, upd.p_max), 10)
    _same(f"K8b timed refresh n={n}", prio, ref_prio)

    def library_rows():  # the library's gathers and scatter for the same two functions; used nowhere in the port
        out = [torch.index_select(full, 0, rows) for full in ref_buf]
        fresh = upd.abs_err + 1e-3
        ref_prio.index_put_((rows,), fresh)
        return out, torch.maximum(upd.p_max, fresh.max())

    lib_ms, _ = _cuda_ms(library_rows, 20)
    t8b = bound(n * (4 + 2 * 17) + n * 12, (INSTR_K8B_GATHER + INSTR_K8B_REFRESH) * n)
    print(f"time replay gather + refresh at n={n}, capacity {cap}: kernel {g_ms!r} + {r_ms!r} ms (the refresh one launch), "
          f"plain {pg_ms!r} + {pr_ms!r} ms, bound {t8b['bound_ms']!r} ms by {t8b['bound_by']}, "
          f"library (index_select x5 + index_put_ + max) {lib_ms!r} ms ({smi})")

    # K7c at the main path's shape: walls16, 65,536 envs, A = 4, from the PER run's state after 120
    # steps: its store form (the trainer's act-and-store) against K7c followed by K8b's write
    level, cfg, _, at120 = runs["dqn walls16 per"]
    learner = dqn.dqn_learner(sem, level, cfg, n64)
    with torch.no_grad(), networks.exact_kernels():
        q, _ = a2c._net_apply(learner.net, at120.params, at120.env_state.agent_idx, learner.tiles)
    explore = torch.rand(n64, generator=gen, device=dev) < 0.05
    rand_a = torch.randint(0, num_actions, (n64,), generator=gen, device=dev, dtype=torch.int32)
    args = (sem, learner.bl, at120.env_state, q, explore, rand_a, at120.run_ret, at120.episodes, at120.ret_sum,
            cfg.max_episode_steps)
    at_t, p_max = dqn.step_scalars(cfg, at120.t, 1, n64).at[0], at120.p_max

    def ring_for(plan):
        buf, prio = dqn.ReplayBuffer(*(x.clone() for x in at120.buf)), at120.prio.clone()
        plan.bind_ring(buf, prio)
        return buf, prio

    def store(plan, ring):  # as `dqn_update` calls it: through the run's plan, its ring bound once
        return dqn.dqn_act_step(*args, plan=plan, ring=(*ring, at_t, p_max))

    def act_then_write(plan, ring):  # the act-and-store before the store form: K7c, then K8b's write
        out = dqn.dqn_act_step(*args, plan=plan)
        dqn.buffer_write(ring[0], at_t, dqn.ReplayBuffer(args[2].agent_idx, out[1], out[3], out[2], out[4]), ring[1], p_max)
        return out

    ring_k = ring_for(learner.act_plan)
    ms, got = _cuda_ms(lambda: store(learner.act_plan, ring_k), 50)
    pair_ms, pair = _cuda_ms(lambda: act_then_write(learner.act_plan, ring_k), 50)
    k7c_ms, _ = _cuda_ms(lambda: dqn.dqn_act_step(*args, plan=learner.act_plan), 50)
    ref_ring = (dqn.ReplayBuffer(*(x.clone() for x in at120.buf)), at120.prio.clone())
    plain_ms, ref = _cuda_ms(lambda: dqn.dqn_act_store_reference(*args[:9], (*ref_ring, at_t, p_max), args[9]), 10)
    for tag, out in (("K7c's store form timed", got), ("K7c + K8b's write timed", pair)):
        errs["dqn_act"] = max(errs["dqn_act"], _same_fields(
            tag, (*_fast_state(out[0]), *out[1:]), (*_fast_state(ref[0]), *ref[1:]), _K7C_FIELDS))
    _same_fields("K7c's store form timed: the ring", (*ring_k[0], ring_k[1]), (*ref_ring[0], ref_ring[1]),
                 (*ring_k[0]._fields, "prio"))

    def new_plan():  # a plan is stream-ordered: a captured call's is built on the capture's stream
        return DqnActPlan(sem, learner.bl, n64, cfg.max_episode_steps)

    def graph(call):
        def make():
            plan = new_plan()
            return plan, ring_for(plan)
        return _plan_graph_ms(make, lambda pr: call(*pr))

    g_store, g_pair = graph(store), graph(act_then_write)
    g_k7c = _plan_graph_ms(new_plan, lambda pl: dqn.dqn_act_step(*args, plan=pl))
    g_store2 = graph(store)
    times["dqn_act"] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=None, graph_ms=g_store,
        shape=f"walls16 B={n64}, A={num_actions}, its store form into a ring of {cap64} with priorities (one launch)",
        # per env: q, the two draws (5 bytes), the state (12) and the running return (4) read; the new state
        # (13), the transition (13) and the running return (4) written; the ring's 17 bytes and the priority
        **bound(n64 * (4 * num_actions + 5 + 12 + 4 + 13 + 13 + 4 + 17 + 4), INSTR_K7C_STORE_ENV * n64))
    print(f"time K7c's store form walls16 B={n64} A={num_actions}, ring {cap64} with priorities: as timed {ms!r} ms, "
          f"in a CUDA graph of ten {g_store!r}, {g_store2!r} ms; K7c + K8b's write as timed {pair_ms!r} ms, in a graph "
          f"{g_pair!r} ms; K7c alone as timed {k7c_ms!r} ms, in a graph {g_k7c!r} ms; plain {plain_ms!r} ms; bound "
          f"{times['dqn_act']['bound_ms']!r} ms by {times['dqn_act']['bound_by']}; every output and the ring bit-exact "
          f"vs plain ({smi})")

    for name in ("dqn walls16 uniform", "dqn walls16 per"):
        level, cfg, _, at120 = runs[name]
        dqn_step_events(dev, smi, sem, level, cfg, at120)
    return launches, errs, times


def dqn_step_events(dev, smi, sem, level, cfg, state, steps: int = 20) -> None:
    """A DQN step's device events, host time and the card's idle share, from
    the same state, in turns: with K7c's store form (the trainer's path);
    with K7c followed by K8b's write (the path before the store form); and
    with the act, step, statistics and write as the port ran them before K7c
    (argmax, `where`, `step_bits`, `fold_episode_stats`, `buffer_write`)."""
    from griduniverse_tpu_torch import models
    from griduniverse_tpu_torch.models import a2c, dqn
    from griduniverse_tpu_torch.ops.bitplane import step_bits
    from griduniverse_tpu_torch.tools.profile_learners import _profile
    from griduniverse_tpu_torch.tools.profile_solvers import _wall_ms

    k7c = dqn.dqn_act_step

    def write(st, out, ring):
        buf, prio, at, p_max = ring
        dqn.buffer_write(buf, at, dqn.ReplayBuffer(st.agent_idx, out[1], out[3], out[2], out[4]), prio, p_max)
        return out

    def before_k7c(sem, bl, st, q, explore, rand_a, run_ret, episodes, ret_sum, max_episode_steps=None, plan=None,
                   ring=None):
        actions = torch.where(explore, rand_a.to(torch.int32), torch.argmax(q, dim=-1).to(torch.int32))
        new_st, (next_obs, reward, done) = step_bits(sem, bl, st, actions, True, max_episode_steps)
        run_ret, episodes, ret_sum = a2c.fold_episode_stats(run_ret, episodes, ret_sum, reward[None], done[None])
        return write(st, (new_st, actions, next_obs, reward, done, run_ret, episodes, ret_sum), ring)

    def k7c_then_write(*args, plan=None, ring=None):
        return write(args[2], k7c(*args, plan=plan), ring)

    def call():  # the eager loop: a step enqueued from the host, as this comparison has always timed it
        return dqn._dqn_run_eager(sem, level, state, cfg, steps)

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.zeros(1, device=dev).sum().item()  # the profiler's own start-up
    b = state.run_ret.shape[0]
    store, pair = "with K7c's store form", "with K7c, then K8b's write"
    for tag, patch in ((store, contextlib.nullcontext()),
                       (pair, mock.patch.object(dqn, "dqn_act_step", k7c_then_write)),
                       ("as before K7c", mock.patch.object(dqn, "dqn_act_step", before_k7c)),
                       ("as before K7c, again", mock.patch.object(dqn, "dqn_act_step", before_k7c)),
                       (pair + ", again", mock.patch.object(dqn, "dqn_act_step", k7c_then_write)),
                       (store + ", again", contextlib.nullcontext())):
        with patch:
            call()
            walls = sorted(_wall_ms(call) for _ in range(3))
            prof = _profile(f"dqn walls16 B={b} {steps} steps {tag}", call, walls[1], smi, top=4)
        _require(prof is not None, "the profiler recorded no device time for a DQN call")
        print(f"DQN step {tag}: {walls[1] / steps!r} ms a step on the host clock (median of 3 calls of {steps} steps: "
              f"{walls!r} ms), {prof[1] / steps!r} device events a step, device idle share {100 * prof[2]:.2f} % ({smi})")


def k13_compares(ids, valid) -> int:
    """The earlier steps that K13's first-visit scan reads on these (T, B)
    ids: for each valid step, those up to its first valid earlier step with
    the same id, else all its earlier steps."""
    steps = torch.arange(ids.shape[0], device=ids.device)
    hit = (ids[:, None, :] == ids[None, :, :]) & valid[None, :, :] & (steps[None, :, None] < steps[:, None, None])
    scanned = torch.where(hit.any(1), hit.int().argmax(1) + 1, steps[:, None])
    return int(scanned[valid].sum())


def mc_lambda_phases(gt, dev, bound, smi):
    """Phase 21: the Monte-Carlo and TD(λ) entry points on the card.
    `mc_prediction` with its defaults and five rounds of `mc_control` put
    256 episodes x 100 steps = 25,600 samples through one K10 call (four
    launches) a round, and `mc_prediction` at 1,024 episodes 102,400; every
    call is held bit for bit against the plain version on the run's own
    samples, and K10 is timed at both shapes.
    `sarsa_lambda`, `watkins_q_lambda` (walls16, 65,536 envs x 200 steps, a
    (65,536, 256, 4) trace) and `td_lambda_prediction` (65,536 envs, a
    (65,536, 256) trace) go through K12, one launch a step through the
    plan each run builds; steps 0-4 and 100-104 are redone by the plain
    version on the step's own inputs and must give the same table and trace
    bits, and two runs the same bits. K12 is timed at the three traces, a
    step through a plan as timed and in a CUDA graph of ten.
    K13 (the returns and the first-visit mask, one launch a round) is held
    at small shapes and on every round's own samples, timed as a call and
    in a CUDA graph of ten, and the mc calls are timed with it and with its
    plain versions.
    Returns (launches, max abs errors, times) of K12 and K13."""
    from griduniverse_tpu_torch import algos, kernels
    from griduniverse_tpu_torch.algos import mc, td, td_lambda
    from griduniverse_tpu_torch.kernels import segment_mean
    from griduniverse_tpu_torch.kernels import trace_pass as trace_kernels
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.tools.profile_kernels import _graph_ms
    from griduniverse_tpu_torch.tools.profile_turns import _plan_graph_ms

    sem = gt.make_semantics()
    lava = builders.lava_level()
    calls = []

    def recorded(q, s, a, delta, alpha, mask):
        out = td.apply_td_updates_masked(q, s, a, delta, alpha, mask)
        calls.append(((q, s, a, delta, alpha, mask), out))
        return out

    real_returns = mc.mc_returns
    returns_calls = []

    def recorded_returns(rewards, gamma, ids=None, valid=None):
        out = real_returns(rewards, gamma, ids, valid)
        returns_calls.append(((rewards, gamma, ids, valid), out))
        return out

    def plain_returns(rewards, gamma, ids=None, valid=None):
        """K13's plain versions, on the same tensors: what `mc` ran before K13."""
        return mc.discounted_returns(rewards, gamma), None if ids is None else mc.first_visit_mask(ids, valid)

    # -- K13 against its plain version at small shapes: T = 1 and 100, all
    # valid, none valid, repeated ids
    gen = torch.Generator(device=dev).manual_seed(13)
    errs = {"trace_pass": 0.0, "mc_returns": 0.0}
    for t13, b13, n_ids, kind in ((1, 300, 4, "random"), (100, 256, 81, "random"), (100, 1024, 324, "random"),
                                  (100, 256, 81, "all valid"), (100, 256, 81, "none valid"), (37, 64, 1, "one id"),
                                  (257, 4097, 300, "random"), (6000, 3, 900, "random")):
        lengths = torch.randint(0, t13 + 1, (b13,), generator=gen, device=dev)
        valid = torch.arange(t13, device=dev)[:, None] < lengths[None]
        if kind != "random":
            valid = torch.full_like(valid, kind != "none valid")
        rewards = torch.where(valid, torch.randn((t13, b13), generator=gen, device=dev), 0.0)
        ids = torch.randint(0, n_ids, (t13, b13), generator=gen, device=dev, dtype=torch.int32)
        got = mc.mc_returns(rewards, 0.99, ids, valid)
        errs["mc_returns"] = max(errs["mc_returns"], _same_fields(
            f"K13 T={t13} B={b13} {kind}", got, plain_returns(rewards, 0.99, ids, valid), ("returns", "first-visit mask")))
        _same(f"K13 T={t13} B={b13} {kind}, returns alone", mc.mc_returns(rewards, 0.99)[0], got[0])
    print("K13 T=1, 37, 100, 257 and 6,000 (two tiles of a block), B=3 to 4,097, random, all and no steps valid, "
          "repeated ids: returns and first-visit mask bit-exact vs plain")

    rounds, wide = 5, 1024
    torch.cuda.synchronize()
    kernels.reset_launches()
    with mock.patch.object(mc, "apply_td_updates_masked", recorded), mock.patch.object(mc, "mc_returns", recorded_returns):
        pred = algos.mc_prediction(sem, lava, 3)
        torch.cuda.synchronize()
        first = k10_launches(calls[0][0][1].shape[0], calls[0][0][0].numel(), dev)
        _require(kernels.LAUNCHES["segment_mean"] == first and kernels.LAUNCHES["mc_returns"] == 1,
                 f"mc_prediction: {kernels.LAUNCHES['segment_mean']} K10 and {kernels.LAUNCHES['mc_returns']} K13 "
                 f"launches, expected {first} (one call) and 1")
        ctl = algos.mc_control(sem, lava, 6, num_rounds=rounds)
        pred_wide = algos.mc_prediction(sem, lava, 4, batch_size=wide)
    torch.cuda.synchronize()
    got = {k: v for k, v in kernels.LAUNCHES.items() if v}
    print(f"launches of mc_prediction (defaults), {rounds} rounds of mc_control and mc_prediction at {wide} episodes: {got}")
    want10 = sum(k10_launches(args[1].shape[0], args[0].numel(), dev) for args, _ in calls)
    _require(len(calls) == 2 + rounds and got == {"segment_mean": want10, "mc_returns": 2 + rounds},
             f"mc: launches {got}, expected one K10 call ({want10} launches in all, one a call where the plan "
             "takes a cluster) and one K13 launch a round and no other kernel")
    for i, (args, out) in enumerate(returns_calls):
        errs["mc_returns"] = max(errs["mc_returns"], _same_fields(
            f"K13 mc round {i}", out, plain_returns(*args), ("returns", "first-visit mask")))
    print(f"K13 at mc's shapes: all {2 + rounds} launches bit-exact vs plain on the runs' own rewards, ids and valid "
          f"flags (T=100, B=256 and {wide}; state ids, and state-action ids in mc_control)")
    samples = calls[0][0][1].shape[0]
    _require(samples == 25_600 and all(c[0][1].shape[0] == samples for c in calls[:-1]), f"mc: a round's samples are not 25,600: {samples}")
    _require(calls[-1][0][1].shape[0] == wide * 100, f"mc at {wide} episodes: {calls[-1][0][1].shape[0]} samples")
    err = 0.0
    for i, (args, out) in enumerate(calls):
        err = max(err, _same(f"K10 mc round {i}", out, td.apply_td_updates_reference(*args)))
    visited = int((pred.counts > 0).sum())
    _require(bool(torch.isfinite(pred.value).all()) and visited > 1 and float(pred.counts.sum()) > 0
             and bool(torch.isfinite(ctl.q).all()) and bool((ctl.q != 0).any()) and int(ctl.episodes) == rounds * 256
             and bool(torch.isfinite(pred_wide.value).all()) and float(pred_wide.counts.sum()) > float(pred.counts.sum()),
             "mc: a non-finite value, no finished episode, or an untouched Q")
    for tag, args in (("a round of mc_control", calls[-2][0]), (f"mc_prediction at {wide} episodes", calls[-1][0])):
        n_samples, n_masked, seg = args[1].shape[0], int(args[5].sum()), args[0].numel()
        ms, got10 = _cuda_ms(lambda: td.apply_td_updates_masked(*args), 50)
        graph_ms = _graph_ms(lambda: td.apply_td_updates_masked(*args))
        passes_ms = _graph_ms(lambda: segment_mean.segment_mean_cuda(*args, tier="passes"))
        p10 = segment_mean.call_plan(n_samples, seg, dev)
        plain_ms, ref10 = _cuda_ms(lambda: td.apply_td_updates_reference(*args), 3)
        lib_ms, lib = _cuda_ms(lambda: _segment_mean_library(*args), 50)
        err = max(err, _same(f"K10 timed at {tag}", got10, ref10))
        _require(bool(torch.allclose(lib, ref10, rtol=1e-5, atol=1e-6)),
                 "K10 at mc's shape: the library yardstick computes another function")
        t10 = bound(n_samples * 13 + 2 * seg * 4, INSTR_K10_ENV * n_samples + 2 * seg)
        print(f"time segment_mean at {tag}, {n_samples} samples ({n_masked} under the first-visit mask), "
              f"S*A={seg} ({p10.tier}, {p10.blocks} blocks): kernel {ms!r} ms as timed, {graph_ms!r} ms in a CUDA "
              f"graph of ten; the four passes {passes_ms!r} ms in a graph; plain {plain_ms!r} ms, bound "
              f"{t10['bound_ms']!r} ms by {t10['bound_by']}, library (index_add_ twice, divide, add) {lib_ms!r} ms; "
              f"bit-exact vs plain ({smi})")
    print(f"K10 at mc's shapes: all {2 + rounds} calls bit-exact vs plain (max abs err {err!r}); "
          f"mc_prediction visited {visited} states ({smi})")

    # K13's time at a round of mc_control (the record's shape) and at 1,024 episodes, as
    # timed and in a CUDA graph of ten
    from griduniverse_tpu_torch.tools.profile_kernels import _graph_ms

    times = {}
    for tag, (args, _) in (("a round of mc_control", returns_calls[-2]), (f"mc_prediction at {wide} episodes", returns_calls[-1])):
        t13, b13 = args[0].shape
        ms, _ = _cuda_ms(lambda: mc.mc_returns(*args), 50)
        graph_ms = _graph_ms(lambda: mc.mc_returns(*args))
        plain_ms, _ = _cuda_ms(lambda: plain_returns(*args), 5)
        compares = k13_compares(args[2], args[3])
        # rewards, ids and valid flags read once, returns and mask written once
        t13b = dict(ms=ms, plain_ms=plain_ms, library_ms=None, shape=f"{tag}, T={t13}, B={b13}",
                    **bound(t13 * b13 * 14, INSTR_K13_SAMPLE * t13 * b13 + INSTR_K13_COMPARE * compares))
        print(f"time mc_returns at {t13b['shape']}: kernel {ms!r} ms, in a CUDA graph {graph_ms!r} ms, plain "
              f"{plain_ms!r} ms, bound {t13b['bound_ms']!r} ms by {t13b['bound_by']} ({compares} earlier steps "
              f"scanned), library None ms ({smi})")
        if "mc_control" in tag:
            times["mc_returns"] = t13b

    # the calls on the host clock with K13 and with its plain versions (what ran
    # before K13), and the card's idle share of an mc_prediction call
    from griduniverse_tpu_torch.tools.profile_learners import _profile
    from griduniverse_tpu_torch.tools.profile_solvers import _wall_ms

    entry_points = {"mc_prediction (256 episodes x 100 steps)": lambda: algos.mc_prediction(sem, lava, 3),
                    f"mc_prediction ({wide} episodes)": lambda: algos.mc_prediction(sem, lava, 4, batch_size=wide),
                    "a round of mc_control": lambda: algos.mc_control(sem, lava, 6, num_rounds=1)}
    for name, call in entry_points.items():
        walls = {}
        for tag, patch in (("K13", contextlib.nullcontext()), ("plain", mock.patch.object(mc, "mc_returns", plain_returns)),
                           ("plain again", mock.patch.object(mc, "mc_returns", plain_returns)),
                           ("K13 again", contextlib.nullcontext())):
            with patch:
                call()
                walls[tag] = sorted(_wall_ms(call) for _ in range(3))
        print(f"{name} on the host clock, median of 3 (all 3), K13 then plain then plain then K13: "
              f"{walls['K13'][1]!r} ({walls['K13']!r}), {walls['plain'][1]!r} ({walls['plain']!r}), "
              f"{walls['plain again'][1]!r}, {walls['K13 again'][1]!r} ms ({smi})")
        if name.startswith("mc_prediction (256"):
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
                torch.zeros(1, device=dev).sum().item()  # the profiler's own start-up
            prof = _profile(f"{name} with K13", call, walls["K13 again"][1], smi, top=6)
            _require(prof is not None, "the profiler recorded no device time for an mc_prediction call")
            print(f"{name} with K13: {prof[1]} device events, device idle share {100 * prof[2]:.2f} % ({smi})")

    # -- the trace pass (K12) at full width ------------------------------------
    walls16 = builders.walls_and_goal_16x16()
    launches = {"trace_pass": 0, "mc_returns": got["mc_returns"]}
    b, steps = 65_536, 200
    held = set(range(5)) | set(range(100, 105))
    policy = torch.full((walls16.num_states, sem.num_actions), 1.0 / sem.num_actions, device=dev)
    runs = {
        "sarsa_lambda": lambda n: algos.sarsa_lambda(sem, walls16, 5, num_steps=steps, batch_size=n),
        "watkins_q_lambda": lambda n: algos.watkins_q_lambda(sem, walls16, 5, num_steps=steps, batch_size=n),
        "td_lambda_prediction": lambda n: algos.td_lambda_prediction(sem, walls16, policy, 5, num_steps=steps, batch_size=n),
    }
    real_pass = td_lambda.trace_pass
    kept = {}

    def holding(name):
        """`trace_pass` that redoes the held steps with the plain version on
        copies of the step's own inputs, and keeps one step's inputs."""
        count = [0]

        def checked(table, e, *args, plan=None):
            i = count[0]
            count[0] += 1
            if i not in held:
                return real_pass(table, e, *args, plan=plan)
            table0, e_in = table.clone(), e.clone()
            out = real_pass(table, e, *args, plan=plan)
            e0 = e_in.clone()
            ref = td_lambda.trace_pass_reference(table0, e0, *args)
            errs["trace_pass"] = max(errs["trace_pass"], _same_fields(
                f"K12 {name} step {i}", (out, e), (ref, e0), ("table", "trace")))
            if i == 100:
                kept[name] = (table0, e_in, args)
            return out
        return checked

    def result(res):
        return res.v if hasattr(res, "v") else res.q

    for name, run in runs.items():
        run(1024)  # first call: allocator
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        first = run(b)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {k: v for k, v in kernels.LAUNCHES.items() if v}
        _require(trace_kernels.launches(b) == 1 and got == {"trace_pass": steps},
                 f"{name}: launches {got}, expected {steps} of K12 (one a step) and no other kernel")
        launches["trace_pass"] += got["trace_pass"]
        with mock.patch.object(td_lambda, "trace_pass", holding(name)):
            second = run(b)
        _same(f"{name} twice", result(first), result(second))
        # the uniform policy seldom reaches walls16's goal in 200 steps: only the learners must end episodes
        ended = int(first.episodes) > 0 or name == "td_lambda_prediction"
        _require(bool(torch.isfinite(result(first)).all()) and bool((result(first) != 0).any()) and ended
                 and int(first.episodes) == int(second.episodes),
                 f"{name}: a non-finite or untouched table, {int(first.episodes)} and {int(second.episodes)} episodes")
        print(f"{name} walls16 B={b} T={steps}: K12 launched {got['trace_pass']} times; steps {sorted(held)} bit-exact vs "
              f"plain (table and trace); two runs give the same bits; episodes {int(first.episodes)}; {ms!r} ms a call "
              f"on the host clock, {b * steps / ms * 1e3!r} transitions/s ({smi})")

    def dense_step(table, e, s, a, delta, cut, gamma, lam, cutoff, alpha, kind):
        """The step as the port ran it before K12, for comparison: dense
        passes over the trace and the env sum by torch's own reduction."""
        x = e if a is not None else e.unsqueeze(-1)
        x = td_lambda.decay_traces(x, gamma, lam, cutoff)
        x = td_lambda.bump_traces(x, s, torch.zeros_like(s) if a is None else a, x.shape[1], x.shape[2], kind)
        x = x.reshape(e.shape)
        shape = (-1,) + (1,) * (e.dim() - 1)
        num = (delta.reshape(shape) * x).sum(dim=0)
        cnt = (x != 0.0).sum(dim=0).to(torch.float32)
        e.copy_(torch.where(cut.reshape(shape), 0.0, x))
        return table + alpha * num / cnt.clamp(min=1.0)

    times["trace_pass"] = []
    for name in runs:
        table, e, args = kept[name]
        n_cells = table.numel()
        e_kernel, e_plain, e_dense = e.clone(), e.clone(), e.clone()  # each timed call decays its copy once more

        def make_plan(table=table, args=args):
            return trace_kernels.TracePassPlan(table, b, args[1] is not None)

        def call(plan, table=table, e_kernel=e_kernel, args=args):
            return real_pass(table, e_kernel, *args, plan=plan)

        plan = make_plan()
        ms, _ = _cuda_ms(lambda: call(plan), 20)
        graph_ms = _plan_graph_ms(make_plan, call)
        plain_ms, _ = _cuda_ms(lambda: td_lambda.trace_pass_reference(table, e_plain, *args), 3)
        dense_ms, _ = _cuda_ms(lambda: dense_step(table, e_dense, *args), 5)
        t12 = dict(ms=ms, graph_ms=graph_ms, plain_ms=plain_ms, library_ms=None, shape=f"{name}, trace ({b}, {n_cells})",
                   # the trace read and written once; s, a, δ, cut in; the table in and out
                   **bound(2 * b * n_cells * 4 + b * 13 + 2 * n_cells * 4, INSTR_K12_ELEM * b * n_cells))
        print(f"time trace_pass at {t12['shape']}: kernel {ms!r} ms a step through a plan, {graph_ms!r} ms in a CUDA "
              f"graph of ten, plain {plain_ms!r} ms, bound {t12['bound_ms']!r} ms by {t12['bound_by']}, library None ms; "
              f"the dense passes that ran before K12 {dense_ms!r} ms ({smi})")
        times["trace_pass"].append(t12)
        del e_kernel, e_plain, e_dense, plan
    kept.clear()

    # the 4,096-env run of earlier work, now through K12, on the host clock
    small = 4096
    runs["sarsa_lambda"](small)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = runs["sarsa_lambda"](small)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    _same("sarsa_lambda B=4096 twice", first.q, runs["sarsa_lambda"](small).q)
    print(f"sarsa_lambda walls16 B={small} T={steps}, trace ({small}, 256, 4): {ms!r} ms a call on the host clock, "
          f"{small * steps / ms * 1e3!r} transitions/s; two runs give the same bits ({smi})")
    return launches, errs, times


def ceiling_phases(gt, dev, bound, smi):
    """Phase 23: K9b above 256 threads a cell, where its backward cuts the
    channels into slices (C = 257 and 1,032 in both dtypes, and C = 514 over
    a shared level; above 1,024 channels the forward stages k a slice at a
    time), and K12 at 16,776,961 envs, above 65,535 chunks of 256. Each call
    goes through the public entry (autograd for K9b) and is held against
    its plain version bit for bit (K12 in one launch of 65,536 blocks), and
    timed beside its bound by bytes.
    Returns the max abs errors by kernel."""
    from griduniverse_tpu_torch import kernels
    from griduniverse_tpu_torch.algos import td_lambda
    from griduniverse_tpu_torch.kernels import agent_stamp as k9b
    from griduniverse_tpu_torch.kernels import trace_pass as trace_kernels
    from griduniverse_tpu_torch.models import networks

    errs = {"agent_stamp": 0.0, "trace_pass": 0.0}
    gen = torch.Generator(device=dev).manual_seed(23)
    h = w = 9
    for ch, nl, t in ((257, 64, 16), (1032, 64, 16), (514, 1, 100)):
        for cdt in (torch.float32, torch.bfloat16):
            n = nl * t
            y = torch.randn((nl, h, w, ch), generator=gen, device=dev).to(cdt).requires_grad_(True)
            k = torch.randn((3, 3, ch), generator=gen, device=dev, requires_grad=True)
            b = torch.randn((ch,), generator=gen, device=dev, requires_grad=True)
            obs = torch.randint(0, h * w, (n,), generator=gen, device=dev, dtype=torch.int32)
            cot = torch.randn((n, h, w, ch), generator=gen, device=dev).to(cdt)
            p = k9b.plan(n, nl, h, w, ch, cdt)
            before = kernels.LAUNCHES["agent_stamp"]
            out = networks.agent_stamp(y, k, b, obs)
            grads = torch.autograd.grad(out, (y, k, b), cot)
            _require(kernels.LAUNCHES["agent_stamp"] - before == 1 + k9b.backward_launches(),
                     f"K9b C={ch}: {kernels.LAUNCHES['agent_stamp'] - before} launches")
            tag = f"K9b C={ch} Nl={nl} T={t} {str(cdt).split('.')[-1]}"
            err = _same_fields(f"{tag} forward", (out,), (networks.agent_stamp_reference(y, k, b, obs),), ("out",))
            err = max(err, _same_fields(f"{tag} backward", grads,
                                        networks.agent_stamp_backward_reference(cot, out.detach(), obs, nl),
                                        ("dy_tiles", "dk", "dbias")))
            errs["agent_stamp"] = max(errs["agent_stamp"], err)
            out = out.detach()
            fwd_ms, _ = _cuda_ms(lambda: k9b.agent_stamp_cuda(y.detach(), k.detach(), b.detach(), obs), 10)
            bwd_ms, _ = _cuda_ms(lambda: k9b.agent_stamp_backward_cuda(cot, out, obs, nl), 10)
            size = out.element_size()
            # forward: the tile responses in, the output out; backward: the
            # gradient and the output in, dy_tiles out
            fwd = bound((n + nl) * h * w * ch * size, INSTR_K9B_FWD * n * h * w * ch)
            bwd = bound((2 * n + nl) * h * w * ch * size, INSTR_K9B_BWD * n * h * w * ch)
            print(f"{tag}: {p.slices} slices of {p.width} channels in the backward, "
                  f"{-(-ch // k9b.FORWARD_SLICE)} in the forward; forward and backward bit-exact vs plain; "
                  f"forward {fwd_ms!r} ms (bound {fwd['bound_ms']!r} by {fwd['bound_by']}), backward {bwd_ms!r} ms "
                  f"(bound {bwd['bound_ms']!r} by {bwd['bound_by']}) ({smi})")
    b, cells = 16_776_961, (1, 2)
    e = torch.rand((b, *cells), generator=gen, device=dev) * (torch.rand((b, *cells), generator=gen, device=dev) < 0.3)
    s = torch.zeros((b,), dtype=torch.int32, device=dev)
    a = torch.randint(0, 2, (b,), generator=gen, device=dev, dtype=torch.int32)
    delta = torch.randn((b,), generator=gen, device=dev)
    cut = torch.rand((b,), generator=gen, device=dev) < 0.2
    table = torch.randn(cells, generator=gen, device=dev)
    e_plain = e.clone()
    args = (s, a, delta, cut, 0.9, 0.8, 1e-4, 0.3, "accumulating")
    before = kernels.LAUNCHES["trace_pass"]
    got = td_lambda.trace_pass(table, e, *args)
    _require(kernels.LAUNCHES["trace_pass"] - before == trace_kernels.launches(b) == 1,
             "K12 above 65,535 chunks: not one launch")
    want = td_lambda.trace_pass_reference(table, e_plain, *args)
    errs["trace_pass"] = _same_fields(f"K12 B={b}", (got, e), (want, e_plain), ("table", "trace"))
    ms12, _ = _cuda_ms(lambda: td_lambda.trace_pass(table, e, *args), 10)
    t12 = bound(2 * e.numel() * 4, INSTR_K12_ELEM * e.numel())  # the trace read and written once
    print(f"K12 B={b} ({-(-b // 256)} chunks of 256 envs), a 1x2 table: table and trace bit-exact vs plain; "
          f"{ms12!r} ms a step, bound {t12['bound_ms']!r} ms by {t12['bound_by']} ({smi})")
    return errs


# nine actions: the eight king moves and a stay; 25: every move of at most
# two rows and two columns
KING_AND_STAY = ((-1, 0), (0, 1), (1, 0), (0, -1), (-1, -1), (-1, 1), (1, 1), (1, -1), (0, 0))
FIVE_BY_FIVE = tuple((dr, dc) for dr in range(-2, 3) for dc in range(-2, 3))
# phase 24's shapes: (cells, B) of the mazes held against the plain versions,
# of those only timed, and K2's batches (walls16, per-env mazes, walls16 wide)
HELD_MAZES = (((100, 100), 4),)
TIMED_MAZES = (((300, 300), 8), ((700, 700), 2))
K2_BATCHES = (4096, 4096, 65_536)


def repair_phases(gt, dev, bound, smi, bl_walls):
    """Phase 24: mazes above 63×63 cells, more than eight actions, and K2's shapes.

    (a) K11 through `generate_mazes_device` and K3 (injected and seeded,
    capped at 5,000 steps, short of cover) on mazes above 63×63 cells:
    100×100 × 4 (32 mazes a block), and 20×70 × 3 in the device-memory tier
    (forced by lowering `plan`'s shared limit), each against its plain
    version; K11 at 300×300 × 8 (four mazes a block) and 700×700 × 2 (the
    device tier unforced: one tree does not fit a block) timed, the first
    300×300 maze checked perfect and every maze's open tiles counted (the
    plain walk of 980,000 iterations is out of reach). (b) Every step kernel at nine actions through its
    public entry, and K2 at 25, against the plain versions. (a) and (b) are
    one path, driven with the launch counts set to 0 just before it and read
    just after: every kernel of it must have launched. (c) K2 at its four
    shapes as timed and in a CUDA graph of ten. Returns the max abs errors
    by kernel."""
    from griduniverse_tpu_torch import kernels
    from griduniverse_tpu_torch.algos import dp_batched, td_batched, td_fast
    from griduniverse_tpu_torch.core import semantics as S
    from griduniverse_tpu_torch.core.semantics import SemanticsConfig
    from griduniverse_tpu_torch.kernels import maze as km
    from griduniverse_tpu_torch.levels import maze as M
    from griduniverse_tpu_torch.models import a2c, dqn
    from griduniverse_tpu_torch.ops import bitplane as bp
    from griduniverse_tpu_torch.tools.profile_kernels import _graph_ms

    names = ("backtracker_mazes", "aldous_broder_mazes", "random_scan_bits", "rollout_actions_bits", "dp_grid",
             "td_scan_fast", "td_batched", "act_step", "dqn_act")
    errs = dict.fromkeys(names, 0.0)
    gen = torch.Generator(device=dev).manual_seed(24)
    torch.cuda.synchronize()
    kernels.reset_launches()

    # (a) mazes above 63x63 cells
    def held_mazes(tag, cells, b):
        got, _ = M.generate_mazes_device(24, cells, b, "backtracker")
        ref = M.backtracker_mazes_reference(cells, b, seed=24, device=dev)
        errs["backtracker_mazes"] = max(errs["backtracker_mazes"], _same(f"K11 {tag}", got, ref))
        cap = min(2 * cells[0] * cells[1] + 3, 5_000)
        dirs = torch.randint(0, 4, (cap, b), generator=gen, device=dev, dtype=torch.int8)
        ab = M._aldous_broder_mazes(cells, b, cap, directions=dirs)
        ref = M.aldous_broder_mazes_reference(cells, b, cap, directions=dirs)
        errs["aldous_broder_mazes"] = max(errs["aldous_broder_mazes"], _same(f"K3 injected {tag}", ab, ref))
        seeded = M._aldous_broder_mazes(cells, b, cap, seed=24, device=dev)
        ref = M.aldous_broder_mazes_reference(cells, b, cap, seed=24, device=dev)
        errs["aldous_broder_mazes"] = max(errs["aldous_broder_mazes"], _same(f"K3 seeded {tag}", seeded, ref))
        _require(all(M.check_perfect_maze(g, cells) for g in torch.cat([got[:2], ab[:2], seeded[:2]]).cpu().numpy()),
                 f"{tag}: a maze is not perfect")
        print(f"K11, K3 injected and seeded (capped at {cap} steps) {tag}, plan {km.plan(cells, b)}: bit-exact vs plain")

    for cells, b in HELD_MAZES:
        held_mazes(f"cells={cells} B={b}", cells, b)
    with mock.patch.object(km, "SHARED_LIMIT", 256 + km.STATIC_SHARED):
        held_mazes("cells=(20, 70) B=3 in the device tier (forced)", (20, 70), 3)
    for cells, b in TIMED_MAZES:
        p = km.plan(cells, b)
        ms, got = _cuda_ms(lambda: M.generate_mazes_device(25, cells, b, "backtracker")[0], 2)
        iters = 2 * cells[0] * cells[1] - 1
        _require(bool(((got != S.WALL).sum(dim=(1, 2)) == iters).all()), f"K11 {cells}: a maze has the wrong open tiles")
        if cells[0] * cells[1] <= 100_000:
            _require(M.check_perfect_maze(got[0], cells), f"K11 {cells}: not perfect")
        print(f"K11 cells={cells} B={b}, plan {p}: {ms!r} ms a call as timed, {ms * 1e-3 * bound.clock_hz / iters!r} "
              f"cycles an iteration at {bound.clock_hz / 1e6!r} MHz; every maze has {iters} open tiles ({smi})")
        del got

    # (b) nine actions (and 25 for K2) through each public entry
    sem9 = gt.make_semantics(SemanticsConfig(action_deltas=KING_AND_STAY))
    sem25 = gt.make_semantics(SemanticsConfig(action_deltas=FIVE_BY_FIVE))
    b = 1024
    st = bp.reset_bits(bl_walls, b)
    for sem_a in (sem9, sem25):
        a = sem_a.num_actions
        actions = torch.randint(-1, a + 1, (200, b), generator=gen, device=dev, dtype=torch.int32)
        for mode in ((False, None), (True, None), (True, 64)):
            got = bp.rollout_actions_bits(sem_a, bl_walls, st, actions, *mode)
            ref = bp.rollout_actions_bits_reference(sem_a, bl_walls, st, actions, *mode)
            for f in _STATE_FIELDS:
                _same(f"K2 A={a} {mode} {f}", getattr(got[0], f), getattr(ref[0], f))
            for k, (x, y) in enumerate(zip(got[1], ref[1])):
                errs["rollout_actions_bits"] = max(errs["rollout_actions_bits"], _same(f"K2 A={a} {mode} out{k}", x, y))
    rs = bp.xorshift_init(24, (b,), device=dev)
    errs["random_scan_bits"] = _same_scan("K1 A=9", bp.random_scan_bits(sem9, bl_walls, st, rs, None, 300, 64),
                                          bp.random_scan_bits_reference(sem9, bl_walls, st, rs, 300, 64))
    grids, start = M.generate_mazes_device(24, (4, 4), 256, "aldous_broder")
    levels = gt.Level(grid=grids, start_idx=start.expand(256).contiguous())
    got = dp_batched.value_iteration_batched_grid(sem9, levels)
    ref = dp_batched.value_iteration_batched_grid_reference(sem9, levels)
    _require(got[2] == ref[2], f"K4 A=9: {got[2]} sweeps against {ref[2]}")
    errs["dp_grid"] = _same_fields("K4 VI A=9", got[:2], ref[:2], ("v", "policy"))
    ts = td_fast.fast_td_init(sem9, bl_walls, 24, b)
    kw = dict(alpha=0.2, gamma=0.99, epsilon=0.2, algo="expected_sarsa", max_episode_steps=64)
    errs["td_scan_fast"] = _same_fields("K5 A=9", _fast_fields(td_fast.td_scan_fast(sem9, bl_walls, ts, 100, **kw)),
                                        _fast_fields(td_fast.td_scan_fast_reference(sem9, bl_walls, ts, 100, **kw)),
                                        _FAST_FIELDS)
    grids, start = M.generate_mazes_device(25, (3, 3), 256, "aldous_broder")
    levels = gt.Level(grid=grids, start_idx=start.expand(256).contiguous())
    kw = dict(alpha=0.2, epsilon=0.2, algo="sarsa", max_episode_steps=40)
    errs["td_batched"] = _same_fields(
        "K6 A=9", _batched_fields(td_batched.q_learning_batched(sem9, levels, 7, 100, **kw)),
        _batched_fields(td_batched.q_learning_batched_reference(sem9, levels, 7, 100, **kw)), _BATCHED_FIELDS)
    got_st = ref_st = st
    for t in range(8):
        logits = 2 * torch.randn((b, 9), generator=gen, device=dev)
        gumbel = a2c.draw_gumbel(gen, (b, 9), dev)
        got_st, action, logp, obs, reward, done = a2c.act_step(sem9, bl_walls, got_st, logits, gumbel, 64)
        ref_st, r_action, r_logp, r_obs, r_reward, r_done = a2c.act_step_reference(sem9, bl_walls, ref_st, logits,
                                                                                   gumbel, 64)
        err = _same_fields(f"K7b A=9 step {t}", (action, obs, reward, done, got_st.agent_idx, got_st.t),
                           (r_action, r_obs, r_reward, r_done, ref_st.agent_idx, ref_st.t),
                           ("action", "obs", "reward", "done", "agent_idx", "t"))
        errs["act_step"] = max(errs["act_step"], err, _logp_err(f"K7b A=9 step {t}", logp, r_logp))
    dst = ref_dst = st
    stats = ref_stats = (torch.zeros(b, device=dev), torch.zeros((), dtype=torch.int64, device=dev),
                         torch.zeros((), device=dev))
    for t in range(10):
        q = torch.randint(-2, 3, (b, 9), generator=gen, device=dev).float() * 0.5
        explore = torch.rand(b, generator=gen, device=dev) < 0.3
        rand_a = torch.randint(0, 9, (b,), generator=gen, device=dev, dtype=torch.int32)
        dst, *out, r1, r2, r3 = dqn.dqn_act_step(sem9, bl_walls, dst, q, explore, rand_a, *stats, 64)
        stats = (r1, r2, r3)
        ref_dst, *ref_out, s1, s2, s3 = dqn.dqn_act_step_reference(sem9, bl_walls, ref_dst, q, explore, rand_a,
                                                                   *ref_stats, 64)
        ref_stats = (s1, s2, s3)
        err = _same_fields(f"K7c A=9 step {t}", (*out, *stats, dst.agent_idx),
                           (*ref_out, *ref_stats, ref_dst.agent_idx), [f"out{k}" for k in range(len(out) + 4)])
        errs["dqn_act"] = max(errs["dqn_act"], err)
    torch.cuda.synchronize()
    launches = {name: kernels.LAUNCHES[name] for name in names}
    print(f"phase 24 launches (mazes above 63x63, nine actions): {launches}")
    _require(all(launches.values()), f"phase 24: a kernel of the path never launched: {launches}")
    print("K1, K2 (and at 25 actions), K4, K5, K6, K7b (logp within 2 ulp), K7c at nine actions: bit-exact vs plain")

    # (c) K2's new design at its four shapes
    b_walls, b_mazes, b_wide = K2_BATCHES
    mazes4k = bp.pack_level(_aldous_level(gt, M, dev, 11, b_mazes))
    golden = ROOT / "tests" / "golden"
    cfg4 = np.load(golden / "torch" / "cfg4_mazes_grids.npz")
    shapes = ((f"walls16 B={b_walls} T=512", bl_walls, b_walls, None),
              (f"{b_mazes} per-env 4x4 mazes T=512", mazes4k, b_mazes, None),
              (f"walls16 B={b_wide} T=512", bl_walls, b_wide, None),
              ("golden cfg4_mazes B=4", bp.pack_level(gt.make_level(cfg4["grids"], cfg4["start_idx"], device=dev)), 4,
               torch.as_tensor(np.load(golden / "cfg4_mazes.npz")["actions"], device=dev)))
    sem4 = gt.make_semantics()
    for name, bl, b, actions in shapes:
        if actions is None:
            actions = torch.randint(0, 4, (512, b), generator=gen, device=dev, dtype=torch.int32)
        st = bp.reset_bits(bl, None if bl.batched else b)

        def call(bl=bl, st=st, actions=actions):
            return bp.rollout_actions_bits(sem4, bl, st, actions, True, 64)

        ms, _ = _cuda_ms(call, 30)
        graph_ms = _graph_ms(call)
        n_steps = actions.shape[0]
        t2 = bound(b * n_steps * 13 + b * 8 * 4, 0)
        print(f"K2 {name}: {ms!r} ms a call as timed, {graph_ms!r} ms in a CUDA graph of ten; bound "
              f"{t2['bound_ms']!r} ms by bytes; {graph_ms * 1e-3 * bound.clock_hz / n_steps!r} cycles a step at "
              f"{bound.clock_hz / 1e6!r} MHz in the graph ({smi})")
    return errs


# phase 25's shapes: the vector env's batch and steps, and the single env's walk
COMPAT_ENVS = 65_536
COMPAT_STEPS = 1_000
COMPAT_TIMED_STEPS = 200  # the vector env's steps timed alone after the held run
WALK_STEPS = 2_000


def compat_phases(gt, dev, bound, smi, bl_walls):
    """Phase 25: the compat API (on K2) and K1's threefry stream at full width.

    Driven with the launch counts set to 0 just before and read just after:
    (a) `VectorGridEnv` over walls16 at 65,536 envs and over 65,536 per-env
    K3 9×9 mazes, 1,000 steps with max_episode_steps 512, actions from a
    seeded `torch.Generator`, every step's four arrays bit for bit equal to
    the same class run on the CPU with the same actions; both flag kinds
    seen; then 200 steps timed alone. (b) `GridUniverseEnv(backend="torch")` on example 01's 6×6 level
    and on a 33×33 random maze: a 2,000-step random walk (reset on done)
    bit for bit equal to `backend="numpy"`. (c) `rollout_random_bits(
    rng="threefry")` and `compile_rollout_random(rng="threefry")` at walls16,
    B=65,536, T=1,000. K2 must have launched exactly once a step of (a) and
    (b), K1 once a call of (c). Then K1's threefry form against its plain
    version (final state and per-env accumulators), two chunks of 500
    against one run of 1,000, and its time as timed and in a CUDA graph of
    ten beside the xorshift form's; and K2 at T = 1 (the compat step) at
    B = 1 and 65,536: as timed, in a graph, on the host. Returns the max
    abs errors and the timed records, each with its own launches and error."""
    from griduniverse_tpu_torch import kernels
    from griduniverse_tpu_torch.compat import GridUniverseEnv, VectorGridEnv
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.levels import maze as M
    from griduniverse_tpu_torch.ops import bitplane as bp
    from griduniverse_tpu_torch.tools.profile_kernels import _graph_ms, _host_us

    sem = gt.make_semantics(device=dev)
    b, steps, mes = COMPAT_ENVS, COMPAT_STEPS, MAX_EPISODE_STEPS
    mazes = _aldous_level(gt, M, dev, 25, b)
    errs = {"random_scan_bits": 0.0, "rollout_actions_bits": 0.0}
    torch.cuda.synchronize()
    kernels.reset_launches()

    # (a) the vector env, held step by step against its CPU run
    gen = torch.Generator().manual_seed(25)
    for name, level, kw in (("walls16", builders.walls_and_goal_16x16(device=dev), dict(num_envs=b)),
                            ("mazes", mazes, {})):
        card = VectorGridEnv(level, max_episode_steps=mes, device=dev, **kw)
        host = VectorGridEnv(level.to("cpu"), max_episode_steps=mes, device="cpu", **kw)
        _require(np.array_equal(card.reset(), host.reset()), f"VectorGridEnv {name}: reset differs")
        flags = np.zeros(2, np.int64)
        for t in range(steps):
            actions = torch.randint(0, 4, (b,), generator=gen, dtype=torch.int32).numpy()
            got = card.step(actions)
            for k, (x, y) in enumerate(zip(got, host.step(actions))):
                if x.dtype == np.float32:
                    x, y = x.view(np.int32), y.view(np.int32)
                _require(x.dtype == y.dtype and np.array_equal(x, y), f"VectorGridEnv {name} step {t}: array {k} differs")
            flags += (int(got[2].sum()), int(got[3].sum()))
        _require(flags.all(), f"VectorGridEnv {name}: terminated and truncated not both seen {flags}")
        # timed apart from the CPU twin, whose threads share the host
        timed = torch.randint(0, 4, (COMPAT_TIMED_STEPS, b), generator=gen, dtype=torch.int32).numpy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for actions in timed:
            card.step(actions)
        us = (time.perf_counter() - t0) / len(timed) * 1e6
        print(f"VectorGridEnv {name} B={b}: {steps} steps bit-exact vs its CPU run; terminated {flags[0]}, "
              f"truncated {flags[1]}; then {len(timed)} steps alone: {b / us * 1e6!r} env steps/s, "
              f"{us!r} host µs a step (the four arrays copied back included) ({smi})")

    # (b) the single env, torch backend against the numpy backend
    for name, form in (("example01 6x6", dict(grid_shape=(6, 6), walls=[7, 8, 13], lava=[21], goal_states=[35])),
                       ("maze 33x33", dict(random_maze=True, grid_shape=(33, 33), max_steps=400))):
        card = GridUniverseEnv(backend="torch", device=dev, seed=25, **form)
        host = GridUniverseEnv(backend="numpy", seed=25, **form)
        _require(card.reset() == host.reset(), f"GridUniverseEnv {name}: reset differs")
        episodes, wall = 0, 0.0
        for t in range(WALK_STEPS):
            a = card.action_space.sample()
            _require(a == host.action_space.sample(), f"GridUniverseEnv {name}: samples differ")
            t0 = time.perf_counter()
            got = card.step(a)
            wall += time.perf_counter() - t0  # the oracle's host step is outside the window
            _require(got == host.step(a), f"GridUniverseEnv {name} step {t}: {got} differs")
            if got[2]:
                episodes += 1
                _require(card.reset() == host.reset(), f"GridUniverseEnv {name}: reset differs")
        _require(card.current_state == host.current_state and card.render("ansi") == host.render("ansi"),
                 f"GridUniverseEnv {name}: final state differs")
        print(f"GridUniverseEnv(backend='torch') {name}: {WALK_STEPS} steps bit-exact vs backend='numpy', "
              f"{episodes} episodes; {wall / WALK_STEPS * 1e6!r} host µs a step ({smi})")
    # the single env above 16,384 states (a 131x131 maze, 17,161): `core.step` on the card, no K2 launch
    form = dict(random_maze=True, grid_shape=(131, 131), max_steps=150)
    card = GridUniverseEnv(backend="torch", device=dev, seed=26, **form)
    host = GridUniverseEnv(backend="numpy", seed=26, **form)
    before = kernels.LAUNCHES["rollout_actions_bits"]
    _require(card.level.device == dev and card.reset() == host.reset(), "GridUniverseEnv 131x131: reset differs")
    ends, t0 = 0, time.perf_counter()
    for t in range(500):
        a = card.action_space.sample()
        _require(a == host.action_space.sample(), "GridUniverseEnv 131x131: samples differ")
        got = card.step(a)
        _require(got == host.step(a), f"GridUniverseEnv 131x131 step {t}: {got} differs")
        if got[2]:
            ends += 1
            _require(card.reset() == host.reset(), "GridUniverseEnv 131x131: reset differs")
    wall = (time.perf_counter() - t0) / 500
    _require(ends > 0 and kernels.LAUNCHES["rollout_actions_bits"] == before,
             f"GridUniverseEnv 131x131: {ends} episode ends, K2 launched {kernels.LAUNCHES['rollout_actions_bits'] - before}")
    print(f"GridUniverseEnv(backend='torch') maze 131x131 ({card.num_states} states, core.step on the card): 500 "
          f"steps bit-exact vs backend='numpy', {ends} episode ends, no K2 launch; {wall * 1e6!r} host µs a step, "
          f"the oracle's included ({smi})")

    # (c) the threefry rollouts
    _, stats = bp.rollout_random_bits(sem, bl_walls, 25, b, steps, mes, rng="threefry")
    fn = bp.compile_rollout_random(sem, bl_walls, b, steps, mes, rng="threefry")
    _, stats_c = fn(25)
    torch.cuda.synchronize()
    launches = {name: kernels.LAUNCHES[name] for name in ("random_scan_bits", "rollout_actions_bits")}
    print(f"phase 25 launches (vector env, single env, threefry rollouts): {launches}")
    want = {"random_scan_bits": 2, "rollout_actions_bits": 2 * (steps + COMPAT_TIMED_STEPS) + 2 * WALK_STEPS}
    _require(launches == want, f"phase 25: launches {launches}, expected {want}")
    for k in stats:
        _same(f"K1 threefry compile_rollout_random {k}", stats_c[k], stats[k])
    eps, length = int(stats["episodes"]), float(stats["mean_length"])
    _require(eps > 0 and 1.0 <= length <= mes, f"K1 threefry: implausible stats {stats}")

    # K1's threefry form against its plain version, in chunks, and timed
    st = bp.reset_bits(bl_walls, b)
    keys = bp.threefry_keys(25)
    got = bp.random_scan_bits(sem, bl_walls, st, None, keys, steps, mes, "threefry")
    t0 = time.perf_counter()
    ref = bp.random_scan_bits_reference(sem, bl_walls, st, None, steps, mes, "threefry", keys)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    errs["random_scan_bits"] = _same_scan("K1 threefry", got, ref)
    _same("K1 threefry episodes vs rollout_random_bits", got[1].sum(), stats["episodes"])
    half = steps // 2
    first = bp.random_scan_bits(sem, bl_walls, st, None, keys, half, mes, "threefry")
    second = bp.random_scan_bits(sem, bl_walls, first[0], None, bp.threefry_keys(25, step=half), steps - half, mes,
                                 "threefry")
    for f in _STATE_FIELDS:
        _same(f"K1 threefry chunks {f}", getattr(second[0], f), getattr(got[0], f))
    for k, name in ((1, "n_eps"), (3, "len_sum")):
        _same(f"K1 threefry chunks {name}", first[k] + second[k], got[k])
    print(f"K1 threefry walls16 B={b} T={steps}: final state and per-env accumulators bit-exact vs plain; "
          f"two chunks of {half} equal one run; episodes {eps}, mean_length {length!r}")
    rs = bp.xorshift_init(25, (b,), device=dev)

    def threefry():
        return bp.random_scan_bits(sem, bl_walls, st, None, keys, steps, mes, "threefry")

    def xorshift():
        return bp.random_scan_bits(sem, bl_walls, st, rs, None, steps, mes)

    ms, _ = _cuda_ms(threefry, 5)
    xs_ms, _ = _cuda_ms(xorshift, 5)
    graph_ms, xs_graph_ms = _graph_ms(threefry), _graph_ms(xorshift)
    t1 = dict(ms=ms, plain_ms=plain_ms, graph_ms=graph_ms, shape=f"threefry walls16 B={b} T={steps} max_ep={mes}",
              library_ms=None, launches=launches["random_scan_bits"], max_abs_err=errs["random_scan_bits"],
              # state in (3 words) and state + accumulators out (7 words) per env
              **bound(b * 10 * 4, k1_threefry_function_ops(b, steps, 4)))
    sass = bound(b * 10 * 4, INSTR_K1_THREEFRY_STEP * b * steps)
    print(f"K1 walls16 B={b} T={steps}: threefry {ms!r} ms as timed, {graph_ms!r} ms in a CUDA graph of ten; "
          f"xorshift {xs_ms!r} ms as timed, {xs_graph_ms!r} in a graph; threefry / xorshift in the graph "
          f"{graph_ms / xs_graph_ms!r}; bound {t1['bound_ms']!r} ms by {t1['bound_by']} (the function's "
          f"{k1_step_ops(4) - XORSHIFT_ROUND + THREEFRY_BLOCK / 2!r} operations a step), {sass['bound_ms']!r} by the "
          f"kernel's {INSTR_K1_THREEFRY_STEP} SASS instructions a step; {t1['bound_ms'] / graph_ms!r} of the bound "
          f"reached in the graph ({smi})")

    # K2 at T = 1, the compat step's shape
    times = {"random_scan_bits": [t1], "rollout_actions_bits": []}
    gen = torch.Generator(device=dev).manual_seed(25)
    for n in (1, b):
        st = bp.reset_bits(bl_walls, n)
        actions = torch.randint(0, 4, (1, n), generator=gen, device=dev, dtype=torch.int32)

        def call(st=st, actions=actions):
            return bp.rollout_actions_bits(sem, bl_walls, st, actions, True, mes)

        ms, got = _cuda_ms(call, 50)
        plain_ms, ref = _cuda_ms(lambda: bp.rollout_actions_bits_reference(sem, bl_walls, st, actions, True, mes), 5)
        err = max(_same(f"K2 T=1 B={n} out{k}", x, y) for k, (x, y) in enumerate(zip(got[1], ref[1])))
        for f in _STATE_FIELDS:
            _same(f"K2 T=1 B={n} {f}", getattr(got[0], f), getattr(ref[0], f))
        errs["rollout_actions_bits"] = max(errs["rollout_actions_bits"], err)
        graph_ms, host_us = _graph_ms(call), _host_us(call)
        t2 = dict(ms=ms, plain_ms=plain_ms, graph_ms=graph_ms, host_us=host_us,
                  shape=f"T=1 (the compat step) walls16 B={n} auto-reset max_ep={mes}", library_ms=None,
                  launches=launches["rollout_actions_bits"], max_abs_err=err,
                  **bound(n * 13 + n * 8 * 4, INSTR_K2_STEP * n))
        times["rollout_actions_bits"].append(t2)
        print(f"K2 at T=1 B={n}: {ms!r} ms a call as timed, {graph_ms * 1e3!r} device µs in a CUDA graph of ten, "
              f"{host_us!r} host µs a call (the wrapper's checks and seven allocations); bound {t2['bound_ms']!r} "
              f"ms by {t2['bound_by']} ({smi})")
    return errs, times


# -- phase 26: the sharded runs (`parallel/`) -----------------------------------

SHARD_B = 65_536
# steps of each sharded path: over NCCL in a world of one (a), and over Gloo
# with two ranks sharing the card (b), where every step's collective goes
# through the host
SHARD_STEPS = {
    "nccl": dict(roll=1_000, fast=2_000, fast65=300, batched=2_000, td=200),
    "gloo": dict(roll=200, fast=200, fast65=60, batched=200, td=20),
}
SHARD_KW5 = dict(alpha=0.1, gamma=0.99, epsilon=0.1, algo="q_learning", max_episode_steps=MAX_EPISODE_STEPS)
GLOO_RANKS, GLOO_TIMEOUT_S = 2, 600


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _shard_levels(gt, dev) -> dict:
    """The sharded paths' inputs, built alike in every process: walls16,
    one 65x65 backtracker maze (16,900 Q entries), 65,536 and 4,096 9x9 and
    8,192 33x33 Aldous-Broder mazes."""
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.levels import maze as M
    from griduniverse_tpu_torch.ops import bitplane as bp

    walls16 = builders.walls_and_goal_16x16(device=dev)
    g65, s65 = M.generate_mazes_device(6, (32, 32), 1, device=dev)
    return dict(
        sem=gt.make_semantics(device=dev), walls16=walls16, bl_walls=bp.pack_level(walls16),
        bl65=bp.pack_level(gt.Level(grid=g65[0].contiguous(), start_idx=s65)),
        vi64=_aldous_level(gt, M, dev, 2026, SHARD_B), vi33=_aldous_level(gt, M, dev, 33, 8_192, (16, 16)),
        pi4k=_aldous_level(gt, M, dev, 44, 4_096), q64=_aldous_level(gt, M, dev, 2027, SHARD_B),
    )


def _sharded_calls(m, L, st) -> dict:
    """Every sharded entry of the slice on mesh `m` at the step counts `st`,
    each a call of no arguments through the entry a user calls (and, for
    the shared-Q learner, the scan it runs, to read the env state)."""
    from griduniverse_tpu_torch import parallel
    from griduniverse_tpu_torch.algos import td_fast
    from griduniverse_tpu_torch.parallel import bitplane as pbit
    from griduniverse_tpu_torch.parallel import mesh as pm

    sem, b = L["sem"], SHARD_B
    kw = dict(SHARD_KW5)
    algo = kw.pop("algo")

    def fast_state(bl, steps):
        ts = pbit.fast_td_init_sharded(m, sem, bl, 3, b)
        return td_fast.td_scan_fast_sharded(sem, pbit.local_bitlevel(m, bl, b), ts, steps, kw["alpha"], kw["gamma"],
                                            kw["epsilon"], algo, kw["max_episode_steps"],
                                            lambda x: pm.all_reduce_sum(m, x))

    return {
        "rollout": lambda: parallel.compile_rollout_random_sharded(
            m, sem, L["bl_walls"], b, st["roll"], MAX_EPISODE_STEPS)(7),
        "fast": lambda: parallel.compile_q_learning_fast_sharded(m, sem, L["bl_walls"], b, st["fast"], **SHARD_KW5)(3),
        "fast_state": lambda: fast_state(L["bl_walls"], st["fast"]),
        "fast65": lambda: parallel.compile_q_learning_fast_sharded(m, sem, L["bl65"], b, st["fast65"], **SHARD_KW5)(3),
        "fast65_state": lambda: fast_state(L["bl65"], st["fast65"]),
        "vi64": lambda: parallel.value_iteration_batched_grid_sharded(m, sem, L["vi64"]),
        "vi33": lambda: parallel.value_iteration_batched_grid_sharded(m, sem, L["vi33"]),
        "pi4k": lambda: parallel.policy_iteration_batched_grid_sharded(m, sem, L["pi4k"]),
        "batched": lambda: parallel.q_learning_batched_sharded(
            m, sem, L["q64"], 5, st["batched"], max_episode_steps=MAX_EPISODE_STEPS),
        "td_parity": lambda: parallel.q_learning_sharded(m, sem, L["walls16"], 11, st["td"], b, parity=True),
        "td_scalable": lambda: parallel.q_learning_sharded(m, sem, L["walls16"], 11, st["td"], b),
    }


def _unsharded_calls(gt, L, st) -> dict:
    """The unsharded port's calls that `_sharded_calls`' entries equal."""
    from griduniverse_tpu_torch import algos
    from griduniverse_tpu_torch.algos import td_batched, td_fast
    from griduniverse_tpu_torch.ops import bitplane as bp

    sem, b = L["sem"], SHARD_B
    kw = dict(SHARD_KW5)
    algo = kw.pop("algo")

    def fast_state(bl, steps):
        return td_fast.td_scan_fast(sem, bl, td_fast.fast_td_init(sem, bl, 3, b), steps, kw["alpha"], kw["gamma"],
                                    kw["epsilon"], algo, kw["max_episode_steps"])

    return {
        "rollout": lambda: bp.compile_rollout_random(sem, L["bl_walls"], b, st["roll"], MAX_EPISODE_STEPS)(7),
        "fast": lambda: algos.compile_q_learning_fast(sem, L["bl_walls"], b, st["fast"], **SHARD_KW5)(3),
        "fast_state": lambda: fast_state(L["bl_walls"], st["fast"]),
        "fast65": lambda: algos.compile_q_learning_fast(sem, L["bl65"], b, st["fast65"], **SHARD_KW5)(3),
        "fast65_state": lambda: fast_state(L["bl65"], st["fast65"]),
        "vi64": lambda: algos.value_iteration_batched_grid(sem, L["vi64"]),
        "vi33": lambda: algos.value_iteration_batched_grid(sem, L["vi33"]),
        "pi4k": lambda: algos.policy_iteration_batched_grid(sem, L["pi4k"]),
        "batched": lambda: td_batched.q_learning_batched(sem, L["q64"], 5, st["batched"],
                                                         max_episode_steps=MAX_EPISODE_STEPS),
        "td_parity": lambda: algos.q_learning(sem, L["walls16"], 11, st["td"], b),
        "td_scalable": lambda: algos.q_learning(sem, L["walls16"], 11, st["td"], b),
    }


def _digest(x) -> str:
    """A tensor's dtype, shape and bytes, hashed: two digests are equal iff
    the tensors are, bit for bit."""
    import hashlib

    x = x.detach().contiguous().cpu()
    body = x.view(torch.int32) if x.dtype == torch.float32 else x
    return f"{x.dtype} {tuple(x.shape)} " + hashlib.sha256(body.numpy().tobytes()).hexdigest()


_ROW_FIELDS = {"rollout": ("agent_idx", "agent_code", "t", "done"),
               "fast_state": ("agent_idx", "agent_code", "t", "rs", "run_ret", "n_eps_env", "ret_sum_env"),
               "batched": ("agent_idx", "agent_code", "t", "a", "rs", "run_ret", "n_eps_env", "ret_sum_env")}
_ROW_FIELDS["fast65_state"] = _ROW_FIELDS["fast_state"]


def _shard_views(name, out):
    """(the entry's replicated values, the entry's env rows by field) of an
    output of `_sharded_calls` or `_unsharded_calls`, for the one named."""
    if name == "rollout":
        state, stats = out
        return ({k: stats[k] for k in ("episodes", "mean_length")},
                {f: getattr(state, f) for f in _ROW_FIELDS[name]})
    if name in ("fast_state", "fast65_state"):
        st = out.env_state
        rows = dict(agent_idx=st.agent_idx, agent_code=st.agent_code, t=st.t, rs=out.rs, run_ret=out.run_ret,
                    n_eps_env=out.n_eps_env, ret_sum_env=out.ret_sum_env)
        return {"q": out.q}, rows
    if name in ("fast", "fast65", "td_parity", "td_scalable"):
        return {"q": out.q, "episodes": out.episodes}, {}
    if name == "batched":
        st = out.state
        rows = dict(agent_idx=st.env_state.agent_idx, agent_code=st.env_state.agent_code, t=st.env_state.t,
                    a=st.a, rs=st.rs, run_ret=st.run_ret, n_eps_env=st.n_eps_env, ret_sum_env=st.ret_sum_env)
        return {"q": out.q, "episodes": out.episodes}, rows
    v, policy, iters = out
    return {"v": v, "policy": policy, "iters": torch.tensor(iters)}, {}


def _shard_digests(outs) -> dict:
    """Every entry's replicated values as digests and its env rows on the
    host: what a rank hands back to be held against the unsharded run."""
    record = {}
    for name, out in outs.items():
        rep, rows = _shard_views(name, out)
        record[name] = ({k: _digest(v) for k, v in rep.items()},
                        {k: v.detach().cpu().clone() for k, v in rows.items()})
    return record


def _gloo_cuda_probe(dev) -> dict:
    """Which collectives Gloo takes on CUDA tensors as they are: each one
    tried once on a CUDA tensor, its error kept where it refuses (where one
    did, `parallel/mesh.py` would have to stage it through the host)."""
    import torch.distributed as dist

    tries = {
        "all_reduce": lambda x: dist.all_reduce(x),
        "all_gather": lambda x: dist.all_gather([torch.empty_like(x) for _ in range(dist.get_world_size())], x),
    }
    found = {}
    for name, op in tries.items():
        x = torch.ones(4, dtype=torch.int64, device=dev)
        try:
            op(x)
            torch.cuda.synchronize()
            found[name] = "takes CUDA tensors"
        except (RuntimeError, ValueError) as err:  # the probe's finding, not a fallback
            found[name] = f"refuses CUDA tensors ({type(err).__name__}: {str(err).splitlines()[0][:160]})"
    return found


def _gloo_rank(rank: int, port: int, out_dir: str, device: str = "cuda:0") -> None:
    """Phase 26 (b), one rank: Gloo over two processes sharing card 0, every
    sharded entry at the Gloo step counts, the digests saved for the parent.
    (`device="cpu"` rehearses it without a card.)"""
    sys.path.insert(0, str(ROOT))
    import griduniverse_tpu_torch as gt
    from griduniverse_tpu_torch import kernels, parallel
    from griduniverse_tpu_torch.parallel import distributed

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
    info = distributed.initialize("gloo", f"tcp://127.0.0.1:{port}", GLOO_RANKS, rank, device=dev, timeout_s=300)
    try:
        name = torch.cuda.get_device_name(dev) if on_card else "the CPU"
        print(f"phase 26 (b) rank {info['rank']}: backend {info['backend']}, world size {info['world_size']}, "
              f"device {info['device']} ({name})", flush=True)
        probe = _gloo_cuda_probe(dev) if on_card else {}
        m = parallel.make_env_mesh(GLOO_RANKS, device=dev)
        L = _shard_levels(gt, dev)
        if on_card:
            torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        outs = {name: call() for name, call in _sharded_calls(m, L, SHARD_STEPS["gloo"]).items()}
        if on_card:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        torch.save({"info": {**info, "device": str(info["device"])}, "probe": probe, "launches": launches,
                    "seconds": seconds, "record": _shard_digests(outs)}, Path(out_dir) / f"rank{rank}.pt")
    finally:
        distributed.shutdown()


def _hold_shards(tag: str, ranks: list, want: dict) -> None:
    """Each rank's digests of the replicated values equal the unsharded
    run's (so they are the same bits on every rank), and the ranks' env rows
    in rank order equal its rows."""
    for name, (rep, rows) in want.items():
        for rank, got in enumerate(ranks):
            for k, d in rep.items():
                _require(got[name][0][k] == d, f"{tag} {name} {k}: rank {rank} differs from the unsharded run")
        for k, whole in rows.items():
            joined = torch.cat([got[name][1][k] for got in ranks])
            _same(f"{tag} {name} {k}", joined, whole.cpu())


def _collectives(fn):
    """(fn's output, the collectives it issued), counted at torch.distributed."""
    import torch.distributed as dist

    counts = {"all_reduce": 0, "all_gather": 0}
    real = {name: getattr(dist, name) for name in counts}

    def counted(name):
        def call(*args, **kw):
            counts[name] += 1
            return real[name](*args, **kw)
        return call

    with contextlib.ExitStack() as stack:
        for name in counts:
            stack.enter_context(mock.patch.object(dist, name, counted(name)))
        out = fn()
    return out, counts


def _nccl_phases(gt, dev, smi, L, info, lap):
    """Phase 26 (a) and (d) in a world of one over NCCL (the group already
    initialised): every entry held bit for bit against the unsharded port,
    its launches counted; then each against its unsharded call. Returns
    ({entry: {turn: (ms, launches, collectives, idle share)}}, the path's
    launches)."""
    from griduniverse_tpu_torch import kernels, parallel
    from griduniverse_tpu_torch.tools.profile_solvers import _wall_ms

    full = SHARD_STEPS["nccl"]
    m = parallel.make_env_mesh(1, device=dev)
    print(f"phase 26 (a): backend {m.backend}, world size {m.size}, device {info['device']} ({smi})")
    calls = _sharded_calls(m, L, full)
    torch.cuda.synchronize()
    kernels.reset_launches()
    outs = {name: call() for name, call in calls.items()}
    torch.cuda.synchronize()
    path = {k: v for k, v in kernels.LAUNCHES.items() if v}
    print(f"launches on the sharded main path (NCCL, world of one): {path}")
    want_steps = 2 * (full["fast"] + 1) + 2 * (full["fast65"] + 1)
    _require(path.get("td_step_sharded") == want_steps,
             f"K5's sharded form: {path.get('td_step_sharded')} launches, expected {want_steps}")
    per_call = k10_launches(SHARD_B, 1024, dev)  # the gathered pairs and a world of one's rows, walls16's table
    _require(path.get("segment_sums") == per_call * full["td"] and path.get("segment_mean") == per_call * full["td"],
             f"K10 and its sums form: {path.get('segment_mean')}, {path.get('segment_sums')} launches, "
             f"expected {per_call} a call")
    for name in ("random_scan_bits", "dp_grid", "td_batched"):
        _require(path.get(name, 0) > 0, f"{name} was not launched on the sharded path")
    unsharded = _unsharded_calls(gt, L, full)
    want = {name: _shard_views(name, unsharded[name]()) for name in outs}
    for name, out in outs.items():
        rep, rows = _shard_views(name, out)
        for k, v in rep.items():
            _same(f"sharded (a) {name} {k}", v.reshape(-1), want[name][0][k].reshape(-1))
        for k, v in rows.items():
            _same(f"sharded (a) {name} {k}", v, want[name][1][k])
        _require(name not in ("rollout", "fast", "batched", "td_parity", "td_scalable") or int(rep["episodes"]) > 0,
                 f"sharded (a) {name}: no episode ended")
    print("phase 26 (a): every sharded entry over NCCL in a world of one equals the unsharded port bit for bit: "
          f"the rollout (B={SHARD_B}, T={full['roll']}: per-env state, episodes, mean length), the shared-Q learner "
          f"(walls16 B={SHARD_B} T={full['fast']}, and the 65x65 maze T={full['fast65']}: Q, env state, lanes, counters "
          f"against the cooperative K5), VI over 65,536 9x9 and 8,192 33x33 mazes and PI over 4,096 (V, policy, "
          f"iterations), the per-maze learner (65,536 x {full['batched']}: tables, state), and q_learning_sharded "
          f"(B={SHARD_B}, T={full['td']}) in parity and scalable modes against td_run ({smi})")

    lap("phase 26 (a)")
    # -- (d) each sharded entry against its unsharded call --------------------
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.zeros(1, device=dev).sum().item()  # the profiler's own start-up
    steps_of = {"rollout": full["roll"], "fast": full["fast"], "fast65": full["fast65"], "batched": full["batched"],
                "td_parity": full["td"], "td_scalable": full["td"]}
    timed = {}
    # in turns, each entry warm from (a): one call on the host clock with its
    # launches and collectives counted, then one under the profiler
    for name in ("rollout", "fast", "fast65", "vi64", "vi33", "pi4k", "batched", "td_parity", "td_scalable"):
        row = {}
        for tag, fn in (("unsharded", unsharded[name]), ("sharded", calls[name])):
            kernels.reset_launches()
            wall, coll = _collectives(lambda: _wall_ms(fn))
            launched = sum(kernels.LAUNCHES.values())
            idle, events = _idle_share(fn, wall)
            row[tag] = (wall, launched, coll, idle)
            steps = steps_of.get(name)
            per_step = "" if steps is None else (f", {sum(coll.values()) / steps!r} collectives a step "
                                                 f"({launched / steps!r} launches a step)")
            share = "not measured (the profiler recorded no device time)" if idle is None else f"{100 * idle:.2f} %"
            print(f"phase 26 (d) {name} {tag}: {wall!r} ms a call on the host clock, {launched} kernel launches, "
                  f"collectives {coll}{per_step}, {events} device events, device idle share {share} ({smi})")
        timed[name] = row
    lap("phase 26 (d)")
    return timed, path


def _idle_share(fn, wall_ms: float):
    """(1 - the device's busy time / `wall_ms`, device events) of one call
    of `fn` under the profiler (device activity only), or (None, 0) where
    it recorded no device time."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(spans)
    return (1 - busy / (wall_ms * 1e3) if busy else None), len(spans)


def sharded_phases(gt, dev, bound, smi):
    """Phase 26: the sharded paths of `parallel/`. (a) A world of one over
    NCCL on the card at full width, its launches counted, every entry held
    bit for bit against the unsharded port; (b) two ranks sharing the card
    over Gloo (spawned processes), held the same way at fewer steps; (c)
    K5's sharded form against its plain version and timed; (d) each sharded
    entry's time, launches, collectives and idle share against its
    unsharded call. Returns (launches, max abs errors, times) by kernel."""
    import torch.multiprocessing as tmp

    from griduniverse_tpu_torch.algos import td_fast
    from griduniverse_tpu_torch.core.semantics import SemanticsConfig
    from griduniverse_tpu_torch.kernels import td_fast as k5
    from griduniverse_tpu_torch.parallel import distributed
    from griduniverse_tpu_torch.tools.profile_turns import _plan_graph_ms

    t_lap = [time.perf_counter()]

    def lap(what: str) -> None:
        now = time.perf_counter()
        print(f"{what}: {now - t_lap[0]:.1f} s")
        t_lap[0] = now

    L = _shard_levels(gt, dev)
    sem = L["sem"]
    full = SHARD_STEPS["nccl"]

    # -- (a) NCCL, a world of one -------------------------------------------------
    info = distributed.initialize("nccl", f"tcp://127.0.0.1:{_free_port()}", 1, 0, device=dev, timeout_s=300)
    try:
        timed, path = _nccl_phases(gt, dev, smi, L, info, lap)
    finally:
        distributed.shutdown()
    # -- (b) Gloo, two ranks sharing the card ---------------------------------------
    torch.cuda.empty_cache()
    gloo = SHARD_STEPS["gloo"]
    with_dir = ROOT / "build" / "smoke_gloo"
    with_dir.mkdir(parents=True, exist_ok=True)
    ctx = tmp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_gloo_rank, args=(r, port, str(with_dir))) for r in range(GLOO_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + GLOO_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    late = [p for p in procs if p.is_alive()]
    for p in late:
        p.kill()
        p.join(10)
    codes = [p.exitcode for p in procs]
    _require(not late and codes == [0] * GLOO_RANKS, f"phase 26 (b): exit codes {codes}, {len(late)} killed")
    ranks = [torch.load(with_dir / f"rank{r}.pt", weights_only=False) for r in range(GLOO_RANKS)]
    for f in with_dir.iterdir():
        f.unlink()
    with_dir.rmdir()
    print(f"phase 26 (b): {GLOO_RANKS} ranks over Gloo on one card in {time.perf_counter() - t0:.1f} s "
          f"(their sharded runs {[round(r['seconds'], 3) for r in ranks]} s); Gloo on CUDA tensors: {ranks[0]['probe']}")
    for r in ranks:
        print(f"phase 26 (b) rank {r['info']['rank']}: backend {r['info']['backend']}, world size "
              f"{r['info']['world_size']}, device {r['info']['device']}; launches {r['launches']}")
        _require(r["launches"].get("td_step_sharded") == 2 * (gloo["fast"] + 1) + 2 * (gloo["fast65"] + 1)
                 and r["launches"].get("segment_sums") == k10_launches(SHARD_B // GLOO_RANKS, 1024, dev) * gloo["td"],
                 f"phase 26 (b) rank {r['info']['rank']}: launches {r['launches']}")
    unsharded_gloo = _unsharded_calls(gt, L, gloo)
    want_gloo = {}
    for name in ranks[0]["record"]:
        rep, rows = _shard_views(name, unsharded_gloo[name]())
        if name == "td_scalable":  # two ranks add their sums in rank order: not td_run's order
            rep = {}
        want_gloo[name] = ({k: _digest(v) for k, v in rep.items()}, rows)
    _hold_shards("phase 26 (b)", [r["record"] for r in ranks], want_gloo)
    scal = [r["record"]["td_scalable"][0] for r in ranks]
    _require(all(s == scal[0] for s in scal), "phase 26 (b) td_scalable: Q differs between the ranks")
    print(f"phase 26 (b): every sharded entry over Gloo with {GLOO_RANKS} ranks on one card, gathered in rank order, "
          f"equals the unsharded port bit for bit (rollout T={gloo['roll']}, shared-Q T={gloo['fast']} and "
          f"{gloo['fast65']} at 65x65, VI, PI, per-maze T={gloo['batched']}, q_learning_sharded parity T={gloo['td']}); "
          f"the scalable mode's Q is the same bits on both ranks ({smi})")
    lap("phase 26 (b)")

    # -- (c) K5's sharded form against its plain version, and timed ------------------
    errs = {"td_step_sharded": 0.0}
    kw = dict(SHARD_KW5)
    algo = kw.pop("algo")

    def identity(agg):
        return agg

    sem9 = gt.make_semantics(SemanticsConfig(action_deltas=KING_AND_STAY), device=dev)
    for tag, sem_c, bl, b, steps in (("walls16", sem, L["bl_walls"], 1, 200), ("walls16", sem, L["bl_walls"], 33, 200),
                                     ("walls16", sem, L["bl_walls"], SHARD_B, 200),
                                     ("walls16 nine actions", sem9, L["bl_walls"], SHARD_B, 100),
                                     ("65x65 (global form)", sem, L["bl65"], SHARD_B, 100)):
        ts = td_fast.fast_td_init(sem_c, bl, 9, b)
        got = td_fast.td_scan_fast_sharded(sem_c, bl, ts, steps, kw["alpha"], kw["gamma"], kw["epsilon"], algo,
                                           kw["max_episode_steps"], identity)
        ref = td_fast.td_scan_fast_sharded_reference(sem_c, bl, ts, steps, kw["alpha"], kw["gamma"], kw["epsilon"],
                                                     algo, kw["max_episode_steps"], identity)
        errs["td_step_sharded"] = max(errs["td_step_sharded"],
                                      _same_fields(f"K5 sharded {tag} B={b}", _fast_fields(got), _fast_fields(ref),
                                                   _FAST_FIELDS))
        coop = td_fast.td_scan_fast(sem_c, bl, ts, steps, kw["alpha"], kw["gamma"], kw["epsilon"], algo,
                                    kw["max_episode_steps"])
        _same_fields(f"K5 sharded {tag} B={b} vs the cooperative K5", _fast_fields(got), _fast_fields(coop),
                     _FAST_FIELDS)
        blocks = k5.step_blocks(b, ts.q.numel(), True)
        print(f"K5's sharded form {tag} B={b} T={steps} ({blocks} blocks, clusters of {k5.step_cluster(blocks, ts.q.numel())}): "
              "Q, env state, lanes, counters bit-exact vs plain and vs the cooperative K5")
    ts = td_fast.fast_td_init(sem, L["bl_walls"], 9, SHARD_B)
    n = ts.q.numel()

    def plan_of(cluster=None):
        state = [x.clone() for x in (ts.env_state.agent_idx, ts.env_state.agent_code, ts.env_state.t, ts.rs,
                                     ts.run_ret, ts.n_eps_env, ts.ret_sum_env)]
        return k5.TdStepPlan(sem, L["bl_walls"], ts.q, state, kw["alpha"], kw["gamma"], kw["epsilon"], 0,
                             kw["max_episode_steps"], cluster=cluster)

    # the plan's clusters against one block a cluster (each block rebuilding all
    # of Q_t and flushing all its counters, as PR 20's kernel did) and against
    # eight: 50 steps each
    runs = {}
    for cluster in (None, 1, 8):
        plan = plan_of(cluster)
        for t in range(50):
            plan.step(t)
        runs[plan.cluster] = (plan.finish(50), *plan.state)
    for cluster, run in runs.items():
        _same_fields(f"K5 sharded clusters of {cluster}", run, runs[1], ("q",) + k5.STATE_FIELDS)
    print(f"K5's sharded form walls16 B=65,536, 50 steps: clusters of {sorted(runs)} blocks give the same bits")
    def stepped_plan(cluster=None):
        plan = plan_of(cluster)
        for t in range(3):
            plan.step(t)
        return plan

    # step 2's launch again and again: the same rows, the same work each time; in
    # a graph, the plan built on the capture's stream (a plan is stream-ordered)
    plans = {cluster: stepped_plan(cluster) for cluster in (None, 1)}
    ms, _ = _cuda_ms(lambda: plans[None].step(2), 200)
    graph_ms = _plan_graph_ms(stepped_plan, lambda plan: plan.step(2))
    ms1, _ = _cuda_ms(lambda: plans[1].step(2), 200)
    graph1 = _plan_graph_ms(lambda: stepped_plan(1), lambda plan: plan.step(2))
    plain_ms, _ = _cuda_ms(lambda: td_fast.td_step_sharded_reference(
        sem, L["bl_walls"], ts.q, plans[None].aggregates[0], ts, kw["alpha"], kw["gamma"], kw["epsilon"], algo,
        kw["max_episode_steps"]), 5)
    # the function's operations (K5's count) and the aggregate's 2·S·A·8 bytes each way
    t5 = dict(ms=ms, graph_ms=graph_ms, plain_ms=plain_ms, library_ms=None,
              shape=f"walls16 B={SHARD_B}, one step through the plan (clusters of {plans[None].cluster})",
              **bound(2 * 2 * n * 8, INSTR_K5_STEP * SHARD_B + INSTR_K5_ENTRY * n))
    print(f"time td_step_sharded at {t5['shape']}: kernel {ms!r} ms as timed, {graph_ms!r} ms in a CUDA graph of ten; "
          f"clusters of one {ms1!r} ms as timed, {graph1!r} ms in a graph; plain {plain_ms!r} ms, bound "
          f"{t5['bound_ms']!r} ms by {t5['bound_by']}, library None ms ({smi})")
    lap("phase 26 (c)")
    for name, row in timed.items():
        u, s_ = row["unsharded"], row["sharded"]
        shares = " / ".join("not measured" if t[3] is None else f"{100 * t[3]:.2f} %" for t in (s_, u))
        print(f"phase 26 (d) {name}: sharded {s_[0]!r} ms / unsharded {u[0]!r} ms a call ({s_[0] / u[0]!r}x), "
              f"launches {s_[1]} / {u[1]}, collectives {s_[2]}, idle share {shares} ({smi})")
    launches = {"td_step_sharded": path["td_step_sharded"], "segment_sums": path["segment_sums"]}
    return launches, errs, {"td_step_sharded": t5}


# -- phase 27: the sharded TD(λ), Monte-Carlo and neural learners ---------------

# steps of each path over NCCL in a world of one (a) and over Gloo with two
# ranks sharing the card (b): TD(λ) steps, MC rounds, PPO / A2C updates, DQN steps
LEARNER_STEPS = {
    "nccl": dict(tdl=200, mc=3, ppo=2, a2c=2, mazes=1, dqn=20),
    "gloo": dict(tdl=4, mc=1, ppo=1, a2c=1, mazes=1, dqn=4),
}
# the entries whose results are the unsharded run's bits at two ranks too
# (whole chunks of 256 envs a rank, or the parity modes)
LEARNER_EXACT = ("td_lambda sarsa", "td_lambda watkins", "td_lambda_prediction", "td_lambda_prediction parity",
                 "mc_control parity", "mc_prediction parity", "mc_prediction wide parity")


def _learner_levels(gt, dev) -> dict:
    """Phase 27's inputs, built alike in every process: walls16 and the
    lava level, 65,536 4x4 Aldous-Broder mazes, a uniform policy, and the
    trainers' configurations (phase 12's and phase 18's)."""
    from griduniverse_tpu_torch import models
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.levels import maze as M

    walls16 = builders.walls_and_goal_16x16(device=dev)
    base = dict(buffer_capacity=131_072, max_episode_steps=MAX_EPISODE_STEPS)
    return dict(
        sem=gt.make_semantics(device=dev), walls16=walls16, lava=builders.lava_level(device=dev),
        mazes=_aldous_level(gt, M, dev, 2026, SHARD_B), policy=torch.full((walls16.num_states, 4), 0.25, device=dev),
        trainers={
            "ppo walls16": ("ppo", "walls16", models.PPOConfig(max_episode_steps=MAX_EPISODE_STEPS), "ppo"),
            "ppo mazes64k": ("ppo", "mazes", models.PPOConfig(max_episode_steps=MAX_EPISODE_STEPS, obs="grid",
                                                              conv_channels=(32,), hidden=(64,)), "mazes"),
            "a2c walls16": ("a2c", "walls16", models.A2CConfig(max_episode_steps=MAX_EPISODE_STEPS), "a2c"),
            "dqn walls16 uniform": ("dqn", "walls16", models.DQNConfig(**base), "dqn"),
            "dqn walls16 per": ("dqn", "walls16", models.DQNConfig(**base, prioritized=True), "dqn"),
        },
    )


def _trainer_api(kind):
    """(init_sharded, run_sharded, init, run) of a trainer."""
    from griduniverse_tpu_torch import models

    return {"ppo": (models.ppo_init_sharded, models.ppo_run_sharded, models.ppo_init, models.ppo_run),
            "a2c": (models.a2c_init_sharded, models.a2c_run_sharded, models.a2c_init, models.a2c_run),
            "dqn": (models.dqn_init_sharded, models.dqn_run_sharded, models.dqn_init, models.dqn_run)}[kind]


def _learner_calls(m, L, st) -> dict:
    """Every new sharded entry on mesh `m` at the step counts `st`, each a
    call of no arguments through the entries a user calls."""
    from griduniverse_tpu_torch import parallel

    sem, b, walls16, lava, policy = L["sem"], SHARD_B, L["walls16"], L["lava"], L["policy"]
    calls = {
        "td_lambda sarsa": lambda: parallel.td_lambda_sharded(m, sem, walls16, 5, st["tdl"], b),
        "td_lambda watkins": lambda: parallel.td_lambda_sharded(m, sem, walls16, 5, st["tdl"], b, algo="watkins"),
        "td_lambda_prediction": lambda: parallel.td_lambda_prediction_sharded(m, sem, walls16, policy, 5, st["tdl"], b),
        "td_lambda_prediction parity": lambda: parallel.td_lambda_prediction_sharded(
            m, sem, walls16, policy, 5, st["tdl"], b, parity=True),
        "mc_control": lambda: parallel.mc_control_sharded(m, sem, lava, 6, st["mc"]),
        "mc_control parity": lambda: parallel.mc_control_sharded(m, sem, lava, 6, st["mc"], parity=True),
        "mc_prediction": lambda: parallel.mc_prediction_sharded(m, sem, lava, 3),
        "mc_prediction parity": lambda: parallel.mc_prediction_sharded(m, sem, lava, 3, parity=True),
        "mc_prediction wide parity": lambda: parallel.mc_prediction_sharded(m, sem, lava, 3, batch_size=1024,
                                                                            parity=True),
    }
    for name, (kind, lv, cfg, key) in L["trainers"].items():
        init, run = _trainer_api(kind)[:2]
        calls[name] = (lambda init=init, run=run, lv=lv, cfg=cfg, key=key:
                       run(m, sem, L[lv], init(m, sem, L[lv], 5, cfg, b), cfg, st[key]))
    return calls


def _learner_unsharded(gt, L, st) -> dict:
    """The unsharded port's calls that `_learner_calls`' entries equal in a
    world of one: the trainers from the init's state with shard 0's seed
    (`models.a2c.shard_seed(5, 0)`), so that they draw the rank's noise."""
    from griduniverse_tpu_torch import algos
    from griduniverse_tpu_torch.models.a2c import shard_seed

    sem, b, walls16, lava, policy = L["sem"], SHARD_B, L["walls16"], L["lava"], L["policy"]
    calls = {
        "td_lambda sarsa": lambda: algos.sarsa_lambda(sem, walls16, 5, st["tdl"], b),
        "td_lambda watkins": lambda: algos.watkins_q_lambda(sem, walls16, 5, st["tdl"], b),
        "td_lambda_prediction": lambda: algos.td_lambda_prediction(sem, walls16, policy, 5, st["tdl"], b),
        "mc_control": lambda: algos.mc_control(sem, lava, 6, st["mc"]),
        "mc_prediction": lambda: algos.mc_prediction(sem, lava, 3),
        "mc_prediction wide parity": lambda: algos.mc_prediction(sem, lava, 3, batch_size=1024),
    }
    for name in ("td_lambda_prediction", "mc_control", "mc_prediction"):
        calls[f"{name} parity"] = calls[name]
    for name, (kind, lv, cfg, key) in L["trainers"].items():
        init, run = _trainer_api(kind)[2:]
        calls[name] = (lambda init=init, run=run, lv=lv, cfg=cfg, key=key: run(
            sem, L[lv], dataclasses.replace(init(sem, L[lv], 5, cfg, b), seed=shard_seed(5, 0)), cfg, st[key]))
    return calls


def _learner_views(name, out):
    """(the entry's replicated values, its rows or per-shard values by
    field), each flat, of an output of `_learner_calls` or
    `_learner_unsharded`."""
    if name.startswith("td_lambda_prediction"):
        return {"v": out.v, "episodes": out.episodes}, {}
    if name.startswith("td_lambda"):
        return {"q": out.q, "episodes": out.episodes}, {}
    if name.startswith("mc_control"):
        return {"q": out.q, "episodes": out.episodes}, {}
    if name.startswith("mc_prediction"):
        return {"value": out.value, "counts": out.counts}, {}
    from griduniverse_tpu_torch.models.a2c import SHARDED_FIELDS
    from griduniverse_tpu_torch.parallel.mesh import tree_map

    rep, rows = {}, {}
    for f in dataclasses.fields(out):
        value = getattr(out, f.name)
        if not isinstance(value, (torch.Tensor, dict, tuple)) and not dataclasses.is_dataclass(value):
            continue
        leaves = {}
        tree_map(lambda x, path=f.name: leaves.__setitem__(f"{path}.{len(leaves)}", x.reshape(-1)), value)
        (rows if f.name in SHARDED_FIELDS else rep).update(leaves)
    return rep, rows


def _learner_digests(outs) -> dict:
    """Every entry's replicated values as digests and its rows on the host."""
    return {name: ({k: _digest(v) for k, v in rep.items()}, {k: v.detach().cpu().clone() for k, v in rows.items()})
            for name, (rep, rows) in ((n, _learner_views(n, out)) for n, out in outs.items())}


def _a2c_one_update(L, m, gumbel):
    """One float32 A2C update at walls16 from shard seed 5's parameters: on
    mesh `m` (sharded) or unsharded where `m` is None, with the noise given."""
    from griduniverse_tpu_torch import models

    cfg = models.A2CConfig(max_episode_steps=MAX_EPISODE_STEPS, compute_dtype="float32")
    sem, walls16 = L["sem"], L["walls16"]
    if m is None:
        ts = models.a2c_init(sem, walls16, 5, cfg, SHARD_B)
        return models.a2c_run(sem, walls16, ts, cfg, 1, gumbel=gumbel)
    ts = models.a2c_init_sharded(m, sem, walls16, 5, cfg, SHARD_B)
    return models.a2c_run_sharded(m, sem, walls16, ts, cfg, 1, gumbel=gumbel)


def _shard_noise(L, rank: int, ranks: int):
    """Shard `rank`'s noise of update 0 of a float32 A2C run of seed 5."""
    from griduniverse_tpu_torch import models
    from griduniverse_tpu_torch.models.a2c import shard_seed, update_noise

    cfg = models.A2CConfig(max_episode_steps=MAX_EPISODE_STEPS, compute_dtype="float32")
    return update_noise(L["walls16"].device, shard_seed(5, rank), 0, cfg, SHARD_B // ranks, 4)


def _gloo_learner_rank(rank: int, port: int, out_dir: str, device: str = "cuda:0") -> None:
    """Phase 27 (b), one rank: Gloo over two processes sharing card 0, every
    new sharded entry at the Gloo step counts, the digests and a float32 A2C
    update saved for the parent. (`device="cpu"` rehearses it without a
    card.)"""
    sys.path.insert(0, str(ROOT))
    import griduniverse_tpu_torch as gt
    from griduniverse_tpu_torch import kernels, parallel
    from griduniverse_tpu_torch.parallel import distributed

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
    info = distributed.initialize("gloo", f"tcp://127.0.0.1:{port}", GLOO_RANKS, rank, device=dev, timeout_s=300)
    try:
        m = parallel.make_env_mesh(GLOO_RANKS, device=dev)
        L = _learner_levels(gt, dev)
        if on_card:
            torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        outs = {name: call() for name, call in _learner_calls(m, L, LEARNER_STEPS["gloo"]).items()}
        if on_card:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        gumbel = torch.cat([_shard_noise(L, r, GLOO_RANKS) for r in range(GLOO_RANKS)], dim=1)[None]
        one = _a2c_one_update(L, m, gumbel)
        torch.save({"info": {**info, "device": str(info["device"])}, "launches": launches, "seconds": seconds,
                    "record": _learner_digests(outs), "a2c one": {k: v.cpu() for k, v in one.params.items()}},
                   Path(out_dir) / f"rank{rank}.pt")
    finally:
        distributed.shutdown()


def _learner_nccl(gt, dev, smi, L, lap):
    """Phase 27 (a) and (d) in a world of one over NCCL (the group already
    initialised): every new entry at full width held bit for bit against the
    unsharded port, its launches counted (a trainer's equal to the unsharded
    trainer's); then each against its unsharded call. Returns ({entry:
    {turn: (ms, launches, collectives, idle share)}}, the path's launches)."""
    from griduniverse_tpu_torch import kernels, parallel
    from griduniverse_tpu_torch.tools.profile_solvers import _wall_ms
    from griduniverse_tpu_torch.utils import capture

    full = LEARNER_STEPS["nccl"]
    m = parallel.make_env_mesh(1, device=dev)
    print(f"phase 27 (a): backend {m.backend}, world size {m.size} ({smi})")
    calls, unsharded = _learner_calls(m, L, full), _learner_unsharded(gt, L, full)
    for name in L["trainers"]:  # first calls: library handles, the allocator
        calls[name]()
    torch.cuda.synchronize()
    path, outs, own = {}, {}, {}
    for name, call in calls.items():
        kernels.reset_launches()
        outs[name] = call()
        torch.cuda.synchronize()
        own[name] = {k: v for k, v in kernels.LAUNCHES.items() if v}
        for k, v in own[name].items():
            path[k] = path.get(k, 0) + v
    print(f"launches on the sharded learners' main path (NCCL, world of one): {path}")
    # K12's partial-sums form: the pass and the apply, a step of each of the four TD(λ) runs
    _require(path.get("trace_partials") == 4 * 2 * full["tdl"] and not path.get("trace_pass"),
             f"K12's partial-sums form: {path.get('trace_partials')} launches, expected {4 * 2 * full['tdl']}")
    for name in ("mc_returns", "segment_mean", "segment_sums", "act_step", "gae", "embed_rows", "agent_stamp",
                 "dqn_act", "replay", "per_sample"):
        _require(path.get(name, 0) > 0, f"{name} was not launched on the sharded learners' path")
    for name, call in unsharded.items():
        kernels.reset_launches()
        want = call()
        torch.cuda.synchronize()
        if name in L["trainers"]:  # the unsharded call is captured: its replays' launches, without its warm-up's
            a_replay = capture.LAST[f"{L['trainers'][name][0]}_run"].launches
            theirs = {k: v - capture.WARMUP_STEPS * a_replay.get(k, 0) for k, v in kernels.LAUNCHES.items()}
            theirs = {k: v for k, v in theirs.items() if v}
            _require(own[name] == theirs, f"sharded (a) {name}: launches {own[name]}, the unsharded trainer {theirs}")
        rep, rows = _learner_views(name, outs[name])
        want_rep, want_rows = _learner_views(name, want)
        _require(set(rep) == set(want_rep) and set(rows) == set(want_rows), f"sharded (a) {name}: other fields")
        for k in rep:
            _same(f"sharded (a) {name} {k}", rep[k], want_rep[k])
        for k in rows:
            _same(f"sharded (a) {name} {k}", rows[k], want_rows[k])
    for name in ("td_lambda sarsa", "td_lambda watkins"):  # as phase 21: the random policy need not reach the goal
        _require(int(outs[name].episodes) > 0, f"sharded (a) {name}: no episode ended")
    for name in L["trainers"]:
        _require(all(bool(torch.isfinite(p).all()) for p in outs[name].params.values())
                 and bool(torch.isfinite(outs[name].last_loss)), f"sharded (a) {name}: a non-finite parameter or loss")
    print(f"phase 27 (a): every new sharded entry over NCCL in a world of one equals the unsharded port bit for bit, "
          f"with the same launches where it runs the same kernels: td_lambda_sharded (sarsa, watkins) and "
          f"td_lambda_prediction_sharded (scalable, parity) at walls16, B={SHARD_B}, T={full['tdl']}, traces "
          f"({SHARD_B}, 1,024) and ({SHARD_B}, 256) against sarsa_lambda / watkins_q_lambda / td_lambda_prediction "
          f"(Q, V, episodes); mc_control_sharded ({full['mc']} rounds) and mc_prediction_sharded (256 and 1,024 "
          f"episodes x 100 steps), scalable and parity, at lava; ppo, a2c and dqn (uniform, PER) *_run_sharded at "
          f"walls16 and PPO over {SHARD_B} mazes, B={SHARD_B}, against the unsharded trainers on shard 0's seed "
          f"(parameters, Adam, target, env state, statistics, the ring and priorities) ({smi})")
    lap("phase 27 (a)")

    steps_of = {"td_lambda sarsa": full["tdl"], "td_lambda_prediction": full["tdl"], "mc_control": full["mc"],
                "ppo walls16": full["ppo"], "a2c walls16": full["a2c"], "dqn walls16 per": full["dqn"]}
    timed = {}
    # every new entry once (the trainers on walls16, DQN with PER), each call on the host clock and once profiled
    for name in ("td_lambda sarsa", "td_lambda_prediction", "mc_control", "mc_prediction", "ppo walls16",
                 "a2c walls16", "dqn walls16 per"):
        row = {}
        for tag, fn in (("unsharded", unsharded[name]), ("sharded", calls[name])):
            kernels.reset_launches()
            wall, coll = _collectives(lambda fn=fn: _wall_ms(fn))
            launched = sum(kernels.LAUNCHES.values())
            idle, events = _idle_share(fn, wall)
            row[tag] = (wall, launched, coll, idle)
            steps = steps_of.get(name)
            per_step = "" if steps is None else (f", {sum(coll.values()) / steps!r} collectives a step "
                                                 f"({launched / steps!r} launches a step)")
            share = "not measured (the profiler recorded no device time)" if idle is None else f"{100 * idle:.2f} %"
            print(f"phase 27 (d) {name} {tag}: {wall!r} ms a call on the host clock, {launched} kernel launches, "
                  f"collectives {coll}{per_step}, {events} device events, device idle share {share} ({smi})")
        timed[name] = row
    lap("phase 27 (d)")
    return timed, path


def sharded_learner_phases(gt, dev, bound, smi):
    """Phase 27: the sharded TD(λ) and MC learners of `parallel/learner.py`
    and the sharded trainers of `models/`. (a) A world of one over NCCL at
    full width, every entry held bit for bit against the unsharded port
    (the trainers on shard 0's seed), its launches counted; (b) two ranks
    sharing the card over Gloo at fewer steps: the TD(λ) runs (whole chunks
    a rank) and the parity modes against the unsharded port bit for bit,
    every replicated value the same bits on both ranks, and a float32 A2C
    update against the unsharded update on the same noise; (c) K12's
    partial-sums form against its plain version on the control and the
    prediction trace and against K12's own step, timed in a CUDA graph of
    ten; (d) each new entry's time, launches, collectives and idle share
    against its unsharded call. Returns (launches, max abs errors, times)."""
    import torch.multiprocessing as tmp

    from griduniverse_tpu_torch.algos import td_lambda
    from griduniverse_tpu_torch.kernels import trace_pass as k12
    from griduniverse_tpu_torch.parallel import distributed
    from griduniverse_tpu_torch.tools.profile_turns import _plan_graph_ms

    t_lap = [time.perf_counter()]

    def lap(what: str) -> None:
        now = time.perf_counter()
        print(f"{what}: {now - t_lap[0]:.1f} s")
        t_lap[0] = now

    L = _learner_levels(gt, dev)
    # -- (a) and (d): NCCL, a world of one --------------------------------------------
    distributed.initialize("nccl", f"tcp://127.0.0.1:{_free_port()}", 1, 0, device=dev, timeout_s=300)
    try:
        timed, path = _learner_nccl(gt, dev, smi, L, lap)
    finally:
        distributed.shutdown()
    torch.cuda.empty_cache()

    # -- (b) Gloo, two ranks sharing the card ------------------------------------------
    gloo = LEARNER_STEPS["gloo"]
    with_dir = ROOT / "build" / "smoke_gloo_learners"
    with_dir.mkdir(parents=True, exist_ok=True)
    ctx = tmp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_gloo_learner_rank, args=(r, port, str(with_dir))) for r in range(GLOO_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + GLOO_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    late = [p for p in procs if p.is_alive()]
    for p in late:
        p.kill()
        p.join(10)
    codes = [p.exitcode for p in procs]
    _require(not late and codes == [0] * GLOO_RANKS, f"phase 27 (b): exit codes {codes}, {len(late)} killed")
    ranks = [torch.load(with_dir / f"rank{r}.pt", weights_only=False) for r in range(GLOO_RANKS)]
    for f in with_dir.iterdir():
        f.unlink()
    with_dir.rmdir()
    print(f"phase 27 (b): {GLOO_RANKS} ranks over Gloo on one card in {time.perf_counter() - t0:.1f} s (their "
          f"sharded runs {[round(r['seconds'], 3) for r in ranks]} s)")
    for r in ranks:
        print(f"phase 27 (b) rank {r['info']['rank']}: backend {r['info']['backend']}, world size "
              f"{r['info']['world_size']}, device {r['info']['device']}; launches {r['launches']}")
        _require(r["launches"].get("trace_partials") == 4 * 2 * gloo["tdl"],
                 f"phase 27 (b) rank {r['info']['rank']}: launches {r['launches']}")
    unsharded = _learner_unsharded(gt, L, gloo)
    for name in ranks[0]["record"]:
        for rank, r in enumerate(ranks[1:], 1):
            _require(r["record"][name][0] == ranks[0]["record"][name][0],
                     f"phase 27 (b) {name}: rank {rank} holds other bits than rank 0")
        if name in LEARNER_EXACT:
            rep, _ = _learner_views(name, unsharded[name]())
            for k, v in rep.items():
                _require(ranks[0]["record"][name][0][k] == _digest(v),
                         f"phase 27 (b) {name} {k}: differs from the unsharded run")
    gumbel = torch.cat([_shard_noise(L, r, GLOO_RANKS) for r in range(GLOO_RANKS)], dim=1)[None]
    want = _a2c_one_update(L, None, gumbel)
    a2c_err = max(_max_err(ranks[0]["a2c one"][k].to(dev), want.params[k]) for k in want.params)
    _require(a2c_err <= 1e-5, f"phase 27 (b): a float32 A2C update over two ranks is {a2c_err} from the unsharded one")
    for rank, r in enumerate(ranks[1:], 1):
        for k, v in r["a2c one"].items():
            _same(f"phase 27 (b) a2c one {k} rank {rank}", v, ranks[0]["a2c one"][k])
    print(f"phase 27 (b): over Gloo with {GLOO_RANKS} ranks on one card every replicated value of every new entry is "
          f"the same bits on both ranks; the TD(λ) runs (B/n = {SHARD_B // GLOO_RANKS}, whole chunks), the prediction "
          f"in both modes and MC's parity modes equal the unsharded port bit for bit; a float32 A2C update at walls16, "
          f"B={SHARD_B}, is {a2c_err!r} (max abs) from the unsharded update on the same noise ({smi})")
    lap("phase 27 (b)")

    # -- (c) K12's partial-sums form against its plain version, and timed --------------
    gen = torch.Generator(device=dev).manual_seed(27)
    errs = {"trace_partials": 0.0}
    records = []
    for name, shape in (("control", (SHARD_B, 256, 4)), ("prediction", (SHARD_B, 256))):
        b, n_cells = shape[0], int(np.prod(shape[1:]))
        e = torch.rand(shape, generator=gen, device=dev) * (torch.rand(shape, generator=gen, device=dev) < 0.3)
        s = torch.randint(0, 256, (b,), generator=gen, device=dev, dtype=torch.int32)
        a = None if len(shape) == 2 else torch.randint(0, 4, (b,), generator=gen, device=dev, dtype=torch.int32)
        delta = torch.randn((b,), generator=gen, device=dev)
        cut = torch.rand((b,), generator=gen, device=dev) < 0.1
        table = torch.randn(shape[1:], generator=gen, device=dev)
        step = (0.99, 0.9, 1e-4, 0.1, "accumulating")
        e_k, e_p, e_w = e.clone(), e.clone(), e.clone()
        plan = k12.TracePartialsPlan(table, b, a is not None, own_rows=True)
        local, count = plan.partials(e_k, s, a, delta, cut, 0.99 * 0.9, 1e-4, False)
        part, cnt = td_lambda.trace_partials_reference(e_p, s, a, delta, cut, *step[:3], step[4])
        errs["trace_partials"] = max(errs["trace_partials"], _same(f"K12 partials {name} partial sums", local, part),
                                     _same(f"K12 partials {name} counts", count, cnt),
                                     _same(f"K12 partials {name} trace", e_k, e_p))
        got = plan.apply(table, 0.1)
        errs["trace_partials"] = max(errs["trace_partials"], _same(
            f"K12 partials {name} table", got, td_lambda.apply_partials_reference(table, part, cnt, 0.1)))
        _same(f"K12 partials {name} against K12's step",
              got, td_lambda.trace_pass(table, e_w, s, a, delta, cut, *step))
        _same(f"K12 partials {name} trace against K12's step", e_k, e_w)
        _require(not plan.count.any(), f"K12 partials {name}: the apply left a count")

        def make_plan(table=table, b=b, a=a):
            return k12.TracePartialsPlan(table, b, a is not None, own_rows=True)

        def call(pl, table=table, e=e_k, s=s, a=a, delta=delta, cut=cut):
            pl.partials(e, s, a, delta, cut, 0.99 * 0.9, 1e-4, False)
            return pl.apply(table, 0.1)

        ms, _ = _cuda_ms(lambda: call(plan), 20)
        graph_ms = _plan_graph_ms(make_plan, call)
        plain_ms, _ = _cuda_ms(lambda: td_lambda.apply_partials_reference(
            table, *td_lambda.trace_partials_reference(e_p, s, a, delta, cut, *step[:3], step[4]), 0.1), 2)
        chunks = -(-b // k12.CHUNK)
        flat = e_k.reshape(chunks, k12.CHUNK, n_cells)
        library_ms, _ = _cuda_ms(lambda: torch.bmm(delta.reshape(chunks, 1, k12.CHUNK), flat), 20)
        rec = dict(ms=ms, graph_ms=graph_ms, plain_ms=plain_ms, library_ms=library_ms,
                   shape=f"{name}, trace ({b}, {n_cells}), a step (the pass and the apply) of one rank",
                   # the trace read and written once; s, a, δ, cut in; the partials written and read; the table
                   **bound(2 * b * n_cells * 4 + b * 13 + 2 * chunks * n_cells * 4 + 2 * n_cells * 4,
                           INSTR_K12_ELEM * b * n_cells))
        print(f"time trace_partials at {rec['shape']}: kernels {ms!r} ms a step as timed, {graph_ms!r} ms in a CUDA "
              f"graph of ten, plain {plain_ms!r} ms, bound {rec['bound_ms']!r} ms by {rec['bound_by']}, library "
              f"(the chunked sums by torch.bmm) {library_ms!r} ms ({smi})")
        records.append(rec)
        del e, e_k, e_p, e_w, plan
    print("K12's partial-sums form at 65,536 envs, control (256, 4) and prediction (256): the partial sums, counts, "
          "trace and table bit-exact vs plain and vs K12's own step; the apply leaves the counts 0")
    lap("phase 27 (c)")
    for name, row in timed.items():
        u, s_ = row["unsharded"], row["sharded"]
        shares = " / ".join("not measured" if t[3] is None else f"{100 * t[3]:.2f} %" for t in (s_, u))
        print(f"phase 27 (d) {name}: sharded {s_[0]!r} ms / unsharded {u[0]!r} ms a call ({s_[0] / u[0]!r}x), "
              f"launches {s_[1]} / {u[1]}, collectives {s_[2]}, idle share {shares} ({smi})")
    return {"trace_partials": path["trace_partials"]}, errs, {"trace_partials": records}


# -- phase 28: the generalization gate's path (`tools/gen_artifact.py`) ----------
# Full width (the recipe's 1,024 training and 256 held-out mazes, its
# networks), cut in depth: 10 updates at 7×7, and 2 chunks × 5 updates of
# the 11×11 curriculum. A CPU rehearsal sets these small.
GATE_MAZES, GATE_EVAL, GATE_BUDGET = 1024, 256, 60
GATE_UPDATES, GATE_CHUNKS, GATE_CHUNK_UPDATES = 10, 2, 5
GATE_K3_CELLS = ((3, 3), (4, 4), (5, 5))


def gate_phases(gt, dev, bound, smi):
    """Phase 28: the generalization gate's path through the tool's own
    functions. K3's training and held-out mazes (`maze_levels`), PPO with
    the conv trunk at 7×7 (`ppo_init`, `ppo_run`), the greedy evaluation and
    its wrong-tiles ablation (`greedy_success_rate`), and the fresh-maze
    curriculum at 11×11 (`curriculum_train`), counted from 0. Then the
    mazes, the last update's K7b steps, K7a's advantages, K9b's forward and
    backward, and every greedy step against the plain versions; the
    curriculum's carried Adam count and rate; seconds an update, the idle
    share, and K3's times at 1,024 mazes of 3×3, 4×4 and 5×5 cells.
    Returns (launches, max abs errors, K3's time records)."""
    from griduniverse_tpu_torch import kernels, models
    from griduniverse_tpu_torch.kernels import agent_stamp as k9b
    from griduniverse_tpu_torch.levels import maze as M
    from griduniverse_tpu_torch.models import a2c, networks, ppo
    from griduniverse_tpu_torch.ops import bitplane as bp
    from griduniverse_tpu_torch.tools import gen_artifact as G
    from griduniverse_tpu_torch.tools.profile_solvers import _wall_ms
    from griduniverse_tpu_torch.utils import capture

    errs = dict.fromkeys(("aldous_broder_mazes", "gae", "act_step", "agent_stamp"), 0.0)
    sem = gt.make_semantics(device=dev)
    cfg7 = G.gate_config(G.CONFIGS["7x7_ch32"], GATE_UPDATES)
    cfg11 = G.gate_config(G.CONFIGS["11x11_curriculum"], GATE_CHUNK_UPDATES)
    cells7, cells11 = (3, 3), (5, 5)
    models.ppo_train(sem, G.maze_levels(3, 64, cells7, dev), 0, cfg7, 1, 64)  # library handles, allocator

    # the path, counted from 0
    torch.cuda.synchronize()
    kernels.reset_launches()
    capture.reset_counts()
    t0 = time.perf_counter()
    train_lv = G.maze_levels(G.TRAIN_MAZES_SEED, GATE_MAZES, cells7, dev)
    eval_lv = G.maze_levels(G.EVAL_MAZES_SEED, GATE_EVAL, cells7, dev)
    abl_lv = G.rolled_tiles_level(eval_lv)
    ts0 = models.ppo_init(sem, train_lv, 1, cfg7, GATE_MAZES)
    before_last = models.ppo_run(sem, train_lv, ts0, cfg7, GATE_UPDATES - 1)
    end = models.ppo_run(sem, train_lv, before_last, cfg7, 1)
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t0) * 1e3
    net = models.make_network(train_lv, sem.num_actions, cfg7)
    held = models.greedy_success_rate(sem, net, end.params, eval_lv, GATE_BUDGET)
    abl = models.greedy_success_rate(sem, net, end.params, eval_lv, GATE_BUDGET, tiles_levels=abl_lv)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cur, last_lv = G.curriculum_train(sem, cfg11, 1, GATE_CHUNKS, GATE_CHUNK_UPDATES, GATE_MAZES, cells11, dev)
    torch.cuda.synchronize()
    cur_ms = (time.perf_counter() - t1) * 1e3
    got = {k: kernels.LAUNCHES[k] for k in kernels.LAUNCHES}
    # each `ppo_run` call (two at 7x7, one a chunk) is captured: its replays and its warm-up update
    _require(capture.COUNTS == {"captures": 2 + GATE_CHUNKS, "warmup_steps": (2 + GATE_CHUNKS) * capture.WARMUP_STEPS,
                                "replays": GATE_UPDATES + GATE_CHUNKS * GATE_CHUNK_UPDATES},
             f"phase 28: {capture.COUNTS}")
    updates = capture.COUNTS["replays"] + capture.COUNTS["warmup_steps"]
    t_len, sgd = cfg7.rollout_len, cfg7.num_epochs * cfg7.num_minibatches
    expected = {**dict.fromkeys(got, 0),
                "aldous_broder_mazes": 2 + GATE_CHUNKS,  # training, held-out, one a chunk
                "act_step": updates * t_len + 2 * GATE_BUDGET,
                "gae": updates,
                # an update: T forwards and the bootstrap's, a forward and a backward an SGD step
                "agent_stamp": updates * (t_len + 1 + sgd * (1 + k9b.backward_launches())) + 2 * GATE_BUDGET}
    print(f"phase 28 launches (K3 mazes, PPO at 7x7, greedy and ablation, the 11x11 curriculum): "
          f"{ {k: n for k, n in got.items() if n} }")
    _require(got == expected, f"phase 28: launches {got}, expected {expected}")
    launches = {k: got[k] for k in errs}
    finite = all(bool(torch.isfinite(p).all()) for ts in (end, cur) for p in ts.params.values())
    _require(finite and bool(torch.isfinite(end.last_loss)) and bool(torch.isfinite(cur.last_loss)),
             "phase 28: a non-finite parameter or loss")
    _require(0.0 <= float(held) <= 1.0 and 0.0 <= float(abl) <= 1.0, "phase 28: a success rate out of range")
    print(f"phase 28 main: {GATE_MAZES} 7x7 mazes, {GATE_UPDATES} updates in {train_ms!r} ms (first call of the "
          f"path); held-out {float(held)!r}, ablation {float(abl)!r} on {GATE_EVAL} mazes; 11x11 curriculum "
          f"{GATE_CHUNKS} x {GATE_CHUNK_UPDATES} updates in {cur_ms!r} ms ({smi})")

    # K3's mazes against its plain version, goal included
    for tag, lv, seed, cells, n in (("training", train_lv, G.TRAIN_MAZES_SEED, cells7, GATE_MAZES),
                                    ("held-out", eval_lv, G.EVAL_MAZES_SEED, cells7, GATE_EVAL),
                                    ("last chunk", last_lv, G.chunk_maze_seed(1, GATE_CHUNKS - 1), cells11, GATE_MAZES)):
        start = torch.tensor(2 * cells[1] + 2, dtype=torch.int32, device=dev)  # (1, 1) in a row of 2c + 1
        ref = G.goal_levels(M.aldous_broder_mazes_reference(cells, n, seed=seed, device=dev), start)
        errs["aldous_broder_mazes"] = max(errs["aldous_broder_mazes"], _same_fields(
            f"K3 phase 28 {tag}", (lv.grid, lv.start_idx), (ref.grid, ref.start_idx), ("grid", "start")))
        _require(all(M.check_perfect_maze(g, cells) for g in lv.grid[:64].cpu().numpy()),
                 f"phase 28 {tag}: a maze is not perfect")
    print("K3 phase 28: the training, held-out and last chunk's mazes bit-exact vs plain, goal and start included")

    # the curriculum's carried Adam count and its rate
    per_update = cfg11.num_epochs * cfg11.num_minibatches
    count = int(cur.opt_state.count)
    _require(count == GATE_CHUNKS * GATE_CHUNK_UPDATES * per_update and cur.update == GATE_CHUNK_UPDATES,
             f"phase 28 curriculum: Adam count {count}, update {cur.update}")
    rate = float(ppo._rate(cfg11)(cur.opt_state.count))
    want = cfg11.lr * (1 - count / (cfg11.lr_decay_updates * per_update))
    _require(abs(rate - want) <= 1e-6 * cfg11.lr, f"phase 28 curriculum: rate {rate!r} at count {count}, not {want!r}")
    print(f"phase 28 curriculum: Adam count {count} carried over {GATE_CHUNKS} chunks; the next rate {rate!r} is the "
          f"linear schedule's over {cfg11.lr_decay_updates} updates ({want!r})")

    # the last 7x7 update, float32: K7b, K7a and K9b against the plain versions
    _hold_last_update("phase 28 ppo 7x7", sem, train_lv, cfg7, before_last, end, GATE_MAZES, 1e-4, errs)

    # every greedy step of the evaluation and of the ablation against the plain version
    for tag, planes, rate_main in (("held-out", eval_lv, held), ("ablation", abl_lv, abl)):
        ebl = bp.pack_level(eval_lv)
        etiles = a2c._tiles_for(net, planes)
        st = bp.reset_bits(ebl, None)
        reached = torch.zeros(GATE_EVAL, dtype=torch.bool, device=dev)
        with torch.no_grad(), networks.exact_kernels():
            for t in range(GATE_BUDGET):
                logits, _ = _apply(net, end.params, st.agent_idx, etiles)
                got_g = a2c.greedy_step(sem, ebl, st, reached, logits)
                ref_g = a2c.greedy_step_reference(sem, ebl, st, reached, logits)
                errs["act_step"] = max(errs["act_step"], _same_fields(
                    f"K7b phase 28 greedy {tag} step {t}", (*(getattr(got_g[0], f) for f in _STATE_FIELDS), got_g[1]),
                    (*(getattr(ref_g[0], f) for f in _STATE_FIELDS), ref_g[1]), (*_STATE_FIELDS, "reached")))
                st, reached = ref_g
        _same(f"phase 28 greedy {tag}: the success rate", reached.float().mean(), rate_main)
    print(f"phase 28 greedy: each of the {GATE_BUDGET} greedy steps on {GATE_EVAL} held-out mazes, with their own and "
          "with the rolled planes, exact vs plain; both rates equal the path's")

    # seconds an update and the idle share, each config's shape
    for tag, lv, ts, cfg, n in (("7x7 ch32", train_lv, end, cfg7, 5), ("11x11 ch32x2", last_lv, cur, cfg11, 3)):
        def call(lv=lv, ts=ts, cfg=cfg, n=n):
            return models.ppo_run(sem, lv, ts, cfg, n)

        walls = sorted(_wall_ms(call) for _ in range(3))
        idle, events = _idle_share(call, walls[1])
        print(f"phase 28 {tag}: {[w / n / 1e3 for w in walls]!r} s an update at B={GATE_MAZES} ({n} updates a "
              f"call, host clock); idle share {idle!r}, {events / n!r} device events an update ({smi})")

    # K3 at the gate's shapes: 1,024 mazes of 3x3, 4x4 and 5x5 cells
    k3_times = []
    for cells in GATE_K3_CELLS:
        ms, got_g = _cuda_ms(lambda cells=cells: M._aldous_broder_mazes(cells, GATE_MAZES, seed=7, device=dev), 10)
        plain_ms, (ref_g, walk) = _cuda_ms(lambda cells=cells: M.aldous_broder_mazes_reference(
            cells, GATE_MAZES, seed=7, device=dev, count_steps=True), 1)
        errs["aldous_broder_mazes"] = max(errs["aldous_broder_mazes"], _same(f"K3 phase 28 timed {cells}", got_g, ref_g))
        h, w = 2 * cells[0] + 1, 2 * cells[1] + 1
        s = cells[0] * cells[1]
        t3 = dict(ms=ms, plain_ms=plain_ms, shape=f"seeded cells={cells} B={GATE_MAZES}", library_ms=None,
                  **bound(GATE_MAZES * h * w * 4, k3_function_ops(int(walk.sum()), GATE_MAZES * (s - 1), injected=False)))
        k3_times.append(t3)
        print(f"time aldous_broder_mazes at {t3['shape']}: kernel {ms!r} ms, plain {plain_ms!r} ms, bound "
              f"{t3['bound_ms']!r} ms by {t3['bound_by']}; the longest walk {int(walk.max())} steps ({smi})")
    return launches, errs, k3_times


def _aldous_level(gt, M, dev, seed, b, cells=(4, 4)):
    grids, start = M.generate_mazes_device(seed, cells, b, "aldous_broder", device=dev)
    return gt.Level(grid=grids, start_idx=start.expand(b).contiguous())


# -- phase 29: the captured trainers (`utils/capture.py`) ------------------------
# Each path: (trainer, level, config, envs, steps or updates a call, the chunk
# of its N + N = 2N hold). PPO over mazes is cut to 2 + 2 against 4 updates.
CAPTURED_TIMED = 3  # host-clock calls each way after a warm one


def _all_state_fields(ts):
    """(tensors, labels) of every tensor field of a train state: the
    parameters (and DQN's target) and Adam's moments by name, Adam's count,
    the env state, the ring and the rest."""
    fields, labels = [], []
    for f in dataclasses.fields(ts):
        x = getattr(ts, f.name)
        if isinstance(x, dict):
            items = [(k, x[k]) for k in sorted(x)]
        elif dataclasses.is_dataclass(x):
            sub = _all_state_fields(x)
            items = list(zip(sub[1], sub[0]))
        elif isinstance(x, tuple):
            items = list(x._asdict().items())
        elif isinstance(x, torch.Tensor):
            items = [("", x)]
        else:
            continue
        for k, v in items:
            fields.append(v)
            labels.append(f"{f.name} {k}".strip())
    return fields, labels


def _same_whole_state(tag: str, a, b) -> None:
    fa, labels = _all_state_fields(a)
    fb, labels_b = _all_state_fields(b)
    _require(labels == labels_b, f"{tag}: other fields")
    _same_fields(tag, fa, fb, labels)
    for f in dataclasses.fields(a):  # the seed, and PPO's and A2C's counter
        if isinstance(getattr(a, f.name), int):
            _require(getattr(a, f.name) == getattr(b, f.name), f"{tag}: {f.name} differs")


def _call_trace(fn, our_kernels):
    """One call of `fn` under the profiler (device activity, which brings
    the CUDA runtime's calls with it): (device busy us, device events,
    events of the port's own kernels, graph launches the host made)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    graphs = sum(1 for e in prof.events() if e.name == "cudaGraphLaunch")
    return (sum(e.time_range.elapsed_us() for e in on_card), len(on_card),
            sum(1 for e in on_card if any(k in e.name for k in our_kernels)), graphs)


def captured_phases(gt, dev, smi, lv64) -> dict:
    """Phase 29: `dqn_run`, `ppo_run` and `a2c_run` on the card, each call one
    step or update captured in a CUDA graph and replayed, against their
    plain version, the eager loop (`_*_run_eager`), at full width: DQN
    uniform and PER on walls16 (65,536 envs, ring 131,072, 100 steps) and
    over the 65,536 backtracker mazes with the conv trunk (50 steps), PPO on
    walls16 (3 updates) and over the mazes (2), A2C on walls16 (3), and the
    gate's path (phase 28's 7×7 ch32 PPO over 1,024 mazes, 10 updates).
    Each path: every state field bit for bit each way; the launches of the
    captured call the graph's a replay times the replays and the warm-up
    step, and the eager call's the same a step; N + N = 2N captured; ms a
    call (median of three after a warm one) each way, the capture's ms and
    its pool's bytes, the idle share of a call, and device events, the
    port's kernels and graph launches a step by `torch.profiler` (a call of
    two steps less a call of one, so that the set-up cancels). Returns
    {path: figures}."""
    from griduniverse_tpu_torch import kernels, models
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.models import a2c, dqn, ppo
    from griduniverse_tpu_torch.tools import gen_artifact as G
    from griduniverse_tpu_torch.tools.profile_learners import OUR_KERNELS
    from griduniverse_tpu_torch.tools.profile_solvers import _wall_ms
    from griduniverse_tpu_torch.utils import capture

    sem = gt.make_semantics(device=dev)
    walls16 = builders.walls_and_goal_16x16(device=dev)
    n64 = 65_536
    base = dict(buffer_capacity=131_072, max_episode_steps=MAX_EPISODE_STEPS)
    grid = dict(obs="grid", conv_channels=(32,), hidden=(64,))
    gate_lv = G.maze_levels(G.TRAIN_MAZES_SEED, GATE_MAZES, (3, 3), dev)
    paths = {
        "dqn walls16 uniform": ("dqn", walls16, models.DQNConfig(**base), n64, 100, 60),
        "dqn walls16 per": ("dqn", walls16, models.DQNConfig(**base, prioritized=True), n64, 100, 60),
        "dqn mazes64k grid": ("dqn", lv64, models.DQNConfig(**base, **grid), n64, 50, 60),
        "ppo walls16": ("ppo", walls16, models.PPOConfig(max_episode_steps=MAX_EPISODE_STEPS), n64, 3, 60),
        "ppo mazes64k": ("ppo", lv64, models.PPOConfig(max_episode_steps=MAX_EPISODE_STEPS, **grid), n64, 2, 2),
        "a2c walls16": ("a2c", walls16, models.A2CConfig(max_episode_steps=MAX_EPISODE_STEPS), n64, 3, 60),
        "gate 7x7 ch32": ("ppo", gate_lv, G.gate_config(G.CONFIGS["7x7_ch32"], GATE_UPDATES), GATE_MAZES,
                          GATE_UPDATES, 60),
    }
    api = {"dqn": (models.dqn_init, models.dqn_run, dqn._dqn_run_eager),
           "ppo": (models.ppo_init, models.ppo_run, ppo._ppo_run_eager),
           "a2c": (models.a2c_init, models.a2c_run, a2c._a2c_run_eager)}
    out = {}
    for name, (kind, level, cfg, b, n, chunk) in paths.items():
        t_path = time.perf_counter()
        init, run, eager = api[kind]
        ts0 = init(sem, level, 5, cfg, b)
        ways = {"captured": lambda k, ts=ts0: run(sem, level, ts, cfg, k),
                "eager": lambda k, ts=ts0: eager(sem, level, ts, cfg, k)}
        # the warm calls, counted and held bit for bit
        torch.cuda.synchronize()
        kernels.reset_launches()
        capture.reset_counts()
        got = ways["captured"](n)
        torch.cuda.synchronize()
        counted = {k: v for k, v in kernels.LAUNCHES.items() if v}
        record = capture.LAST[run.__name__]
        _require(capture.COUNTS == {"captures": 1, "warmup_steps": capture.WARMUP_STEPS, "replays": n},
                 f"phase 29 {name}: {capture.COUNTS}")
        kernels.reset_launches()
        want = ways["eager"](n)
        torch.cuda.synchronize()
        plain = {k: v for k, v in kernels.LAUNCHES.items() if v}
        _require(plain == {k: v * n for k, v in record.launches.items()}
                 and counted == {k: v * (n + capture.WARMUP_STEPS) for k, v in record.launches.items()},
                 f"phase 29 {name}: launches captured {counted}, eager {plain}, a replay {record.launches}")
        _same_whole_state(f"phase 29 {name} captured vs eager", got, want)
        finite = all(bool(torch.isfinite(p).all()) for p in got.params.values()) and bool(torch.isfinite(got.last_loss))
        _require(finite, f"phase 29 {name}: a non-finite parameter or loss")
        # N + N = 2N captured
        whole = ways["captured"](2 * chunk)
        _same_whole_state(f"phase 29 {name} captured {chunk}+{chunk} vs {2 * chunk}",
                          run(sem, level, ways["captured"](chunk), cfg, chunk), whole)
        # times: three host-clock calls each way, the capture's ms and pool of each captured one
        figures = {"launches a replay": record.launches}
        for way, fn in ways.items():
            walls, caps, pools, reps = [], [], [], []
            for _ in range(CAPTURED_TIMED):
                walls.append(_wall_ms(lambda fn=fn: fn(n)))
                if way == "captured":
                    rec = capture.LAST[run.__name__]
                    caps.append(rec.capture_ms)
                    pools.append(rec.pool_bytes)
                    reps.append(rec.replays_ms() / n)
            med = sorted(walls)[len(walls) // 2]
            # a step in the steady state: the median of the calls' replays on the card (CUDA events
            # around them); eagerly, the median call over its steps
            step_ms = sorted(reps)[len(reps) // 2] if way == "captured" else med / n
            full = _call_trace(lambda fn=fn: fn(n), OUR_KERNELS)
            _require(full[0] > 0, f"phase 29 {name} {way}: the profiler recorded no device time")
            idle = 1 - full[0] / (med * 1e3)
            # a step's events: a call of two steps less a call of one (the set-up cancels; short
            # traces, as the profiler drops events from long ones)
            one, two = (_call_trace(lambda fn=fn, k=k: fn(k), OUR_KERNELS) for k in (1, 2))
            per = [b - a for a, b in zip(one[1:], two[1:])]
            figures[way] = dict(ms=walls, median_ms=med, step_ms=step_ms, capture_ms=caps, pool_bytes=pools,
                                idle=idle, call_events=full[1], events_a_step=per[0], ours_a_step=per[1],
                                graph_launches_a_step=per[2])
            cap = f", capture {caps!r} ms, graph pool {pools!r} bytes" if caps else ""
            how = "the replays by CUDA events" if way == "captured" else "the median call over its steps"
            print(f"phase 29 {name} {way}: {walls!r} ms a call of {n} (median {med!r}), {step_ms!r} ms a step "
                  f"({how}){cap}; idle share {100 * idle:.2f} % ({full[1]} device events a call); a step: "
                  f"{per[0]} device events ({per[1]} of the port's kernels), {per[2]} graph launches ({smi})")
        cap_f, eag_f = figures["captured"], figures["eager"]
        _require(cap_f["ours_a_step"] == eag_f["ours_a_step"],
                 f"phase 29 {name}: the port's kernels a step {cap_f['ours_a_step']} captured, {eag_f['ours_a_step']} eager")
        _require(cap_f["graph_launches_a_step"] == 1 and eag_f["graph_launches_a_step"] == 0,
                 f"phase 29 {name}: graph launches a step {cap_f['graph_launches_a_step']} captured, "
                 f"{eag_f['graph_launches_a_step']} eager")
        print(f"phase 29 {name}: captured equals eager bit for bit in every state field, {chunk}+{chunk} equals "
              f"{2 * chunk} captured; one graph launch a step; launches a replay {record.launches}; "
              f"{eag_f['median_ms'] / cap_f['median_ms']!r}x the eager call's median ({smi}); "
              f"{time.perf_counter() - t_path:.1f} s")
        out[name] = figures
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this runs only on a GPU")
    sys.path.insert(0, str(ROOT))
    import griduniverse_tpu_torch as gt

    if Path(gt.__file__).resolve().parent.parent != ROOT:
        raise SystemExit(f"chip_smoke: imported the port from {gt.__file__}, not from {ROOT}")
    from griduniverse_tpu_torch import kernels
    from griduniverse_tpu_torch.core import semantics as S
    from griduniverse_tpu_torch.kernels import build
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.levels import maze as M
    from griduniverse_tpu_torch.ops import bitplane as bp

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def elapsed(what: str) -> None:
        print(f"elapsed {time.perf_counter() - t_start:.1f} s after {what}")

    # -- phase 1: the card ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"device 0: {torch.cuda.get_device_name(0)}, capability {torch.cuda.get_device_capability(0)}")

    # -- phase 2: build ------------------------------------------------------
    t0 = time.perf_counter()
    build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {build.library_path().relative_to(ROOT)}")
    for line in build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("  ptxas:", line.strip())

    sem = gt.make_semantics(device=dev)
    walls16 = builders.walls_and_goal_16x16(device=dev)
    bl_walls = bp.pack_level(walls16)
    gen = torch.Generator(device=dev).manual_seed(2026)
    errs = {"random_scan_bits": 0.0, "rollout_actions_bits": 0.0, "aldous_broder_mazes": 0.0}

    def per_env_mazes(seed: int, b: int, cells=(4, 4)):
        grids, start = M.generate_mazes_device(seed, cells, b, "aldous_broder", device=dev)
        return gt.Level(grid=grids, start_idx=start.expand(b).contiguous())

    # -- phase 3: each kernel against its plain version ----------------------
    mazes4k = bp.pack_level(per_env_mazes(11, 4096))
    for lname, bl in (("walls16", bl_walls), ("mazes4k", mazes4k)):
        actions = torch.randint(0, 4, (512, 4096), generator=gen, device=dev, dtype=torch.int32)
        for auto_reset, max_ep in ((False, None), (True, None), (True, 64)):
            st = bp.reset_bits(bl, None if bl.batched else 4096)
            got = bp.rollout_actions_bits(sem, bl, st, actions, auto_reset, max_ep)
            ref = bp.rollout_actions_bits_reference(sem, bl, st, actions, auto_reset, max_ep)
            tag = f"K2 {lname} auto_reset={auto_reset} max_ep={max_ep}"
            for f in _STATE_FIELDS:
                _same(f"{tag} {f}", getattr(got[0], f), getattr(ref[0], f))
            for k, (a, b) in enumerate(zip(got[1], ref[1])):
                errs["rollout_actions_bits"] = max(errs["rollout_actions_bits"], _same(f"{tag} out{k}", a, b))
            print(f"{tag}: bit-exact vs plain (B=4096, T=512)")

    for lname, bl in (("walls16", bl_walls), ("mazes4k", mazes4k)):
        st = bp.reset_bits(bl, None if bl.batched else 4096)
        rs = bp.xorshift_init(5, (4096,), device=dev)
        got = bp.random_scan_bits(sem, bl, st, rs, None, 2000, MAX_EPISODE_STEPS)
        ref = bp.random_scan_bits_reference(sem, bl, st, rs, 2000, MAX_EPISODE_STEPS)
        errs["random_scan_bits"] = max(errs["random_scan_bits"], _same_scan(f"K1 {lname}", got, ref))
        print(f"K1 {lname}: final state, n_eps, ret_sum, len_sum bit-exact vs plain "
              f"(B=4096, T=2000, max_episode_steps={MAX_EPISODE_STEPS}); episodes {int(got[1].sum())}")

    for cells, b, max_iters in (((4, 4), 512, None), ((5, 5), 512, 20)):
        mi = max_iters if max_iters is not None else M._ab_default_max_iters(cells[0] * cells[1])
        dirs = torch.randint(0, 4, (mi, b), generator=gen, device=dev, dtype=torch.int8)
        got = M._aldous_broder_mazes(cells, b, mi, directions=dirs)
        ref = M.aldous_broder_mazes_reference(cells, b, mi, directions=dirs)
        errs["aldous_broder_mazes"] = max(errs["aldous_broder_mazes"], _same(f"K3 injected {cells}", got, ref))
        perfect = all(M.check_perfect_maze(g, cells) for g in got.cpu().numpy())
        _require(perfect, f"K3 injected {cells}: a maze is not perfect")
        print(f"K3 injected cells={cells} B={b} max_iters={mi}: bit-exact vs plain, all perfect")
    got = M._aldous_broder_mazes((6, 6), 512, seed=99, device=dev)
    ref = M.aldous_broder_mazes_reference((6, 6), 512, seed=99, device=dev)
    errs["aldous_broder_mazes"] = max(errs["aldous_broder_mazes"], _same("K3 seeded (6,6)", got, ref))
    print("K3 seeded cells=(6, 6) B=512: bit-exact vs plain")

    # -- phase 4: the main path, counted -------------------------------------
    torch.cuda.synchronize()
    kernels.reset_launches()

    golden = ROOT / "tests" / "golden"
    cfg4 = np.load(golden / "torch" / "cfg4_mazes_grids.npz")
    golden_levels = {
        "cfg1_empty8": (builders.empty_level(8, 8, goal=True, device=dev), 2),
        "cfg2_walls16": (walls16, 3),
        "cfg3_lava": (builders.lava_level(device=dev), 3),
        "cfg4_mazes": (gt.make_level(cfg4["grids"], cfg4["start_idx"], device=dev), 4),
    }
    replays = []  # (name, level, start state, actions, kernel output) of each golden run
    for name, (level, b) in golden_levels.items():
        g = np.load(golden / f"{name}.npz")
        bl = bp.pack_level(level)
        st = bp.reset_bits(bl, None if bl.batched else b)
        actions = torch.as_tensor(g["actions"], device=dev)
        got = bp.rollout_actions_bits(sem, bl, st, actions, True, 64)
        obs, reward, done = got[1]
        _require(np.array_equal(obs.cpu().numpy(), g["obs"]), f"{name}: obs differ from golden")
        _require(np.array_equal(reward.cpu().numpy().view(np.int32), g["reward"].view(np.int32)),
                 f"{name}: reward differs from golden")
        _require(np.array_equal(done.cpu().numpy(), g["done"]), f"{name}: done differs from golden")
        replays.append((name, bl, st, actions, got))
        print(f"K2 golden {name}: bit-exact ({tuple(actions.shape)} actions)")

    rollouts = []  # (name, level, B, T, final state, stats) of each main-path rollout

    def run_rollout(name, bl, b, steps):
        fn = bp.compile_rollout_random(sem, bl, b, steps, max_episode_steps=MAX_EPISODE_STEPS)
        fn(1)  # warm-up
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, stats = fn(7)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        eps, ret, length = int(stats["episodes"]), float(stats["mean_return"]), float(stats["mean_length"])
        _require(eps > 0 and np.isfinite(ret) and 1.0 <= length <= MAX_EPISODE_STEPS,
                 f"{name}: implausible stats {stats}")
        _require(state.agent_idx.shape == (b,) and bool((state.t < MAX_EPISODE_STEPS).all()),
                 f"{name}: bad final state")
        rate = b * steps / (ms / 1e3)
        print(f"K1 main {name}: B={b} T={steps} episodes={eps} mean_return={ret!r} "
              f"mean_length={length!r} time={ms!r} ms steps/s={rate!r}")
        rollouts.append((name, bl, b, steps, state, stats))

    run_rollout("walls16", bl_walls, 65_536, 2_000)
    bl_lava = bp.pack_level(builders.lava_level(device=dev))
    run_rollout("lava", bl_lava, 16_384, 2_000)
    run_rollout("empty8", bp.pack_level(builders.empty_level(8, 8, goal=True, device=dev)), 1, 2_000)

    b64 = 65_536
    mazes = per_env_mazes(2026, b64)
    n_open = (mazes.grid != S.WALL).sum(dim=(1, 2))
    _require(bool((n_open == 2 * 16 - 1).all()), "K3 seeded: a maze has the wrong number of open tiles")
    _require(bool((mazes.grid[:, 7, 7] == S.GOAL).all()), "K3 seeded: goal missing")
    sample = mazes.grid[:1024].cpu().numpy()
    _require(all(M.check_perfect_maze(g, (4, 4)) for g in sample), "K3 seeded: a maze is not perfect")
    print(f"K3 seeded cells=(4, 4) B={b64}: every maze has {2 * 16 - 1} open tiles; 1024 checked perfect")

    b2 = 4096
    g2, _ = M.generate_mazes_device(8, (2, 2), b2, "aldous_broder", device=dev)
    walls = torch.stack([g2[:, 2, 1], g2[:, 2, 3], g2[:, 1, 2], g2[:, 3, 2]], dim=1)
    open_mask = (walls != S.WALL).cpu().numpy()
    _require(bool((open_mask.sum(axis=1) == 3).all()), "K3 2x2: not a spanning tree")
    counts = np.bincount(np.argmin(open_mask, axis=1), minlength=4)
    sigma = np.sqrt(b2 * 0.25 * 0.75)
    _require(bool(np.all(np.abs(counts - b2 / 4) < 5 * sigma)), f"K3 2x2: not uniform {counts}")
    print(f"K3 seeded 2x2 spanning-tree counts {counts.tolist()} (expect {b2 // 4} ± {5 * sigma:.0f})")

    # 32x32 cells from injected directions (the 65x65 grid), a walk capped
    # short of covering every maze (the safety net carves the rest)
    cells32, b32, iters32 = (32, 32), 256, 5_000
    dirs32 = torch.randint(0, 4, (iters32, b32), generator=gen, device=dev, dtype=torch.int8)
    g32 = M._aldous_broder_mazes(cells32, b32, iters32, directions=dirs32)
    _require(bool(((g32 != S.WALL).sum(dim=(1, 2)) == 2 * 1024 - 1).all()), "K3 32x32: a maze has the wrong number of open tiles")
    _require(all(M.check_perfect_maze(g, cells32) for g in g32[:16].cpu().numpy()), "K3 32x32: a maze is not perfect")
    print(f"K3 injected cells={cells32} B={b32} max_iters={iters32}: every maze has {2 * 1024 - 1} open tiles; 16 checked perfect")

    bl_mazes = bp.pack_level(mazes)
    run_rollout("mazes64k", bl_mazes, b64, 2_000)

    torch.cuda.synchronize()
    env_kernels = ("random_scan_bits", "rollout_actions_bits", "aldous_broder_mazes")
    launches = {name: kernels.LAUNCHES[name] for name in env_kernels}
    print(f"launches on the env main path: {launches}")
    _require(all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}")

    # -- phase 5: the main path's outputs against the plain versions ----------
    for name, bl, st, actions, got in replays:
        ref = bp.rollout_actions_bits_reference(sem, bl, st, actions, True, 64)
        for f in _STATE_FIELDS:
            _same(f"K2 main {name} {f}", getattr(got[0], f), getattr(ref[0], f))
        for k, (a, b) in enumerate(zip(got[1], ref[1])):
            errs["rollout_actions_bits"] = max(errs["rollout_actions_bits"], _same(f"K2 main {name} out{k}", a, b))
        print(f"K2 main {name}: final state and outputs bit-exact vs plain")

    for name, bl, b, steps, state, stats in rollouts:
        st = bp.reset_bits(bl, None if bl.batched else b)
        rs = bp.xorshift_init(7, (b,), device=dev)
        ref_state, n, r, length = bp.random_scan_bits_reference(sem, bl, st, rs, steps, MAX_EPISODE_STEPS)
        for f in _STATE_FIELDS:
            _same(f"K1 main {name} {f}", getattr(state, f), getattr(ref_state, f))
        denom = n.sum().clamp(min=1)
        _same(f"K1 main {name} episodes", stats["episodes"], n.sum())
        _same(f"K1 main {name} mean_return", stats["mean_return"], r.sum() / denom)
        _same(f"K1 main {name} mean_length", stats["mean_length"], length.sum() / denom)
        print(f"K1 main {name}: final state and stats bit-exact vs plain (B={b}, T={steps})")

    for cells, b, seed, grids in (((4, 4), b64, 2026, mazes.grid), ((2, 2), b2, 8, g2)):
        ref = M.aldous_broder_mazes_reference(cells, b, seed=seed, device=dev)
        errs["aldous_broder_mazes"] = max(errs["aldous_broder_mazes"], _same(f"K3 main {cells}", grids, ref))
        print(f"K3 main seeded cells={cells} B={b}: grids bit-exact vs plain")
    t0 = time.perf_counter()
    ref, walk32 = M.aldous_broder_mazes_reference(cells32, b32, iters32, directions=dirs32, count_steps=True)
    torch.cuda.synchronize()
    plain32_ms = (time.perf_counter() - t0) * 1e3
    errs["aldous_broder_mazes"] = max(errs["aldous_broder_mazes"], _same(f"K3 main injected {cells32}", g32, ref))
    covered = int((walk32 < iters32).sum())
    print(f"K3 main injected cells={cells32} B={b32}: grids bit-exact vs plain ({covered} of {b32} walks covered "
          f"their maze within {iters32} steps)")

    # -- phase 6: kernel and plain-version times, outputs compared ------------
    bound = _make_bound()
    times = {}
    for name, bl, b in (("walls16", bl_walls, b64), ("lava", bl_lava, 16_384), ("mazes64k", bl_mazes, b64)):
        st = bp.reset_bits(bl, None if bl.batched else b)
        rs = bp.xorshift_init(3, (b,), device=dev)
        ms, got = _cuda_ms(lambda: bp.random_scan_bits(sem, bl, st, rs, None, 1000, MAX_EPISODE_STEPS), 5)
        plain_ms, ref = _cuda_ms(lambda: bp.random_scan_bits_reference(sem, bl, st, rs, 1000, MAX_EPISODE_STEPS), 1)
        errs["random_scan_bits"] = max(errs["random_scan_bits"], _same_scan(f"K1 timed {name}", got, ref))
        print(f"K1 timed {name} B={b} T=1000: per-env state and accumulators bit-exact vs plain")
        if name == "walls16":
            # state in (4 words) and state + accumulators out (7 words) per env
            t1 = dict(ms=ms, plain_ms=plain_ms, shape=f"walls16 B={b} T=1000", library_ms=None,
                      **bound(b * 11 * 4, k1_function_ops(b, 1000, 4)))
            sass = bound(b * 11 * 4, INSTR_K1_STEP * b * 1000)
            print(f"K1 timed walls16 B={b} T=1000: {ms!r} ms, bound {t1['bound_ms']!r} ms by {t1['bound_by']} "
                  f"(the function's {k1_step_ops(4)} operations a step), {sass['bound_ms']!r} by the kernel's "
                  f"{INSTR_K1_STEP} SASS instructions a step; {t1['bound_ms'] / ms!r} of the bound reached ({smi})")
            times["random_scan_bits"] = t1
    st = bp.reset_bits(bl_walls, 4096)
    actions = torch.randint(0, 4, (512, 4096), generator=gen, device=dev, dtype=torch.int32)
    ms, got = _cuda_ms(lambda: bp.rollout_actions_bits(sem, bl_walls, st, actions, True, 64), 10)
    plain_ms, ref = _cuda_ms(lambda: bp.rollout_actions_bits_reference(sem, bl_walls, st, actions, True, 64), 2)
    for f in _STATE_FIELDS:
        _same(f"K2 timed {f}", getattr(got[0], f), getattr(ref[0], f))
    for k, (a, b) in enumerate(zip(got[1], ref[1])):
        errs["rollout_actions_bits"] = max(errs["rollout_actions_bits"], _same(f"K2 timed out{k}", a, b))
    # per env and step: the action read (4 bytes), obs, reward, done written (9 bytes)
    times["rollout_actions_bits"] = dict(
        ms=ms, plain_ms=plain_ms, shape="walls16 B=4096 T=512 auto-reset max_ep=64", library_ms=None,
        **bound(4096 * 512 * 13 + 4096 * 8 * 4, INSTR_K2_STEP * 4096 * 512))
    ms, got = _cuda_ms(lambda: M._aldous_broder_mazes((4, 4), b64, seed=5, device=dev), 5)
    plain_ms, (ref, walk_steps) = _cuda_ms(
        lambda: M.aldous_broder_mazes_reference((4, 4), b64, seed=5, device=dev, count_steps=True), 1)
    errs["aldous_broder_mazes"] = max(errs["aldous_broder_mazes"], _same("K3 timed (4, 4)", got, ref))
    # the grids written once; the walk steps these seeds needed to cover their mazes
    times["aldous_broder_mazes"] = [dict(
        ms=ms, plain_ms=plain_ms, shape=f"seeded cells=(4, 4) B={b64}", library_ms=None,
        **bound(b64 * 81 * 4, k3_function_ops(int(walk_steps.sum()), b64 * 15, injected=False)))]
    print(f"K3 timed: mean walk steps to cover {float(walk_steps.double().mean())!r}")
    ms, got = _cuda_ms(lambda: M._aldous_broder_mazes(cells32, b32, iters32, directions=dirs32), 5)
    _same("K3 timed injected (32, 32)", got, g32)
    t3 = dict(ms=ms, plain_ms=plain32_ms, shape=f"injected cells={cells32} B={b32} max_iters={iters32}", library_ms=None,
              # the directions each walk read and the grids written once; the steps the walks took
              **bound(int(walk32.sum()) + b32 * 65 * 65 * 4,
                      k3_function_ops(int(walk32.sum()), b32 * 1023, injected=True)))
    times["aldous_broder_mazes"].append(t3)
    # one warp an SM: the call is the longest walk's chain, then its warp's grids
    print(f"time aldous_broder_mazes at injected cells={cells32} B={b32} max_iters={iters32}: kernel {ms!r} ms, "
          f"plain {plain32_ms!r} ms, bound {t3['bound_ms']!r} ms by {t3['bound_by']}, library None ms; "
          f"{ms * 1e-3 * bound.clock_hz / int(walk32.max())!r} cycles a step of the longest walk "
          f"({int(walk32.max())} steps) at {bound.clock_hz / 1e6!r} MHz, the grids' writing included ({smi})")

    # -- phases 7-10: the tabular solvers (K4, K5, K6, K10) --------------------
    elapsed("phases 1-6")
    solver_launches, solver_errs, solver_times = solver_phases(gt, dev, gen, bound, smi)
    launches.update(solver_launches)
    errs.update(solver_errs)
    times.update(solver_times)

    # -- phases 11-14: the on-policy neural learners (K7a, K7b, K9a, K9b) --------
    elapsed("phases 7-10")
    learner_launches, learner_errs, learner_times = learner_phases(gt, dev, gen, bound, smi)
    launches.update(learner_launches)
    errs.update(learner_errs)
    times.update(learner_times)
    # -- phases 15-16: the backtracker (K11) and the gather probes (P1, P2) ---------
    elapsed("phases 11-14")
    maze_launches, maze_errs, maze_times, lv64 = maze_probe_phases(gt, dev, bound, smi)
    launches.update(maze_launches)
    errs.update(maze_errs)
    times.update(maze_times)

    # -- phases 17-20: the off-policy learner and its replay (K8a, K8b) -----------
    elapsed("phases 15-16")
    replay_launches, replay_errs, replay_times = replay_phases(gt, dev, gen, bound, smi, lv64)
    launches.update(replay_launches)
    errs.update(replay_errs)
    times.update(replay_times)
    # -- phase 21: mc.py (K10) and td_lambda.py (K12) on the card -------------------
    elapsed("phases 17-20")
    trace_launches, trace_errs, trace_times = mc_lambda_phases(gt, dev, bound, smi)
    launches.update(trace_launches)
    errs.update(trace_errs)
    times.update(trace_times)
    elapsed("phase 21")
    # -- phase 23: K9b and K12 above their old ceilings --------------------------
    for name, err in ceiling_phases(gt, dev, bound, smi).items():
        errs[name] = max(errs[name], err)
    elapsed("phase 23")
    # -- phase 24: mazes above 63x63 cells, nine actions, K2's shapes -------------
    for name, err in repair_phases(gt, dev, bound, smi, bl_walls).items():
        errs[name] = max(errs[name], err)
    elapsed("phase 24")
    # -- phase 25: the compat API (K2) and K1's threefry stream ---------------------
    compat_errs, compat_times = compat_phases(gt, dev, bound, smi, bl_walls)
    for name, err in compat_errs.items():
        errs[name] = max(errs[name], err)
    for name, ts in compat_times.items():
        times[name] = [times[name], *ts]
    elapsed("phase 25")
    # -- phase 26: the sharded runs (NCCL a world of one, Gloo two ranks a card) ----
    shard_launches, shard_errs, shard_times = sharded_phases(gt, dev, bound, smi)
    launches.update(shard_launches)
    errs.update(shard_errs)
    times.update(shard_times)
    elapsed("phase 26")
    # -- phase 27: the sharded TD(λ), MC and neural learners ----------------------------
    learner_launches, learner_errs, learner_times = sharded_learner_phases(gt, dev, bound, smi)
    launches.update(learner_launches)
    errs.update(learner_errs)
    times.update(learner_times)
    elapsed("phase 27")
    # -- phase 28: the generalization gate's path (K3, K7a, K7b, K9b) ---------------------
    gate_launches, gate_errs, gate_times = gate_phases(gt, dev, bound, smi)
    for name, n in gate_launches.items():
        launches[name] += n
    for name, err in gate_errs.items():
        errs[name] = max(errs[name], err)
    times["aldous_broder_mazes"].extend(gate_times)
    elapsed("phase 28")
    # -- phase 29: the captured trainers against the eager loop ------------------
    captured_phases(gt, dev, smi, lv64)
    elapsed("phase 29")
    # a kernel timed at several shapes or in several forms (K1, K2, K3, K11) has
    # a record for each; one of another path carries its own launches and error
    shaped = [(name, t) for name, ts in times.items() for t in (ts if isinstance(ts, list) else [ts])]
    for name, t in shaped:
        print(f"time {name} at {t['shape']}: kernel {t['ms']!r} ms, plain {t['plain_ms']!r} ms, "
              f"bound {t['bound_ms']!r} ms by {t['bound_by']}, library {t['library_ms']!r} ms, "
              f"max abs err vs plain {t.get('max_abs_err', errs[name])!r} ({smi})")

    csrc = "griduniverse_tpu_torch/csrc/"
    sources = {
        "random_scan_bits": (csrc + "rollout.cu", "griduniverse_tpu/ops/bitplane.py:334"),
        "rollout_actions_bits": (csrc + "rollout.cu", "griduniverse_tpu/ops/bitplane.py:278"),
        "aldous_broder_mazes": (csrc + "maze.cu", "griduniverse_tpu/levels/maze.py:331"),
        "dp_grid": (csrc + "dp_grid.cu", "griduniverse_tpu/algos/dp_batched.py:390"),
        "td_scan_fast": (csrc + "td_fast.cu", "griduniverse_tpu/algos/td_fast.py:243"),
        "td_batched": (csrc + "td_batched.cu", "griduniverse_tpu/algos/td_batched.py:78"),
        "segment_mean": (csrc + "segment_mean.cu", "griduniverse_tpu/algos/td.py:78"),
        "gae": (csrc + "gae.cu", "griduniverse_tpu/models/ppo.py:159"),
        "act_step": (csrc + "act_step.cu", "griduniverse_tpu/models/ppo.py:199"),
        "embed_rows": (csrc + "embed_rows.cu", "griduniverse_tpu/models/networks.py:54"),
        "agent_stamp": (csrc + "agent_stamp.cu", "griduniverse_tpu/models/networks.py:178"),
        "per_sample": (csrc + "replay.cu", "griduniverse_tpu/models/dqn.py:207"),
        "replay": (csrc + "replay.cu", "griduniverse_tpu/models/dqn.py:180"),
        "backtracker_mazes": (csrc + "backtracker.cu", "griduniverse_tpu/levels/maze.py:142"),
        "gather_1d": (csrc + "gather_probe.cu", "tools/pallas_probe.py:43"),
        "take_along_axis1": (csrc + "gather_probe.cu", "tools/pallas_probe.py:61"),
        "trace_pass": (csrc + "trace_pass.cu", "griduniverse_tpu/algos/td_lambda.py:41"),
        "dqn_act": (csrc + "dqn_act.cu", "griduniverse_tpu/models/dqn.py:347"),
        "mc_returns": (csrc + "mc_returns.cu", "griduniverse_tpu/algos/mc.py:59"),
        "td_step_sharded": (csrc + "td_fast.cu", "griduniverse_tpu/algos/td_fast.py:323"),
        "segment_sums": (csrc + "segment_mean.cu", "griduniverse_tpu/parallel/learner.py:179"),
        "trace_partials": (csrc + "trace_pass.cu", "griduniverse_tpu/parallel/learner.py:387"),
    }
    _require(set(sources) == set(kernels.LAUNCHES), "the record does not list every kernel")
    _require(set(sources) == {name for name, _ in shaped}, "a kernel has no time")
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
         "launches": t.get("launches", launches[name]), "max_abs_err": t.get("max_abs_err", errs[name]),
         "ms": t["ms"], "plain_ms": t["plain_ms"],
         "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
         "library_ms": t["library_ms"], "shape": t["shape"],
         **{k: t[k] for k in ("graph_ms", "host_us") if k in t}}
        for name, t in shaped
    ]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
