#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`griduniverse_tpu_torch`) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
(the kernels are built for sm_90a) and the CUDA toolkit:

    python3 chip_smoke.py

It builds the seven hand-written kernels (K1, K2, K3, K4, K5, K6, K10) from
`griduniverse_tpu_torch/csrc/`, holds each against its plain PyTorch version,
drives the port's main paths at full size and checks what comes out:

  * the env path: level → pack → K1/K2 rollouts; K3 mazes → pack → K1;
  * the solver path: K3 mazes → K4 value/policy iteration; walls16 → K5
    shared-Q learning; mazes → K6 per-maze Q-learning; walls16 → `q_learning`
    on the generic step with K10.

The main paths' own outputs are held bit for bit against the plain versions
on the same inputs. Every phase raises on failure. The last two lines are a
JSON record of the kernels (launches on the main paths, error against the
plain version, kernel / plain / library times and the least time the card
could take) and `{"ok": true, "device": {...}}`.

It imports nothing of JAX: the reference's per-env golden mazes are read from
`tests/golden/torch/`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MAX_EPISODE_STEPS = 512


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


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
INSTR_K1_STEP = 85      # the scan loop is 170 instructions for two unrolled steps
INSTR_K2_STEP = 94      # the replay loop is 188 instructions for two unrolled steps
INSTR_K3_STEP = 54      # the seeded walk loop
INSTR_K3_TILE = 17      # one tile of the grid written out (69 for four)
INSTR_K4_CELL = 129     # one cell's backup of a VI sweep; the block's maximum is not counted
# K5's per-env path is 308; 76 of them load and store the env state, which
# only a scan cut into one launch a step needs, so they are not counted
INSTR_K5_STEP = 232
INSTR_K5_ENTRY = 10     # one Q entry's update a step (the mean and the add), an estimate
INSTR_K6_STEP = 324     # the float32 Q-learning path with native draws
INSTR_K10_ENV = 4       # key and α·δ of one env, an estimate
HBM_BYTES_PER_S = 3.35e12  # the H100's published device-memory rate


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

    return bound


def _same_fields(tag: str, got, ref, names) -> float:
    """Every named tensor of `got` equals `ref`'s bit for bit; max |a-b|."""
    err = 0.0
    for name, a, b in zip(names, got, ref):
        if a.dtype == torch.bfloat16:
            a, b = a.float(), b.float()
        if a.dtype == torch.int64 and a.dim() == 0:
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
    from griduniverse_tpu_torch.core.step import step_autoreset
    from griduniverse_tpu_torch.kernels.dp_grid import grid_sweeps_cuda
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.levels import maze as M
    from griduniverse_tpu_torch.ops import bitplane as bp

    errs = {"dp_grid": 0.0, "td_scan_fast": 0.0, "td_batched": 0.0, "segment_mean": 0.0}
    times = {}

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
        print(f"K4 cells={cells} N=256: VI {got[2]} sweeps (convergence at sweep {mid} of a launch of "
              f"{dp_batched.SWEEPS_PER_LAUNCH}), PI {pgot[2]} policy iterations: V, policy, iters bit-exact vs plain")
    _require(inside_a_launch, "no K4 shape converged inside a launch")

    kw5 = dict(alpha=0.1, gamma=0.99, epsilon=0.1, max_episode_steps=MAX_EPISODE_STEPS)
    for algo in td_fast.ALGOS:
        ts = td_fast.fast_td_init(sem, bl_walls, 3, 4096)
        got = td_fast.td_scan_fast(sem, bl_walls, ts, 500, algo=algo, **kw5)
        ref = td_fast.td_scan_fast_reference(sem, bl_walls, ts, 500, algo=algo, **kw5)
        hold("td_scan_fast", f"K5 {algo}", _fast_fields(got), _fast_fields(ref), _FAST_FIELDS)
        again = td_fast.td_scan_fast(sem, bl_walls, ts, 500, algo=algo, **kw5)
        chunked = td_fast.td_scan_fast(
            sem, bl_walls, td_fast.td_scan_fast(sem, bl_walls, ts, 200, algo=algo, **kw5), 300, algo=algo, **kw5)
        _same_fields(f"K5 {algo} second run", _fast_fields(again), _fast_fields(got), _FAST_FIELDS)
        _same_fields(f"K5 {algo} chunked", _fast_fields(chunked), _fast_fields(got), _FAST_FIELDS)
        print(f"K5 {algo} B=4096 T=500: bit-exact vs plain; a second run and a 200+300 chunked run give the same bits")

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

    def check_policies(tag, lv, policy, n_sample=1024):
        sample = gt.Level(grid=lv.grid[:n_sample], start_idx=lv.start_idx[:n_sample])
        _, ret, length, done = algos.run_greedy_episode(sem, sample, policy[:n_sample], max_steps=lv.num_states)
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
    for b in (32, 4096):
        ts0 = td.td_init(sem, walls16, 11, b)
        ms1, h1 = timed(lambda: td.td_run(sem, walls16, ts0, steps // 2))
        ms2, before_late = timed(lambda: td.td_run(sem, walls16, h1, steps // 2 - late))
        ms3, h2 = timed(lambda: td.td_run(sem, walls16, before_late, late))
        ms2 += ms3
        outs[f"td_{b}"] = (ts0, before_late, h2)
        res = algos.q_learning(sem, walls16, 11, num_steps=steps, batch_size=b)
        _same(f"td_run B={b} chunked q", h2.q, res.q)
        _require(int(h2.episodes) > 0 and bool(torch.isfinite(h2.q).all()), f"td_run B={b}: no episodes")
        mean1 = h1.ret_sum / h1.episodes.clamp(min=1)
        mean2 = (h2.ret_sum - h1.ret_sum) / (h2.episodes - h1.episodes).clamp(min=1)
        if b == 4096:
            _require(float(mean2) > float(mean1), f"td_run B={b}: return did not rise")
        print(f"td_run main walls16 B={b} T={steps}: episodes {int(h2.episodes)}, {ms1 + ms2!r} ms, "
              f"{b * steps / (ms1 + ms2) * 1e3!r} transitions/s; `q_learning` equals the three chunks; "
              f"mean return {float(mean1)!r} -> {float(mean2)!r} ({smi})")

    torch.cuda.synchronize()
    launches = {name: kernels.LAUNCHES[name] for name in errs}
    print(f"launches on the solver main path: {launches}")
    _require(all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}")

    # -- phase 9: the main path's outputs against the plain versions, timed ----
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

    # K10 at full width: the main path's `td_run` redone one step at a time,
    # every step's new Q held against the plain update rule on that step's own
    # (q, s, a, δ). The plain rule needs one pass per env of the fullest cell
    # (thousands while all envs share the start state). So at B=32 all 2,000
    # steps are held; at B=4096 the first 20, where every env collides, and
    # the main run's last 50, where the envs are spread over the level.
    def held_steps(tag, ts, n_steps):
        for _ in range(n_steps):
            s, a = ts.env_state.agent_idx, ts.action
            _, out = step_autoreset(sem, walls16, ts.env_state, a)
            delta = td.td_error_qlearning(ts.q, s, a, out.reward, out.obs, out.done, 0.99)
            ref_q = td.apply_td_updates_reference(ts.q, s, a, delta, 0.1)
            ts = td.td_run(sem, walls16, ts, 1)
            hold("segment_mean", tag, (ts.q,), (ref_q,), ("q",))
        return ts

    ts0, _, end = outs["td_32"]
    redone = held_steps("K10 main td_run B=32", ts0, steps)
    _same_fields("K10 main td_run B=32 redone", _td_fields(redone), _td_fields(end), _TD_FIELDS)
    print(f"K10 main: td_run B=32, each of the {steps} steps' Q bit-exact vs the plain update rule; "
          "the run redone step by step equals the main path's")
    ts0, before_late, end = outs["td_4096"]
    held_steps("K10 main td_run B=4096 first steps", ts0, 20)
    redone = held_steps("K10 main td_run B=4096 last steps", before_late, late)
    _same_fields("K10 main td_run B=4096 redone", _td_fields(redone), _td_fields(end), _TD_FIELDS)
    cells = int(torch.unique(end.env_state.agent_idx).numel())
    print(f"K10 main: td_run B=4096, the first 20 and the last {late} of {steps} steps bit-exact vs the "
          f"plain update rule (the envs end on {cells} distinct cells); the last steps redone equal the main path's")

    # -- phase 10: K4 and K10 times at the main path's shapes ------------------
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

    ms4, got = _cuda_ms(lambda: grid_sweeps_cuda(sem, grids, v0, None, 0.99, k), 10)
    plain4, ref = _cuda_ms(plain_sweeps, 2)
    hold("dp_grid", "K4 timed sweeps", got, ref, ("V", "sweep maxima"))
    times["dp_grid"] = dict(
        ms=ms4, plain_ms=plain4, shape=f"{k} VI sweeps, {n64} mazes 9x9", library_ms=None,
        # grids and V in, V out; per sweep one backup of every cell
        **bound(n64 * 81 * 4 * 3, k * n64 * 81 * INSTR_K4_CELL))
    for tag, lv, key in (("9x9", lv64, "vi64"), ("33x33", lv33, "vi33")):
        cap = 400 if tag == "33x33" else 10_000
        ms, _ = _cuda_ms(lambda: algos.value_iteration_batched_grid(sem, lv, max_iters=cap), 3)
        n = lv.grid.shape[0]
        print(f"K4 solve {tag} N={n}: {ms!r} ms a solve ({outs[key][2]} sweeps), {n / ms * 1e3!r} mazes/s ({smi})")

    b, n_seg = 4096, 256 * 4
    q = torch.randn((256, 4), generator=gen, device=dev)
    s = torch.randint(0, 256, (b,), generator=gen, device=dev, dtype=torch.int32)
    a = torch.randint(0, 4, (b,), generator=gen, device=dev, dtype=torch.int32)
    delta = torch.randn((b,), generator=gen, device=dev)

    def library():  # the same function by PyTorch's scatter: timed here, used nowhere in the port
        flat = s.long() * 4 + a.long()
        upd = torch.zeros(n_seg, device=dev).index_add_(0, flat, 0.1 * delta)
        cnt = torch.zeros(n_seg, device=dev).index_add_(0, flat, torch.ones_like(delta))
        return q + (upd / cnt.clamp(min=1.0)).reshape(256, 4)

    ms10, got = _cuda_ms(lambda: td.apply_td_updates(q, s, a, delta, 0.1), 50)
    plain10, ref = _cuda_ms(lambda: td.apply_td_updates_reference(q, s, a, delta, 0.1), 3)
    lib10, lib = _cuda_ms(library, 50)
    hold("segment_mean", "K10 timed", (got,), (ref,), ("q",))
    _require(bool(torch.allclose(got, lib, rtol=1e-5, atol=1e-6)), "K10: the library yardstick computes another function")
    times["segment_mean"] = dict(
        ms=ms10, plain_ms=plain10, shape=f"B={b}, S*A={n_seg}, uniform cells", library_ms=lib10,
        # s, a, delta in; Q in and out
        **bound(b * 12 + 2 * n_seg * 4, INSTR_K10_ENV * b + 2 * n_seg))
    return launches, errs, times


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
            times["random_scan_bits"] = dict(
                ms=ms, plain_ms=plain_ms, shape=f"walls16 B={b} T=1000", library_ms=None,
                **bound(b * 11 * 4, INSTR_K1_STEP * b * 1000))
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
    times["aldous_broder_mazes"] = dict(
        ms=ms, plain_ms=plain_ms, shape=f"seeded cells=(4, 4) B={b64}", library_ms=None,
        **bound(b64 * 81 * 4, INSTR_K3_STEP * int(walk_steps.sum()) + INSTR_K3_TILE * b64 * 81))
    print(f"K3 timed: mean walk steps to cover {float(walk_steps.double().mean())!r}")

    # -- phases 7-10: the tabular solvers (K4, K5, K6, K10) --------------------
    solver_launches, solver_errs, solver_times = solver_phases(gt, dev, gen, bound, smi)
    launches.update(solver_launches)
    errs.update(solver_errs)
    times.update(solver_times)
    for name, t in times.items():
        print(f"time {name} at {t['shape']}: kernel {t['ms']!r} ms, plain {t['plain_ms']!r} ms, "
              f"bound {t['bound_ms']!r} ms by {t['bound_by']}, library {t['library_ms']!r} ms, "
              f"outputs bit-exact ({smi})")

    csrc = "griduniverse_tpu_torch/csrc/"
    sources = {
        "random_scan_bits": (csrc + "rollout.cu", "griduniverse_tpu/ops/bitplane.py:334"),
        "rollout_actions_bits": (csrc + "rollout.cu", "griduniverse_tpu/ops/bitplane.py:278"),
        "aldous_broder_mazes": (csrc + "maze.cu", "griduniverse_tpu/levels/maze.py:331"),
        "dp_grid": (csrc + "dp_grid.cu", "griduniverse_tpu/algos/dp_batched.py:392"),
        "td_scan_fast": (csrc + "td_fast.cu", "griduniverse_tpu/algos/td_fast.py:243"),
        "td_batched": (csrc + "td_batched.cu", "griduniverse_tpu/algos/td_batched.py:78"),
        "segment_mean": (csrc + "segment_mean.cu", "griduniverse_tpu/algos/td.py:78"),
    }
    _require(set(sources) == set(kernels.LAUNCHES), "the record does not list every kernel")
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"], "bound_by": times[name]["bound_by"],
         "library_ms": times[name]["library_ms"]}
        for name, (src, replaces) in sources.items()
    ]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
