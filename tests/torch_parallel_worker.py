"""Worlds of ranks for the sharded-run tests of the PyTorch port.

Imported by `tests/test_torch_parallel.py` and `tests/test_torch_distributed.py`,
and run as `python -m tests.torch_parallel_worker MODE ...` by the latter's
drills. It imports torch and the port, never JAX: every rank is a fresh
process (`spawn`, or a subprocess) that joins a Gloo process group on the
CPU at `tcp://127.0.0.1:<port>` with a timeout of its own, so a hang fails
instead of waiting out the suite.

`run_world` starts `world` ranks laid out as `hosts` × `world / hosts`
(1: the 1-D mesh), each running every ported entry once at a small size
(`run_entries`) on the inputs the test saved, and returns each rank's
results. `make_inputs` builds the levels both the ranks and the test's
unsharded runs use.
"""

from __future__ import annotations

import multiprocessing
import os
import signal
import socket
import sys
import time
from pathlib import Path

import torch

import griduniverse_tpu_torch as T
from griduniverse_tpu_torch import algos, parallel
from griduniverse_tpu_torch.algos import dp_batched, td_fast
from griduniverse_tpu_torch.levels import builders
from griduniverse_tpu_torch.levels import maze as tm
from griduniverse_tpu_torch.ops import bitplane as bp
from griduniverse_tpu_torch.parallel import bitplane as pbit
from griduniverse_tpu_torch.parallel import distributed
from griduniverse_tpu_torch.parallel.mesh import shard_env_state

CPU = torch.device("cpu")
TIMEOUT_S = 120          # a collective that waits longer raises
WORLD_TIMEOUT_S = 240    # a world that takes longer is killed and fails its test

# the sizes every world runs at (B divisible by 4)
B_ROLL, T_ROLL, MAX_EP = 64, 200, 64
N_MAZES, T_MAZES = 16, 100
B_FAST, T_FAST = 64, 100
B_TD, T_TD, PSUM_EVERY = 16, 100, 4
N_TABLES = 8
T_BATCHED = 100
B_STATS, T_STATS = 16, 50
FAST_KW = dict(alpha=0.1, gamma=0.99, epsilon=0.1, max_episode_steps=64)
ONE_STEP_KW = dict(alpha=0.25, gamma=0.9, epsilon=0.3, max_episode_steps=40)
TD_KW = dict(alpha=0.2, gamma=0.95, epsilon=0.2)
BATCHED_KW = dict(alpha=0.2, gamma=0.95, epsilon=0.2, max_episode_steps=40)
# α and γ powers of two: α·δ and γ·v exact, so a fused multiply-add rounds as two ops
BATCHED_POW2_KW = dict(BATCHED_KW, alpha=0.25, gamma=0.5)
DP_KW = dict(gamma=0.8, theta=1e-4)  # a few hundred sweeps a PI solve: one collective each


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mazes(seed: int, n: int, cells=(4, 4)):
    """N Aldous–Broder mazes from the port's generator, as a batched level
    and the (grids, start) numpy arrays that build the reference's."""
    grids, start = tm.generate_mazes_device(seed, cells, n, "aldous_broder", device=CPU)
    return T.Level(grid=grids, start_idx=start.expand(n).contiguous())


def make_inputs():
    """The semantics and levels every world and unsharded run uses."""
    sem = T.make_semantics(device=CPU)
    walls = builders.walls_and_goal_16x16(device=CPU)
    lava = builders.lava_level(device=CPU)
    lv = mazes(3, N_MAZES)
    return dict(sem=sem, walls=walls, lava=lava, mazes=lv, bl_walls=bp.pack_level(walls),
                bl_mazes=bp.pack_level(lv), tables=dp_batched.build_model_tables(sem, mazes(5, N_TABLES)))


def _fields(state, names):
    return {f: getattr(state, f).clone() for f in names}


def run_entries(mesh, extra) -> dict:
    """Every ported entry once on `mesh`; `extra` holds the test's injected
    draws and tables. Tensors in the result are this rank's (rows, or the
    replicated value as this rank holds it)."""
    inp = make_inputs()
    sem, walls, lava, lv = inp["sem"], inp["walls"], inp["lava"], inp["mazes"]
    out = {"rank": mesh.rank, "size": mesh.size, "shape": mesh.shape, "axes": mesh.axis_names,
           "backend": mesh.backend}
    rollout_fields = ("agent_idx", "agent_code", "t", "done")
    for name, bl, kw in (("rollout", inp["bl_walls"], {}),
                         ("rollout_mazes", inp["bl_mazes"], {}),
                         ("rollout_threefry", inp["bl_walls"], {"rng": "threefry"})):
        b = B_ROLL if not bl.batched else N_MAZES
        steps = T_ROLL if not bl.batched else T_MAZES
        st, stats = parallel.compile_rollout_random_sharded(mesh, sem, bl, b, steps, MAX_EP, **kw)(11)
        out[name] = (_fields(st, rollout_fields), stats)

    fn = parallel.compile_q_learning_fast_sharded(mesh, sem, inp["bl_walls"], B_FAST, T_FAST, **FAST_KW)
    res = fn(13)
    ts = pbit.fast_td_init_sharded(mesh, sem, inp["bl_walls"], 13, B_FAST)
    ts = td_fast.td_scan_fast_sharded(
        sem, inp["bl_walls"], ts, T_FAST, FAST_KW["alpha"], FAST_KW["gamma"], FAST_KW["epsilon"],
        "q_learning", FAST_KW["max_episode_steps"], lambda x: parallel.mesh.all_reduce_sum(mesh, x),
    )
    out["fast"] = (res.q, res.episodes, res.mean_return)
    out["fast_state"] = {"q": ts.q, "agent_idx": ts.env_state.agent_idx, "t": ts.env_state.t,
                         "rs": ts.rs, "n_eps_env": ts.n_eps_env, "ret_sum_env": ts.ret_sum_env}
    for algo in ("q_learning", "expected_sarsa"):
        one = parallel.compile_q_learning_fast_sharded(
            mesh, sem, inp["bl_walls"], B_FAST, 1, algo=algo, **ONE_STEP_KW)(17, extra["q0"])
        out[f"fast_one_step_{algo}"] = (one.q, one.episodes)

    out["vi_grid"] = parallel.value_iteration_batched_grid_sharded(mesh, sem, lv, **DP_KW)
    out["pi_grid"] = parallel.policy_iteration_batched_grid_sharded(mesh, sem, lv, **DP_KW)
    out["vi_tables"] = parallel.value_iteration_batched_sharded(mesh, inp["tables"], **DP_KW)
    out["pi_tables"] = parallel.policy_iteration_batched_sharded(mesh, inp["tables"], **DP_KW)
    for name, level in (("walls", walls), ("lava", lava)):
        out[f"vi_state_{name}"] = parallel.value_iteration_sharded(
            mesh, T.build_model_table(sem, level), **DP_KW)
    out["pi_state_lava"] = parallel.policy_iteration_sharded(mesh, T.build_model_table(sem, lava), **DP_KW)

    for name, steps, kw in (("td_parity", T_TD, dict(parity=True)), ("td_scalable", T_TD, {}),
                            ("td_window", T_TD, dict(psum_every=PSUM_EVERY)),
                            ("td_scalable_1", 1, {}), ("td_window_1", PSUM_EVERY, dict(psum_every=PSUM_EVERY)),
                            ("td_parity_jax", T_TD, dict(parity=True, draws=extra["td_draws"]))):
        r = parallel.q_learning_sharded(mesh, sem, lava, 7, steps, B_TD, **TD_KW, **kw)
        out[name] = (r.q, r.episodes, r.mean_return)
    for name, kw in (("batched", BATCHED_KW),
                     ("batched_jax", dict(BATCHED_KW, parity=True, draws=extra["batched_draws"])),
                     ("batched_jax_pow2", dict(BATCHED_POW2_KW, parity=True, draws=extra["batched_draws"]))):
        r = parallel.q_learning_batched_sharded(mesh, sem, lv, 9, T_BATCHED, **kw)
        out[name] = (r.q, r.episodes, r.mean_return, r.state.env_state.agent_idx)

    st, stats = parallel.episode_stats_sharded(mesh, sem, walls, 0, B_STATS, T_STATS, True, 32,
                                               actions=extra["stats_actions"])
    out["stats"] = (st.agent_idx, stats)
    _, native = parallel.episode_stats_sharded(mesh, sem, walls, 0, B_STATS, T_STATS, True, 32)
    out["stats_native"] = native
    out["reset"] = parallel.reset_batch_sharded(mesh, walls, B_STATS).agent_idx
    out["shard_env_state"] = shard_env_state(mesh, bp.reset_bits(inp["bl_mazes"], None)).agent_code
    rows = distributed.make_global_array(
        mesh, (B_STATS, 3), lambda index: torch.arange(B_STATS * 3).reshape(B_STATS, 3)[index].numpy())
    out["global_array"] = (rows, distributed.fetch_global(mesh, {"x": rows, "n": torch.tensor(5)}),
                           distributed.local_shards(mesh, rows)[0][0][0])
    return out


def rank_main(rank: int, world: int, hosts: int, port: int, out_dir: str) -> None:
    """One rank of `run_world`: join the group, run every entry, save."""
    torch.set_num_threads(1)
    out = Path(out_dir)
    distributed.initialize("gloo", f"tcp://127.0.0.1:{port}", world, rank, device=CPU,
                           timeout_s=TIMEOUT_S)
    try:
        if hosts > 1:
            mesh = parallel.make_host_env_mesh(hosts, world // hosts, device=CPU)
        else:
            mesh = parallel.make_env_mesh(world, device=CPU)
        result = run_entries(mesh, torch.load(out / "inputs.pt", weights_only=False))
        torch.save(result, out / f"rank{rank}.pt")
    finally:
        distributed.shutdown()


def run_world(world: int, hosts: int, out_dir: Path, extra: dict) -> list[dict]:
    """Start `world` spawned ranks on `extra`, wait at most
    `WORLD_TIMEOUT_S`, and return each rank's results in rank order; raise
    if a rank failed or did not end in time (the rest are killed)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.save(extra, out_dir / "inputs.pt")
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=rank_main, args=(r, world, hosts, port, str(out_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        late = [p for p in procs if p.is_alive()]
        for p in late:
            p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    if late or any(c != 0 for c in codes):
        raise RuntimeError(f"world {world} ({hosts} hosts): exit codes {codes}, {len(late)} killed at the deadline")
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]


# -- the drills of tests/test_torch_distributed.py, one OS process each --------

DRILL_CHUNKS, DRILL_CHUNK_STEPS = 3, 40


def drill_levels():
    sem = T.make_semantics(device=CPU)
    level = builders.make_level_from_indices((4, 4), start_idx=0, goals=[15], device=CPU)
    return sem, level


def _drill_sharded(rank, world, port, out):
    """The learner in parity mode and the fast rollout over `world` ranks,
    saved by rank 0."""
    distributed.initialize("gloo", f"tcp://127.0.0.1:{port}", world, rank, device=CPU,
                           timeout_s=TIMEOUT_S)
    mesh = parallel.make_env_mesh(world, device=CPU)
    inp = make_inputs()
    r = parallel.q_learning_sharded(mesh, inp["sem"], inp["lava"], 7, T_TD, B_TD, **TD_KW, parity=True)
    st, stats = parallel.compile_rollout_random_sharded(mesh, inp["sem"], inp["bl_walls"], B_ROLL, T_ROLL,
                                                        MAX_EP)(11)
    rollout = distributed.fetch_global(mesh, _fields(st, ("agent_idx", "agent_code", "t")))
    if rank == 0:
        torch.save({"q": r.q, "episodes": r.episodes, "rollout": rollout, "stats": stats}, out)
    distributed.shutdown()


def _drill_peer_loss(rank, world, port, out):
    """Rank 1 dies by SIGKILL after one collective; rank 0's next collective
    must raise within its timeout. Rank 0 writes what it saw."""
    distributed.initialize("gloo", f"tcp://127.0.0.1:{port}", world, rank, device=CPU, timeout_s=20)
    mesh = parallel.make_env_mesh(world, device=CPU)
    x = torch.ones(4, dtype=torch.int64)
    parallel.mesh.all_reduce_sum(mesh, x)
    if rank == 1:
        os.kill(os.getpid(), signal.SIGKILL)
    time.sleep(1.0)
    t0 = time.monotonic()
    try:
        parallel.mesh.all_reduce_sum(mesh, torch.ones(4, dtype=torch.int64))
        Path(out).write_text("COMPLETED")
    except RuntimeError as err:  # the survivor's collective fails: what the drill checks
        Path(out).write_text(f"RAISED {time.monotonic() - t0:.3f} {type(err).__name__}: {err}"[:400])
    os._exit(0)


def _drill_resume(engine, ckpt_dir):
    """Chunked training with a checkpoint a chunk; SIGKILLs itself after
    chunk GU_CRASH_AFTER_CHUNK. `engine`: "td" (`td_run`) or "fast"."""
    from griduniverse_tpu_torch.utils.checkpoint import CheckpointManager

    crash_after = int(os.environ.get("GU_CRASH_AFTER_CHUNK", "-1"))
    template, run = drill_engine(engine)
    mgr = CheckpointManager(ckpt_dir, max_to_keep=2)
    start_chunk, ts = mgr.restore_latest(template)
    for chunk in range(start_chunk, DRILL_CHUNKS):
        ts = run(ts)
        mgr.save(chunk + 1, ts)
        if chunk + 1 == crash_after:
            os.kill(os.getpid(), signal.SIGKILL)  # a hard fault: no cleanup
    print("COMPLETED", int(ts.step))


def drill_engine(engine):
    """(initial train state, run of one chunk) of a resume drill."""
    sem, level = drill_levels()
    if engine == "td":
        template = algos.td.td_init(sem, level, 0, 8)
        return template, lambda ts: algos.td.td_run(sem, level, ts, DRILL_CHUNK_STEPS)
    bl = bp.pack_level(level)
    template = td_fast.fast_td_init(sem, bl, 0, 8)
    return template, td_fast.compile_fast_td_run(sem, bl, DRILL_CHUNK_STEPS, epsilon=0.2,
                                                 max_episode_steps=30)


if __name__ == "__main__":
    torch.set_num_threads(1)
    mode = sys.argv[1]
    if mode == "resume":
        _drill_resume(sys.argv[2], sys.argv[3])
    else:
        rank, world, port, out = int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
        {"sharded": _drill_sharded, "peer_loss": _drill_peer_loss}[mode](rank, world, port, out)
